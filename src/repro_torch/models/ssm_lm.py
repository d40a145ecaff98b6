"""Mamba2 LM (pure SSM) and Zamba2-style hybrid (SSM + shared attention)
(a port of the JAX package's ``models/ssm_lm.py``).

``Mamba2LM`` holds ``embed``, ``layers.<name>`` stacked along a leading
``num_layers`` axis (``layers.A_log`` (L, H), ...), ``final_norm`` and
``lm_head``; with ``attn_every > 0`` (the hybrid) also ``shared_attn.<name>``,
ONE attention+MLP block (a single parameter copy, as in Zamba2) applied
after every ``attn_every``-th mamba layer, each invocation site with its own
KV cache.  Its prefill attends within ``attn_window`` keys (the flash
kernel's sliding window) and its decode keeps a ring-buffer cache of
``min(attn_window or max_len, max_len)`` slots, so decode state is
O(window).  ``forward`` (prefill) takes no gradient; ``train_forward`` is
the same loop with gradients (the scan through ``mamba2.SSDTrain``, the
attention through ``layers.FlashTrain``) and ``cfg.remat``'s per-layer
checkpoint of the mamba layers, as the reference's ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .._device import DEFAULT_DEVICE, resolve
from ..configs.base import ModelConfig
from ..sharding import P
from . import layers as L
from . import mamba2 as M
from .params import StackedParams, dtype_of, parameter
from .transformer import padded_vocab


def _n_attn_sites(cfg: ModelConfig) -> int:
    if cfg.attn_every <= 0:
        return 0
    return cfg.num_layers // cfg.attn_every


def _shared_attn_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    return {
        "attn_norm": (d,), "wq": (d, h, hd), "wk": (d, kv, hd),
        "wv": (d, kv, hd), "wo": (h, hd, d), "mlp_norm": (d,),
        "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d),
    }


class Mamba2LM(torch.nn.Module):
    """Pure-SSM or hybrid LM; parameters uninitialised until
    ``init_params`` or ``convert.params_to_port`` fills them.
    ``trainable``: every parameter requires a gradient (the training
    path); else none does (serving)."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE,
                 trainable: bool = False):
        super().__init__()
        device = resolve(device)
        self.cfg = cfg
        dt = dtype_of(cfg.param_dtype)
        v = padded_vocab(cfg)
        self.embed = parameter((v, cfg.d_model), dt, device, trainable)
        self.layers = StackedParams(M.layer_shapes(cfg, cfg.num_layers), dt,
                                    device, trainable)
        self.final_norm = parameter((cfg.d_model,), dt, device, trainable)
        self.lm_head = parameter((cfg.d_model, v), dt, device, trainable)
        if _n_attn_sites(cfg):
            self.shared_attn = torch.nn.ParameterDict({
                name: parameter(shape, dt, device, trainable)
                for name, shape in _shared_attn_shapes(cfg).items()})

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, positions)


def partition_specs(cfg: ModelConfig, fsdp: str = "data",
                    tp: str = "model") -> Dict[str, Any]:
    """The reference's ``P`` tree, congruent with ``param_shapes``."""
    tree: Dict[str, Any] = {
        "embed": P(tp, fsdp),
        "layers": M.layer_specs(cfg, fsdp, tp),
        "final_norm": P(None),
        "lm_head": P(fsdp, tp),
    }
    if _n_attn_sites(cfg):
        head = tp if cfg.num_heads % 16 == 0 else None
        kvh = tp if cfg.num_kv_heads % 16 == 0 else None
        tree["shared_attn"] = {
            "attn_norm": P(None), "wq": P(fsdp, head, None),
            "wk": P(fsdp, kvh, None), "wv": P(fsdp, kvh, None),
            "wo": P(head, None, fsdp), "mlp_norm": P(None),
            "w_gate": P(fsdp, tp), "w_up": P(fsdp, tp), "w_down": P(tp, fsdp),
        }
    return tree


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                trainable: bool = False) -> Mamba2LM:
    """Parameters with the reference's laws, drawn from ``generator`` on its
    device: the shared block's norms 1 and its weights truncated-normal
    with fan-in their first axis, in sorted order of their names."""
    model = Mamba2LM(cfg, generator.device, trainable)
    model.embed.copy_(L.embed_init(generator, model.embed.shape,
                                   model.embed.dtype))
    M.init_layer_params(dict(model.layers.named_parameters()), generator)
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(L.dense_init(generator, model.lm_head.shape,
                                     cfg.d_model, model.lm_head.dtype))
    if _n_attn_sites(cfg):
        for name, p in sorted(model.shared_attn.items()):
            if "norm" in name:
                p.fill_(1.0)
            else:
                p.copy_(L.dense_init(generator, p.shape, p.shape[0], p.dtype))
    return model


# --------------------------------------------------------------------------
# Shared attention block (single param copy)
# --------------------------------------------------------------------------

def _shared_attn(cfg: ModelConfig, sp: Dict[str, torch.Tensor],
                 x: torch.Tensor, positions: torch.Tensor,
                 cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 cache_pos: Optional[int] = None) -> torch.Tensor:
    """x + attention + MLP of the shared block.  Without ``cache_kv``: the
    full sequence, causal within ``cfg.attn_window`` keys.  With it (one
    token at ``cache_pos``): k and v go to ring slot ``cache_pos % wlen``
    of the caller's cache tensors, in place, and the token attends over
    the ``min(cache_pos + 1, wlen)`` filled slots (``causal=False``: the
    ring holds exactly the window)."""
    dtype = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    h = L.rms_norm(x, sp["attn_norm"], cfg.norm_eps)

    def proj(w):
        return (h @ w.reshape(d, -1).to(dtype)).view(b, s, w.shape[1],
                                                     w.shape[2])

    q, k, v = proj(sp["wq"]), proj(sp["wk"]), proj(sp["wv"])
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cache_kv is not None:
        kc, vc = cache_kv
        wlen = kc.shape[1]
        slot = cache_pos % wlen
        kc[:, slot:slot + s] = k.to(kc.dtype)
        vc[:, slot:slot + s] = v.to(vc.dtype)
        out = L.attention(q, kc, vc, causal=False,
                          kv_len=min(cache_pos + 1, wlen),
                          block_kv=cfg.flash_block_kv)
    else:
        out = L.attention(q, k, v, causal=True, q_offset=0,
                          block_kv=cfg.flash_block_kv,
                          window=cfg.attn_window)
    hh, hd = sp["wo"].shape[0], sp["wo"].shape[1]
    x = x + out.reshape(b, s, hh * hd) @ sp["wo"].reshape(hh * hd, d).to(dtype)
    hm = L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return x + L.swiglu(hm, sp["w_gate"], sp["w_up"], sp["w_down"])


# --------------------------------------------------------------------------
# Forward (train / prefill)
# --------------------------------------------------------------------------

def _mamba_layer(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    return x + M.mamba2_block(cfg, lp, x)


def _logits(cfg: ModelConfig, params: Mamba2LM,
            x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return h @ params.lm_head.to(dtype_of(cfg.compute_dtype))


def _forward(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
             positions: Optional[torch.Tensor], remat: str) -> torch.Tensor:
    """The reference's period loop: ``attn_every`` mamba layers, then the
    shared block, per site; then the trailing mamba layers.  Under
    ``remat`` "full" or "dots" each mamba layer is checkpointed (the
    shared block is not, as in the reference)."""
    x = params.embed[tokens].to(dtype_of(cfg.compute_dtype))
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    lps = params.layers.unbind()

    def mamba(i, x):
        return L.remat_call(remat, _mamba_layer, cfg, lps[i], x)

    ae = cfg.attn_every if cfg.attn_every > 0 else cfg.num_layers
    done = 0
    for _ in range(_n_attn_sites(cfg)):
        for i in range(done, done + ae):
            x = mamba(i, x)
        x = _shared_attn(cfg, dict(params.shared_attn.items()), x, positions)
        done += ae
    for i in range(done, cfg.num_layers):
        x = mamba(i, x)
    return _logits(cfg, params, x)


@torch.no_grad()
def forward(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V_pad).  Prefill path: one
    ``ssd_scan`` launch per mamba layer and, for the hybrid, one windowed
    flash-attention launch per site on the card.  ``positions`` feeds the
    shared block's rope (a pure SSM has no position embedding)."""
    return _forward(cfg, params, tokens, positions, remat="none")


def train_forward(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``forward`` with gradients: the reference's train path.

    ``cfg.remat`` (``layers.remat_call``, per mamba layer): ``"full"``
    recomputes each mamba layer in the backward; ``"dots"`` saves its
    projections' outputs and recomputes the rest; under either a layer's
    scan kernel launches twice a step.  ``"none"`` keeps every
    activation.
    """
    return _forward(cfg, params, tokens, positions, cfg.remat)


def loss_fn(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of ``train_forward``'s logits."""
    return L.cross_entropy_loss(train_forward(cfg, params, tokens), labels)


# --------------------------------------------------------------------------
# Decode state
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Zero decode state: ``ssm`` (the stacked block states: h in fp32, the
    conv tails in the compute dtype) and, for the hybrid, ``attn_k`` /
    ``attn_v`` of shape (sites, B, wlen, KV, hd) in ``dtype``, wlen =
    min(attn_window or max_len, max_len).  The pure SSM's state is O(1) in
    length: it reads neither ``max_len`` nor ``dtype``."""
    state: Dict[str, Any] = {
        "ssm": M.init_block_state(cfg, cfg.num_layers, batch, device)}
    n_sites = _n_attn_sites(cfg)
    if n_sites:
        wlen = min(cfg.attn_window if cfg.attn_window > 0 else max_len,
                   max_len)
        shape = (n_sites, batch, wlen, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt, dev = dtype_of(dtype), resolve(device)
        state["attn_k"] = torch.zeros(shape, dtype=dt, device=dev)
        state["attn_v"] = torch.zeros(shape, dtype=dt, device=dev)
    return state


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: str = "bfloat16") -> Dict[str, Any]:
    """``init_cache``'s tree as ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def cache_specs(cfg: ModelConfig, fsdp: str = "data",
                tp: str = "model") -> Dict[str, Any]:
    """The reference's ``P`` tree of ``init_cache``: the SSM state's
    (``mamba2.block_state_specs``) and each attention site's ring, whose
    KV heads shard over ``tp`` when their count divides 16; neither names
    a batch axis."""
    state: Dict[str, Any] = {"ssm": M.block_state_specs(cfg, fsdp, tp)}
    if _n_attn_sites(cfg):
        kvh = tp if cfg.num_kv_heads % 16 == 0 else None
        spec = P(None, None, None, kvh, None)
        state["attn_k"] = spec
        state["attn_v"] = spec
    return state


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Mamba2LM, cache: Dict[str, Any],
                tokens: torch.Tensor, pos: int):
    """One token for the whole stack.  tokens (B, 1).  Returns
    (logits (B, 1, V), cache), the cache's tensors updated in place."""
    pos = int(pos)
    x = params.embed[tokens].to(dtype_of(cfg.compute_dtype))
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    st = cache["ssm"]

    def mamba(i, x):
        out, new = M.mamba2_block_decode(
            cfg, params.layers.layer(i), x,
            {name: t[i] for name, t in st.items()})
        for name, t in new.items():
            st[name][i] = t
        return x + out

    ae = cfg.attn_every if cfg.attn_every > 0 else cfg.num_layers
    done = 0
    for site in range(_n_attn_sites(cfg)):
        for i in range(done, done + ae):
            x = mamba(i, x)
        x = _shared_attn(cfg, dict(params.shared_attn.items()), x, positions,
                         cache_kv=(cache["attn_k"][site],
                                   cache["attn_v"][site]),
                         cache_pos=pos)
        done += ae
    for i in range(done, cfg.num_layers):
        x = mamba(i, x)
    return _logits(cfg, params, x), cache
