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

On a ``launch.mesh`` mesh (``mesh=``) a module holds this rank's block
of every leaf, by ``partition_specs`` (GSPMD's placement of the
reference's), and its forward inserts the collectives GSPMD would: each
mamba layer gathers its ``data``-sharded leaves inside the function that
``layers.remat_call`` wraps and runs on the rank's inner channels and
heads (``mamba2``); the embedding, the logits and their cross-entropy
are the transformer's vocab-parallel ones; the shared block is a
transformer layer on the rank's heads and FFN columns
(``transformer._layer``, its window the flash kernel's), one set of
parameters whose FSDP gathers' gradients add up over the sites; its ring
cache holds the rank's KV heads where their count divides 16.  The
decode state (``cache_specs``) names no batch axis: every rank runs the
whole batch of a decode step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .._device import DEFAULT_DEVICE, resolve
from ..configs.base import ModelConfig
from ..sharding import P, local_block, shard_shape
from . import layers as L
from . import mamba2 as M
from . import transformer as T
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


def _global_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's global shape by dotted name (``layers.wz``, ...)."""
    v, d = padded_vocab(cfg), cfg.d_model
    shapes = {"embed": (v, d), "final_norm": (d,), "lm_head": (d, v)}
    shapes.update({f"layers.{n}": s for n, s in
                   M.layer_shapes(cfg, cfg.num_layers).items()})
    if _n_attn_sites(cfg):
        shapes.update({f"shared_attn.{n}": s for n, s in
                       _shared_attn_shapes(cfg).items()})
    return shapes


def _flat_specs(cfg: ModelConfig) -> Dict[str, P]:
    tree = partition_specs(cfg)
    out = {f"{k}.{n}": s for k in ("layers", "shared_attn") if k in tree
           for n, s in tree.pop(k).items()}
    out.update(tree)
    return out


class Mamba2LM(torch.nn.Module):
    """Pure-SSM or hybrid LM; parameters uninitialised until
    ``init_params`` or ``convert.params_to_port`` fills them.
    ``trainable``: every parameter requires a gradient (the training
    path); else none does (serving).  ``mesh``: each parameter is this
    rank's block of its leaf (``partition_specs``), on the mesh's
    device; ``layout`` (the transformer's: the vocab and the shared
    block) and ``block_layout`` (the mamba layers') say how the
    computation splits."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE,
                 trainable: bool = False, mesh=None):
        super().__init__()
        device = resolve(device)
        if mesh is not None and device.type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.cfg = cfg
        self.mesh = mesh
        tree = partition_specs(cfg)
        self.layout = T.layout(cfg, mesh, tree.get("shared_attn", {}))
        self.block_layout = M.layout(cfg, mesh)
        specs = _flat_specs(cfg) if mesh is not None else {}
        shapes = _global_shapes(cfg)
        dt = dtype_of(cfg.param_dtype)

        def leaf(name):
            return parameter(shapes[name], dt, device, trainable,
                             specs.get(name), mesh)

        self.embed = leaf("embed")
        self.layers = StackedParams(
            M.layer_shapes(cfg, cfg.num_layers), dt, device, trainable,
            tree["layers"] if specs else None, mesh)
        self.final_norm = leaf("final_norm")
        self.lm_head = leaf("lm_head")
        if _n_attn_sites(cfg):
            self.shared_attn = torch.nn.ParameterDict({
                name: leaf(f"shared_attn.{name}")
                for name in _shared_attn_shapes(cfg)})

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
                trainable: bool = False, mesh=None) -> Mamba2LM:
    """Parameters with the reference's laws, drawn from ``generator`` on its
    device: the shared block's norms 1 and its weights truncated-normal
    with fan-in their first axis, in sorted order of their names.  On a
    mesh each leaf is drawn whole, as on one device, and the rank keeps
    its block: the same global values on any mesh."""
    model = Mamba2LM(cfg, generator.device, trainable, mesh)
    specs, shapes = _flat_specs(cfg), _global_shapes(cfg)
    params = dict(model.named_parameters())
    dt = model.embed.dtype

    def keep(name: str, value: torch.Tensor) -> None:
        params[name].copy_(value[local_block(mesh, specs[name],
                                             value.shape)])

    keep("embed", L.embed_init(generator, shapes["embed"], dt))
    for name, value in M.init_layer_params(
            M.layer_shapes(cfg, cfg.num_layers), generator, dt).items():
        keep(f"layers.{name}", value)
    model.final_norm.fill_(1.0)
    keep("lm_head", L.dense_init(generator, shapes["lm_head"], cfg.d_model,
                                 dt))
    if _n_attn_sites(cfg):
        for name in sorted(model.shared_attn):
            shape = shapes[f"shared_attn.{name}"]
            if "norm" in name:
                model.shared_attn[name].fill_(1.0)
            else:
                keep(f"shared_attn.{name}",
                     L.dense_init(generator, shape, shape[0], dt))
    return model


# --------------------------------------------------------------------------
# Shared attention block (single param copy)
# --------------------------------------------------------------------------

def _shared_attn(cfg: ModelConfig, lay: Optional[T.Layout],
                 sp: Dict[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor,
                 cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 cache_pos: Optional[int] = None) -> torch.Tensor:
    """x + attention + MLP of the shared block.  Without ``cache_kv``: the
    full sequence, causal within ``cfg.attn_window`` keys (a transformer
    layer, ``transformer._layer``).  With it (one token at
    ``cache_pos``): k and v go to ring slot ``cache_pos % wlen`` of the
    caller's cache tensors, in place, and the token attends over the
    ``min(cache_pos + 1, wlen)`` filled slots (``causal=False``: the
    ring holds exactly the window).  On a ``lay``: the rank's heads and
    FFN columns, the ring's KV heads the rank's where they are over
    ``model`` (else every KV head, of which it reads those of its query
    heads)."""
    if cache_kv is None:
        return T._layer(cfg, lay, sp, x, positions)
    sp = T._placed(lay, sp)
    q, k, v = T._qkv(cfg, sp, x, positions, lay, all_kv=True)
    kc, vc = cache_kv
    wlen = kc.shape[1]
    slot = cache_pos % wlen
    s = x.shape[1]
    kc[:, slot:slot + s] = k.to(kc.dtype)
    vc[:, slot:slot + s] = v.to(vc.dtype)
    if lay is not None and lay.heads and not lay.kv_heads:
        kc, vc = kc[:, :, lay.kv_read], vc[:, :, lay.kv_read]
    out = L.attention(q, kc, vc, causal=False,
                      kv_len=min(cache_pos + 1, wlen),
                      block_kv=cfg.flash_block_kv)
    x = x + T._attn_out(cfg, sp, out, lay)
    return x + T._ffn_block(cfg, sp, x, lay)


# --------------------------------------------------------------------------
# Forward (train / prefill)
# --------------------------------------------------------------------------

def _mamba_layer(cfg: ModelConfig, lay: Optional[M.Layout],
                 lp: Dict[str, torch.Tensor], x: torch.Tensor
                 ) -> torch.Tensor:
    return x + M.mamba2_block(cfg, T._placed(lay, lp), x, lay)


def _forward(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
             positions: Optional[torch.Tensor], remat: str) -> torch.Tensor:
    """The reference's period loop: ``attn_every`` mamba layers, then the
    shared block, per site; then the trailing mamba layers.  Under
    ``remat`` "full" or "dots" each mamba layer is checkpointed (the
    shared block is not, as in the reference)."""
    x = T._embed(cfg, params, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    lps = params.layers.unbind()

    def mamba(i, x):
        return L.remat_call(remat, _mamba_layer, cfg, params.block_layout,
                            lps[i], x)

    ae = cfg.attn_every if cfg.attn_every > 0 else cfg.num_layers
    done = 0
    for _ in range(_n_attn_sites(cfg)):
        for i in range(done, done + ae):
            x = mamba(i, x)
        x = _shared_attn(cfg, params.layout, dict(params.shared_attn.items()),
                         x, positions)
        done += ae
    for i in range(done, cfg.num_layers):
        x = mamba(i, x)
    return T._unembed(cfg, params, x)


@torch.no_grad()
def forward(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            split=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V_pad) (on a mesh the rank's
    vocab columns).  Prefill path: one ``ssd_scan`` launch per mamba
    layer and, for the hybrid, one windowed flash-attention launch per
    site on the card.  ``positions`` feeds the shared block's rope (a
    pure SSM has no position embedding).  ``split`` (the family API's
    argument, ``transformer.forward``) changes nothing: no layer of these
    families groups tokens."""
    return _forward(cfg, params, tokens, positions, remat="none")


def train_forward(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  split=None) -> torch.Tensor:
    """``forward`` with gradients: the reference's train path.

    ``cfg.remat`` (``layers.remat_call``, per mamba layer): ``"full"``
    recomputes each mamba layer in the backward; ``"dots"`` saves its
    projections' outputs and recomputes the rest; under either a layer's
    scan kernel launches twice a step.  ``"none"`` keeps every
    activation.  ``split`` as ``forward``'s.
    """
    return _forward(cfg, params, tokens, positions, cfg.remat)


def loss_fn(cfg: ModelConfig, params: Mamba2LM, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of ``train_forward``'s logits (on a mesh
    over the rank's vocab columns, ``transformer.token_nll``)."""
    return T.token_nll(cfg, params, train_forward(cfg, params, tokens),
                       labels).mean()


# --------------------------------------------------------------------------
# Decode state
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=DEFAULT_DEVICE,
               mesh=None) -> Dict[str, Any]:
    """Zero decode state: ``ssm`` (the stacked block states: h in fp32, the
    conv tails in the compute dtype) and, for the hybrid, ``attn_k`` /
    ``attn_v`` of shape (sites, B, wlen, KV, hd) in ``dtype``, wlen =
    min(attn_window or max_len, max_len); on a mesh this rank's block of
    each (``cache_specs``).  The pure SSM's state is O(1) in length: it
    reads neither ``max_len`` nor ``dtype``."""
    state: Dict[str, Any] = {
        "ssm": M.init_block_state(cfg, cfg.num_layers, batch, device, mesh)}
    n_sites = _n_attn_sites(cfg)
    if n_sites:
        wlen = min(cfg.attn_window if cfg.attn_window > 0 else max_len,
                   max_len)
        shape = (n_sites, batch, wlen, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        if mesh is not None:
            shape = shard_shape(mesh, cache_specs(cfg)["attn_k"], shape)
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
                tokens: torch.Tensor, pos: int, split=None):
    """One token for the whole stack.  tokens (B, 1).  Returns
    (logits (B, 1, V), cache), the cache's tensors updated in place.  On
    a mesh: the whole batch (the state names no batch axis), the rank's
    block of the cache, its vocab columns; ``split`` as ``forward``'s."""
    pos = int(pos)
    x = T._embed(cfg, params, tokens)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    st = cache["ssm"]
    lay = params.block_layout

    def mamba(i, x):
        out, new = M.mamba2_block_decode(
            cfg, T._placed(lay, params.layers.layer(i)), x,
            {name: t[i] for name, t in st.items()}, lay)
        for name, t in new.items():
            st[name][i] = t
        return x + out

    ae = cfg.attn_every if cfg.attn_every > 0 else cfg.num_layers
    done = 0
    for site in range(_n_attn_sites(cfg)):
        for i in range(done, done + ae):
            x = mamba(i, x)
        x = _shared_attn(cfg, params.layout,
                         dict(params.shared_attn.items()), x, positions,
                         cache_kv=(cache["attn_k"][site],
                                   cache["attn_v"][site]),
                         cache_pos=pos)
        done += ae
    for i in range(done, cfg.num_layers):
        x = mamba(i, x)
    return T._unembed(cfg, params, x), cache
