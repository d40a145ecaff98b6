"""Decoder transformer LM, dense family (a port of the JAX package's
``models/transformer.py``, serving path).

``TransformerLM`` holds the parameters under the reference's pytree names
and shapes: ``layers.<name>`` stacked along a leading ``num_layers`` axis
(``layers.wq`` (L, d, H, hd), ...), ``embed``, ``final_norm`` and
``lm_head``.  The forward pass is a loop over layers that indexes them.
MoE (``num_experts > 0``) and embedding inputs come with the training
slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .._device import DEFAULT_DEVICE, resolve
from ..configs.base import ModelConfig
from . import layers as L
from .params import StackedParams, dtype_of, no_grad_parameter


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 128."""
    return (cfg.vocab_size + 127) // 128 * 128


def _layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, f, nl = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_layers
    shapes = {
        "attn_norm": (nl, d),
        "wq": (nl, d, h, hd),
        "wk": (nl, d, kv, hd),
        "wv": (nl, d, kv, hd),
        "wo": (nl, h, hd, d),
        "mlp_norm": (nl, d),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (nl, hd)
        shapes["k_norm"] = (nl, hd)
    shapes.update(w_gate=(nl, d, f), w_up=(nl, d, f), w_down=(nl, f, d))
    return shapes


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers come with the training slice "
            f"(ROADMAP Queue 1 slice 5)")
    if cfg.embedding_inputs:
        raise NotImplementedError(
            f"{cfg.name}: embedding-input families come with the training "
            f"slice (ROADMAP Queue 1 slice 5)")


class TransformerLM(torch.nn.Module):
    """Dense decoder LM; parameters uninitialised until ``init_params`` or
    ``convert.params_to_port`` fills them."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE):
        super().__init__()
        _check_supported(cfg)
        device = resolve(device)
        self.cfg = cfg
        dt = dtype_of(cfg.param_dtype)
        v = padded_vocab(cfg)
        self.layers = StackedParams(_layer_shapes(cfg), dt, device)
        self.embed = no_grad_parameter((v, cfg.d_model), dt, device)
        self.final_norm = no_grad_parameter((cfg.d_model,), dt, device)
        self.lm_head = no_grad_parameter((cfg.d_model, v), dt, device)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, positions)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator) -> TransformerLM:
    """Parameters with the reference's laws (norms 1, truncated-normal
    fan-in weights, 0.02 embedding), drawn from ``generator`` on its
    device."""
    model = TransformerLM(cfg, generator.device)
    for name, p in sorted(model.layers.named_parameters()):
        shape = p.shape
        if "norm" in name:
            p.fill_(1.0)
            continue
        fan_in = shape[-2] if len(shape) > 2 else shape[-1]
        if name == "wo":
            fan_in = shape[1] * shape[2]
        if name in ("wq", "wk", "wv"):
            fan_in = shape[1]
        p.copy_(L.dense_init(generator, shape, fan_in, p.dtype))
    model.embed.copy_(L.embed_init(generator, model.embed.shape,
                                   model.embed.dtype))
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(L.dense_init(generator, model.lm_head.shape,
                                     cfg.d_model, model.lm_head.dtype))
    return model


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                x: torch.Tensor, positions: torch.Tensor,
                cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_pos: Optional[int] = None):
    """One attention sub-block.  With ``cache_kv`` the step's keys and
    values are first written into the cache at ``cache_pos``."""
    dtype = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)

    def proj(w):
        return (h @ w.reshape(d, -1).to(dtype)).view(b, s, w.shape[1],
                                                     w.shape[2])

    q, k, v = proj(lp["wq"]), proj(lp["wk"]), proj(lp["wv"])
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache_kv is not None:
        kc, vc = cache_kv
        # the reference's dynamic_update_slice, written in place into the
        # caller's cache tensors (it returns a new cache)
        kc[:, cache_pos:cache_pos + s] = k.to(kc.dtype)
        vc[:, cache_pos:cache_pos + s] = v.to(vc.dtype)
        out = L.attention(q, kc, vc, causal=True, q_offset=cache_pos,
                          block_kv=cfg.flash_block_kv,
                          kv_len=cache_pos + s)
    else:
        out = L.attention(q, k, v, causal=cfg.causal, q_offset=0,
                          block_kv=cfg.flash_block_kv)
    hh, hd = lp["wo"].shape[0], lp["wo"].shape[1]
    return out.reshape(b, s, hh * hd) @ lp["wo"].reshape(hh * hd, d).to(dtype)


def _ffn_block(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _embed(cfg: ModelConfig, params: TransformerLM,
           tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast: bit for bit the reference's cast-then-gather,
    # without casting the whole table on every call
    return params.embed[tokens].to(dtype_of(cfg.compute_dtype))


def _unembed(cfg: ModelConfig, params: TransformerLM,
             x: torch.Tensor) -> torch.Tensor:
    dtype = dtype_of(cfg.compute_dtype)
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return h @ params.lm_head.to(dtype)


@torch.no_grad()
def forward(cfg: ModelConfig, params: TransformerLM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V_pad).  Prefill path: one
    flash-attention launch per layer on the card."""
    x = _embed(cfg, params, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.num_layers):
        lp = params.layers.layer(i)
        x = x + _attn_block(cfg, lp, x, positions)
        x = x + _ffn_block(cfg, lp, x)
    return _unembed(cfg, params, x)


# --------------------------------------------------------------------------
# KV-cache serving path
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=DEFAULT_DEVICE):
    """Stacked KV cache: a pair of zero (L, B, S_max, KV, hd) tensors (two
    tensors, since decode writes them in place)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt, device = dtype_of(dtype), resolve(device)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: TransformerLM, cache,
                tokens: torch.Tensor, pos: int):
    """One autoregressive step: tokens (B, 1) at position ``pos``.  Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    pos = int(pos)
    x = _embed(cfg, params, tokens)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    kc_all, vc_all = cache
    for i in range(cfg.num_layers):
        lp = params.layers.layer(i)
        x = x + _attn_block(cfg, lp, x, positions,
                            cache_kv=(kc_all[i], vc_all[i]), cache_pos=pos)
        x = x + _ffn_block(cfg, lp, x)
    return _unembed(cfg, params, x), cache
