"""The dense decoder (qwen3): pre-norm RMSNorm, q/k/v projections,
per-head RMSNorm of q and k (qk-norm), rotary embedding on the half-split
pairs, causal grouped-query attention, the output projection, SwiGLU, a
final RMSNorm and an untied head.

The file's published keys (``hidden_size``, ``num_attention_heads``, ...)
and ``run.qk_norm``.  Counts: 2 x matmul parameters x tokens plus
attention's 4 * H * D a kept (query, key) pair in every layer; a decode
step reads the K and V cache up to each row's position and every
parameter but the embedding table, whose B rows it looks up.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import counts, weights
from ..reference import model
from ..reference.model import Params, _proj, attend, rms, rope
from ..reference.numerics import Numerics
from ..spec import Spec, common


@dataclasses.dataclass(frozen=True)
class DenseSpec(Spec):
    qk_norm: bool = False


def spec_of(config: dict) -> DenseSpec:
    return DenseSpec(**common(config),
                     qk_norm=config["run"].get("qk_norm", False))


def program_checks(s: DenseSpec, run: dict) -> dict:
    return {"num_layers": s.layers, "d_model": s.d, "num_heads": s.heads,
            "num_kv_heads": s.kv_heads, "resolved_head_dim": s.head_dim,
            "d_ff": s.d_ff, "vocab_size": s.vocab, "norm_eps": s.eps,
            "rope_theta": s.rope_theta, "qk_norm": s.qk_norm,
            "ssm_state": 0, "attn_every": 0, "attn_window": s.window}


def block_shapes(s: DenseSpec) -> weights.Shapes:
    """One decoder layer's leaves."""
    d, h, kv, hd, f = s.d, s.heads, s.kv_heads, s.head_dim, s.d_ff
    out = {"attn_norm": (d,), "wq": (d, h, hd), "wk": (d, kv, hd),
           "wv": (d, kv, hd), "wo": (h, hd, d), "mlp_norm": (d,)}
    if s.qk_norm:
        out.update(q_norm=(hd,), k_norm=(hd,))
    out.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    return out


def param_shapes(s: DenseSpec) -> weights.Shapes:
    return weights.decoder_layout(s, block_shapes(s))


def fan_in(s: DenseSpec, name: str) -> int:
    leaf = name.split(".")[-1]
    return {"wo": s.heads * s.head_dim, "w_down": s.d_ff}.get(leaf, s.d)


def qkv(spec: DenseSpec, num: Numerics, lp: Params, x: torch.Tensor,
        pos: torch.Tensor):
    h = rms(x, lp["attn_norm"], spec.eps)
    q, k, v = (_proj(num, h, lp[n]) for n in ("wq", "wk", "wv"))
    if spec.qk_norm:
        q, k = rms(q, lp["q_norm"], spec.eps), rms(k, lp["k_norm"], spec.eps)
    return rope(q, pos, spec.rope_theta), rope(k, pos, spec.rope_theta), v


def attn_out_and_mlp(spec: DenseSpec, num: Numerics, lp: Params,
                     x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    x = x + _proj(num, att.flatten(-2), lp["wo"].flatten(0, 1))
    h = rms(x, lp["mlp_norm"], spec.eps)
    g, u = _proj(num, h, lp["w_gate"]), _proj(num, h, lp["w_up"])
    return x + _proj(num, F.silu(g) * u, lp["w_down"])


def decoder_layer(spec: DenseSpec, num: Numerics, lp: Params,
                  x: torch.Tensor, window: int = 0) -> torch.Tensor:
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = qkv(spec, num, lp, x, pos)
    return attn_out_and_mlp(spec, num, lp, x,
                            attend(num, q, k, v, pos, pos, window))


def hidden(spec: DenseSpec, num: Numerics, P: Params, tokens: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    x = P["embed"][tokens]
    for i in range(spec.layers):
        x = model.run_layer(lambda x, i=i: decoder_layer(
            spec, num, model.layer_params(P, i), x), x, remat)
    return rms(x, P["final_norm"], spec.eps)


def decode_over_prefix(spec: DenseSpec, num: Numerics, P: Params,
                       tokens: torch.Tensor, p_lo: int, prefix_kv,
                       ) -> tuple:
    """``prefix_kv(layer)``: (B, p_lo, KV, hd) each; k and v returned
    (L, B, T, KV, hd) each."""
    t = tokens.shape[1]
    pos = p_lo + torch.arange(t, device=tokens.device)
    k_pos = torch.arange(p_lo + t, device=tokens.device)
    x = P["embed"][tokens]
    ks, vs = [], []
    for i in range(spec.layers):
        lp = model.layer_params(P, i)
        q, k, v = qkv(spec, num, lp, x, pos)
        pk, pv = prefix_kv(i)
        att = attend(num, q, torch.cat([pk.float(), k], 1),
                     torch.cat([pv.float(), v], 1), pos, k_pos)
        x = attn_out_and_mlp(spec, num, lp, x, att)
        ks.append(k)
        vs.append(v)
        del pk, pv
    return rms(x, P["final_norm"], spec.eps), torch.stack(ks), torch.stack(vs)


def matrices(shapes: weights.Shapes) -> float:
    """Parameters of the leaves of rank 2 or more, which enter a matrix
    product once a token."""
    return float(sum(math.prod(sh) for sh in shapes.values()
                     if len(sh) >= 2))


def matmul_params(s: DenseSpec) -> float:
    """Every layer's matrices and the head."""
    return s.layers * matrices(block_shapes(s)) + s.d * s.vocab_pad


def forward_flops(s: Spec, matmul: float, attn_layers: int, batch: int,
                  seq: int) -> float:
    """2 x ``matmul`` parameters x tokens, plus attention's 4 * H * D a
    kept pair in each of ``attn_layers`` layers."""
    tokens = batch * seq
    flops = 2.0 * matmul * tokens
    flops += (attn_layers * 4.0 * batch * s.heads * s.head_dim
              * counts.kept_pairs(seq, seq, True, s.window))
    return flops


def model_flops(s: DenseSpec, batch: int, seq: int, train: bool) -> float:
    flops = forward_flops(s, matmul_params(s), s.layers, batch, seq)
    return 3.0 * flops if train else flops


def decode_bytes(s: DenseSpec, batch: int, position: int,
                 param_bytes: int = 4, cache_bytes: int = 2) -> float:
    cache = (2.0 * s.layers * batch * (position + 1) * s.kv_heads
             * s.head_dim * cache_bytes)
    params = 0.0
    for name, shape in param_shapes(s).items():
        params += batch * s.d if name == "embed" else math.prod(shape)
    return cache + params * param_bytes
