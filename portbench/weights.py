"""Parameters and caches drawn from the seed, on the device.

Every leaf has a generator of its own, seeded from (seed, leaf name), so
each is one call on the card and can be drawn again alone: the reference
draws the same values leaf by leaf after the program's state is freed.
The leaves are the port's checkpoint layout (``layers.<name>`` stacked
along a leading layer axis), which ``fill`` checks name by name and shape
by shape against the program's module.  The laws are the usual ones:
norms, D and the gated norm 1, fan-in normal weights, a 0.02 normal
embedding, A = -exp(A_log) with A_log = log U[1, 16), dt_bias the inverse
softplus of U[1e-3, 1e-1).  The masters are fp32, as the configuration
holds them.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

from .spec import Spec

Shapes = Dict[str, Tuple[int, ...]]


def _dense_layers(s: Spec) -> Shapes:
    L, d, h, kv, hd, f = (s.layers, s.d, s.heads, s.kv_heads, s.head_dim,
                          s.d_ff)
    out = {"attn_norm": (L, d), "wq": (L, d, h, hd), "wk": (L, d, kv, hd),
           "wv": (L, d, kv, hd), "wo": (L, h, hd, d), "mlp_norm": (L, d)}
    if s.qk_norm:
        out.update(q_norm=(L, hd), k_norm=(L, hd))
    out.update(w_gate=(L, d, f), w_up=(L, d, f), w_down=(L, f, d))
    return out


def _mamba_layers(s: Spec) -> Shapes:
    L, d, di, h, n, k = (s.layers, s.d, s.d_inner, s.ssm_heads, s.ssm_state,
                         s.conv_k)
    return {"norm": (L, d), "wz": (L, d, di), "wx": (L, d, di),
            "wB": (L, d, n), "wC": (L, d, n), "wdt": (L, d, h),
            "conv_x": (L, k, di), "conv_B": (L, k, n), "conv_C": (L, k, n),
            "A_log": (L, h), "D": (L, h), "dt_bias": (L, h),
            "gate_norm": (L, di), "out_proj": (L, di, d)}


def param_shapes(s: Spec) -> Shapes:
    """Every leaf's shape by dotted name."""
    v, d = s.vocab_pad, s.d
    out: Shapes = {"embed": (v, d)}
    layers = _dense_layers(s) if s.family == "dense" else _mamba_layers(s)
    out.update({f"layers.{n}": sh for n, sh in layers.items()})
    out.update(final_norm=(d,), lm_head=(d, v))
    if s.family == "hybrid" and s.sites:
        h, kv, hd, f = s.heads, s.kv_heads, s.head_dim, s.d_ff
        out.update({
            "shared_attn.attn_norm": (d,), "shared_attn.wq": (d, h, hd),
            "shared_attn.wk": (d, kv, hd), "shared_attn.wv": (d, kv, hd),
            "shared_attn.wo": (h, hd, d), "shared_attn.mlp_norm": (d,),
            "shared_attn.w_gate": (d, f), "shared_attn.w_up": (d, f),
            "shared_attn.w_down": (f, d)})
    return out


def _fan_in(s: Spec, name: str) -> int:
    leaf = name.split(".")[-1]
    return {"wo": s.heads * s.head_dim, "w_down": s.d_ff,
            "out_proj": s.d_inner}.get(leaf, s.d)


def seed_of(seed: int, *key) -> int:
    """A 63-bit seed for (seed, key...), stable across processes."""
    text = ":".join(str(k) for k in (int(seed),) + key)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(seed: int, device, *key) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, *key))


@torch.no_grad()
def draw(s: Spec, name: str, shape, seed: int, device) -> torch.Tensor:
    """Leaf ``name`` (fp32) drawn from (seed, name)."""
    leaf = name.split(".")[-1]
    f32 = torch.float32
    if leaf.endswith("norm") or leaf == "D":
        return torch.ones(shape, dtype=f32, device=device)
    g = generator(seed, device, "param", name)
    if leaf == "A_log":
        return torch.empty(shape, dtype=f32, device=device).uniform_(
            1.0, 16.0, generator=g).log_()
    if leaf == "dt_bias":
        u = torch.empty(shape, dtype=f32, device=device).uniform_(
            1e-3, 1e-1, generator=g)
        return torch.log(torch.expm1(u))
    x = torch.randn(shape, dtype=f32, device=device, generator=g)
    if leaf == "embed":
        return x.mul_(0.02)
    if leaf.startswith("conv"):
        return x.mul_(1.0 / math.sqrt(s.conv_k))
    return x.mul_(1.0 / math.sqrt(_fan_in(s, name)))


def draw_all(s: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    return {n: draw(s, n, sh, seed, device)
            for n, sh in param_shapes(s).items()}


@torch.no_grad()
def fill(module: torch.nn.Module, s: Spec, seed: int) -> None:
    """Copy the drawn leaves into the program's ``module``, one leaf at a
    time; raises where its names or shapes are not the layout's."""
    shapes = param_shapes(s)
    params = dict(module.named_parameters())
    if set(params) != set(shapes):
        extra, missing = set(params) - set(shapes), set(shapes) - set(params)
        raise ValueError(f"the program's leaves differ from the layout: "
                         f"only the program's {sorted(extra)}, only the "
                         f"layout's {sorted(missing)}")
    for name, p in params.items():
        if tuple(p.shape) != shapes[name]:
            raise ValueError(f"{name}: the program's {tuple(p.shape)}, the "
                             f"layout's {shapes[name]}")
        p.copy_(draw(s, name, shapes[name], seed, p.device))


@torch.no_grad()
def cache_layer(seed: int, which: str, layer: int, shape, dtype,
                device) -> torch.Tensor:
    """One layer's K or V cache (``which``), drawn from N(0, 1) in its
    dtype; ``fill_cache`` writes the same values in place."""
    g = generator(seed, device, "cache", which, layer)
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        generator=g)


@torch.no_grad()
def fill_cache(kc: torch.Tensor, vc: torch.Tensor, seed: int) -> None:
    """Fill stacked (L, B, S, KV, hd) caches in place, layer by layer."""
    for which, t in (("k", kc), ("v", vc)):
        for layer in range(t.shape[0]):
            g = generator(seed, t.device, "cache", which, layer)
            t[layer].normal_(generator=g)
