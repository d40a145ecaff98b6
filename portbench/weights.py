"""Parameters and caches drawn from the seed, on the device.

Every leaf has a generator of its own, seeded from (seed, leaf name), so
each is one call on the card and can be drawn again alone: the reference
draws the same values leaf by leaf after the program's state is freed.
The leaves are the port's checkpoint layout as the configuration's
family gives it (``layers.<name>`` stacked along a leading layer axis),
which ``fill`` checks name by name and shape by shape against the
program's module.  The laws are the usual ones, by a leaf's role: norms,
D and the gated norm 1, A = -exp(A_log) with A_log = log U[1, 16),
dt_bias the inverse softplus of U[1e-3, 1e-1), a 0.02 normal embedding,
and otherwise normal weights over the square root of the fan-in the
family gives; a family may give a law of its own for a role of its own.
The masters are fp32, as the configuration holds them.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

from .spec import Spec, family_of

Shapes = Dict[str, Tuple[int, ...]]


def decoder_layout(s: Spec, layer: Shapes) -> Shapes:
    """The layout of a stack of ``s.layers`` layers of leaves ``layer``:
    the embedding table, the layers' leaves stacked, the final norm and
    the head."""
    v, d = s.vocab_pad, s.d
    out: Shapes = {"embed": (v, d)}
    out.update({f"layers.{n}": (s.layers,) + sh for n, sh in layer.items()})
    out.update(final_norm=(d,), lm_head=(d, v))
    return out


def param_shapes(s: Spec) -> Shapes:
    """Every leaf's shape by dotted name."""
    return family_of(s).param_shapes(s)


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
    fam = family_of(s)
    if leaf in getattr(fam, "LAWS", {}):
        return fam.LAWS[leaf](s, shape, generator(seed, device, "param",
                                                  name), device)
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
    return x.mul_(1.0 / math.sqrt(fam.fan_in(s, name)))


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
