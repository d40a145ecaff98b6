"""Shared neural-net building blocks (a port of the JAX package's
``models/layers.py``, serving path).

RMSNorm in fp32, rotary embeddings with the half-split convention, the
three branches of ``attention`` (one-token decode, full sequence through
the flash kernel, blockwise over a cache with a valid prefix), SwiGLU, and
the initialisers with the reference's laws drawn from a ``torch.Generator``.
The reference's sharding constraints and its ``REPRO_OPT`` switches have no
counterpart: the port computes their defaults.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention

_NEG = -1e30


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------

def truncated_normal(generator: torch.Generator, shape, dtype=torch.float32,
                     lower: float = -3.0, upper: float = 3.0) -> torch.Tensor:
    """Standard normal truncated to [lower, upper], by inverting the CDF of
    a uniform draw on [Phi(lower), Phi(upper)] (the law of
    ``jax.random.truncated_normal``), on the generator's device."""
    cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(lower), cdf(upper)
    u = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device).uniform_(lo, hi,
                                                      generator=generator)
    z = u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))
    return z.clamp_(lower, upper).to(dtype)


def dense_init(generator: torch.Generator, shape, in_axis_size: int,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LM inits)."""
    std = 1.0 / math.sqrt(max(in_axis_size, 1))
    return truncated_normal(generator, shape, dtype).mul_(std)


def embed_init(generator: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    return truncated_normal(generator, shape, dtype).mul_(0.02)


# --------------------------------------------------------------------------
# RMSNorm and rotary position embedding
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 end to end, cast to ``x.dtype``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 1e4,
                     device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) in fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-float base: no host-to-device copy (and stream sync) per call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotate (..., S, H, hd) by per-token positions (..., S); pairs are
    (i, i + hd/2)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs             # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV * n_rep, hd) by head repetition (GQA)."""
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def _mask(q_pos, kpos, causal: bool, kv_len) -> torch.Tensor:
    mask = torch.ones((q_pos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=kpos.device)
    if causal:
        mask &= q_pos[:, None] >= kpos[None, :]
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, q_offset: Optional[int] = None,
              block_kv: int = 1024, kv_len: Optional[int] = None,
              window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype.

    Three branches, as in the reference: one query row (decode) is one
    dense fp32 pass over the keys; a full sequence without ``kv_len``
    (prefill) is the flash kernel (``kernels/flash_attention``: the CUDA
    kernel on the card, its plain version on the CPU), with q rows at key
    positions Sk - Sq + i; with ``kv_len`` it is the blockwise online
    softmax over ``block_kv`` keys at a time.
    """
    if window > 0:
        raise NotImplementedError(
            "sliding-window attention comes with the hybrid (zamba2) in the "
            "training slice, ROADMAP Queue 1 slice 5")
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sq > 1 and kv_len is None:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal)
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    if q_offset is None:
        q_offset = sk - sq
    q_pos = int(q_offset) + torch.arange(sq, device=q.device)
    neg = torch.full((), _NEG, dtype=torch.float32, device=q.device)

    if sq == 1:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
        kpos = torch.arange(sk, device=q.device)
        s = torch.where(_mask(q_pos, kpos, causal, kv_len)[None, None], s,
                        neg)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
        return out.transpose(1, 2).to(q.dtype)

    block = min(block_kv, sk)
    q32 = q.float() * scale
    m = torch.full((b, h, sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, sk, block):
        # the reference pads the last block; its padded keys are masked, so
        # a shorter last block is the same sum
        kblk = k[:, start:start + block].float()
        vblk = v[:, start:start + block].float()
        kpos = start + torch.arange(kblk.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kblk)
        s = torch.where(_mask(q_pos, kpos, causal, kv_len)[None, None], s,
                        neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down( silu(x @ gate) * (x @ up) )."""
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)
