"""Shared neural-net building blocks (a port of the JAX package's
``models/layers.py``).

RMSNorm in fp32, rotary embeddings with the half-split convention, the
branches of ``attention`` (one-token decode through the decode-attention
kernel, full sequence through the flash kernel, the same with its
recompute backward when gradients are taken, blockwise over a cache with
a valid prefix), SwiGLU, the token cross-entropy, and the initialisers
with the reference's laws drawn from a ``torch.Generator``.

The reference's ``REPRO_OPT`` switches are read once, at import
(``opt_enabled``): ``norm_vjp`` (``rms_norm`` through a hand-written
backward), ``attn_probs16`` (score-sized probabilities in the compute
dtype), ``params16`` (``launch.steps``' train cell) and ``moe_a2a``
(``models.moe``, where it changes nothing).  ``resolve_spec`` resolves
the reference's symbolic activation specs.  The port's tensors are a
rank's blocks, placed by the models' own collectives (``parallel``), so
``constrain`` returns its input and ``activation_mesh`` holds no state.
``token_nll`` over the rank's vocab columns, ``attention_split_hd``
over its slice of the cache's head dim and ``rms_norm`` over its part of
the normalised dimension are the computations a model placed over
``model`` reduces inside a layer.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import parallel
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention, flash_attention_lse
from ..obs import recorder as _trace
from ..sharding import P
from ._attn_mask import key_mask, repeat_kv

_NEG = -1e30


# --------------------------------------------------------------------------
# Switches and activation specs
# --------------------------------------------------------------------------

# Per-optimization switches (set before import):
#   REPRO_OPT=norm_vjp,attn_probs16,params16,moe_a2a
_OPTS = set(filter(None, os.environ.get("REPRO_OPT", "").split(",")))


def opt_enabled(name: str) -> bool:
    return name in _OPTS


def activation_mesh(mesh):
    """The reference's context manager that ``constrain`` resolves its
    specs against.  The port's ``constrain`` moves nothing on any mesh it
    runs on, so this holds no state: a context that yields ``mesh``."""
    return contextlib.nullcontext(mesh)


def resolve_spec(mesh, shape, *elems):
    """The reference's ``constrain`` resolution of ``elems`` for a global
    tensor of ``shape`` on ``mesh``, as a ``sharding.P``: "batch" is the
    (pod, data) prefix that divides the dimension (then data alone), a
    mesh axis name is kept if it divides the dimension, anything else is
    None."""
    sizes = mesh.sizes
    resolved = []
    for i, e in enumerate(elems):
        dim = shape[i] if i < len(shape) else 1
        if e == "batch":
            axes = tuple(a for a in ("pod", "data") if a in sizes)
            while axes and dim % math.prod(sizes[a] for a in axes) != 0:
                axes = axes[1:]
            resolved.append(axes if len(axes) > 1 else
                            (axes[0] if axes else None))
        elif isinstance(e, str) and e in sizes and dim % sizes[e] == 0:
            resolved.append(e)
        else:
            resolved.append(None)
    return P(*resolved)


def constrain(x: torch.Tensor, *elems) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` with symbolic axes
    (``resolve_spec`` gives the spec it would pin).  The port's models
    move their blocks with explicit collectives where a constraint would
    make GSPMD move them: the identity."""
    return x


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

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             group=None) -> torch.Tensor:
    """RMSNorm in fp32 end to end, cast to ``x.dtype`` (autograd's
    backward); under ``norm_vjp`` through ``RMSNormVJP``.  With a
    ``group`` of more than one rank, ``x`` and ``scale`` are this rank's
    equal part of the normalised dimension: the sum of squares is
    all-reduced over the group (forward and backward) and divided by the
    whole width."""
    if opt_enabled("norm_vjp"):
        return RMSNormVJP.apply(x, scale, eps, group)
    x32 = x.float()
    if parallel.size(group) == 1:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    else:
        # the sum feeds every rank's part: its gradient is summed too
        ss = parallel.reduce_from_model(
            (x32 * x32).sum(dim=-1, keepdim=True), group)
        var = parallel.copy_to_model(ss, group) / (
            x.shape[-1] * parallel.size(group))
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _row_mean(t: torch.Tensor, group, width: int) -> torch.Tensor:
    """The sum of fp32 ``t`` over its last dimension, all-reduced over
    ``group``, over ``width`` (the whole dimension's)."""
    s = t.float().sum(dim=-1, keepdim=True)
    return parallel.all_reduce(s, group) / width


class RMSNormVJP(torch.autograd.Function):
    """RMSNorm with fp32 row statistics and ``x.dtype`` element streams
    (the reference's ``_rms_norm_custom``): the backward keeps every
    (..., d)-sized tensor in ``x.dtype`` and only the per-row reductions
    in fp32,  dx = r * (g*w - x_hat * mean(g*w*x_hat)),
    r = rsqrt(var + eps).  With a ``group`` (``rms_norm``'s) both row
    means are all-reduced over it."""

    @staticmethod
    def forward(ctx, x, scale, eps: float, group=None):
        x32 = x.float()
        width = x.shape[-1] * parallel.size(group)
        if parallel.size(group) == 1:
            var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        else:
            var = _row_mean(x32 * x32, group, width)
        r = torch.rsqrt(var + eps)                       # (..., 1) fp32
        ctx.save_for_backward(x, scale, r)
        ctx.group, ctx.width = group, width
        return (x32 * r).to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, r = ctx.saved_tensors
        dtype = x.dtype
        gw = g * scale.to(dtype)
        m = _row_mean(gw * x, ctx.group, ctx.width)
        rx = r * r * r * m                               # (..., 1) fp32
        dx = gw * r.to(dtype) - x * rx.to(dtype)
        dscale = (g * (x * r.to(dtype))).float().sum(
            dim=tuple(range(x.dim() - 1))).to(scale.dtype)
        return dx, dscale, None, None


def rope_frequencies(head_dim: int, theta: float = 1e4,
                     device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) in fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # theta ** exps in float64, rounded once to fp32 (the correctly rounded
    # fp32 power, as the reference's eager ``theta ** exps``): fp32's pow
    # misses it by a step at head dim 128, theta 1e6, and one step of a
    # frequency is 0.03 rad of angle at position 524,287.  A Python-float
    # base: no host-to-device copy (and stream sync) per call
    return 1.0 / torch.pow(theta, exps.double()).float()


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

def _flash_train_bwd(q, k, v, out, lse, dout, causal: bool, block_kv: int,
                     window: int = 0):
    """(dq, dk, dv) of the full-sequence attention: the reference's
    ``_flash_train_bwd``, blockwise over ``block_kv`` keys, with its
    causal and sliding-window mask.
    Each block's probabilities are rebuilt from ``lse``; no (Sq, Sk)
    tensor outlives its block.  K/V are read per q head (GQA) and dK/dV
    summed over each group of H / KV heads.  Under ``attn_probs16`` a
    block's probabilities and dS are one tensor each in ``v.dtype``, as
    the reference's branch; its products take those values and return
    fp32 (the reference's ``preferred_element_type``): their operands are
    widened to fp32, in which a product of two bf16 values is exact."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    block = min(block_kv, sk)
    scale = 1.0 / math.sqrt(hd)
    probs16 = opt_enabled("attn_probs16")
    q32 = q.float()
    do32 = dout.float()
    delta = torch.einsum("bqhd,bqhd->bhq", do32, out.float())   # (B, H, Sq)
    kr = repeat_kv(k, n_rep)
    vr = repeat_kv(v, n_rep)
    q_pos = (sk - sq) + torch.arange(sq, device=q.device)
    neg = torch.full((), _NEG, dtype=torch.float32, device=q.device)
    dq = torch.zeros_like(q32)
    dk = torch.empty(kr.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for start in range(0, sk, block):
        # the reference pads the last block; its padded keys are masked,
        # so a shorter last block gives the same sums
        kblk = kr[:, start:start + block]
        vblk = vr[:, start:start + block]
        kpos = start + torch.arange(kblk.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q32 * scale, kblk.float())
        if causal:
            keep = key_mask(q_pos, kpos, True, None, window)
            s = torch.where(keep[None, None], s, neg)
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, vblk.float())
        rows = slice(start, start + block)
        if probs16:
            p = torch.exp(s - lse[..., None]).to(vblk.dtype)
            dv[:, rows] = torch.einsum("bhqk,bqhd->bkhd", p.float(),
                                       dout.to(p.dtype).float())
            ds = p * ((dp - delta[..., None]) * scale).to(p.dtype)
            dq += torch.einsum("bhqk,bkhd->bqhd", ds.float(), kblk.float())
            dk[:, rows] = torch.einsum("bhqk,bqhd->bkhd", ds.float(),
                                       q.to(ds.dtype).float())
        else:
            p = torch.exp(s - lse[..., None])
            dv[:, rows] = torch.einsum("bhqk,bqhd->bkhd", p, do32)
            ds = p * (dp - delta[..., None]) * scale
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, kblk.float())
            dk[:, rows] = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    if n_rep > 1:
        dk = dk.view(b, sk, kv, n_rep, hd).sum(dim=3)
        dv = dv.view(b, sk, kv, n_rep, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashTrain(torch.autograd.Function):
    """Full-sequence attention with a recompute backward (the reference's
    ``_flash_train`` custom VJP).

    Forward: (o, lse) from one launch of the flash kernel on a CUDA tensor
    (``flash_attention_lse``), the plain version on the CPU; K/V keep
    their KV heads (the kernel reads them in place).  Saved: q, k, v, o and
    lse, O(S) of them.  Backward: ``_flash_train_bwd``, plain PyTorch as
    the reference's is ``jnp`` (its Pallas kernel has no backward), in the
    span ``attn.flash_bwd``.  ``lse`` takes no gradient.  ``window`` > 0:
    the sliding window under ``causal``, in both passes.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_kv: int, window: int = 0):
        out, lse = flash_attention_lse(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_kv, ctx.window = causal, block_kv, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        with _trace.span("attn.flash_bwd", device=q.device):
            dq, dk, dv = _flash_train_bwd(q, k, v, out, lse, dout,
                                          ctx.causal, ctx.block_kv,
                                          ctx.window)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, q_offset: Optional[int] = None,
              block_kv: int = 1024, kv_len: Optional[int] = None,
              window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype.

    The reference's branches: one query row (decode) is one fp32 pass
    over the keys it keeps (``kernels/decode_attention``, in the span
    ``attn.decode_row``: the split-KV kernel on the card, reading the
    cache in place; on the CPU and meta its plain version, the reference's
    dense pass over the repeated and widened cache);
    a full sequence without ``kv_len`` is the flash kernel
    (``kernels/flash_attention``: the CUDA kernel on the card, its plain
    version on the CPU), with q rows at key positions Sk - Sq + i —
    through ``FlashTrain`` and its recompute backward when gradients are
    on and an input requires one (training), the forward alone otherwise
    (prefill); with ``kv_len`` it is the blockwise online softmax over
    ``block_kv`` keys at a time.  ``window`` > 0 is the sliding window
    under ``causal`` on every branch (the kernel's own argument on the
    full-sequence one); the hybrid's decode passes ``causal=False`` and
    ``kv_len`` over its ring buffer, where the window is implicit.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sq > 1 and kv_len is None:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashTrain.apply(q, k, v, causal, block_kv, window)[0]
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal, window)
    if q_offset is None:
        q_offset = sk - sq
    if sq == 1:
        with _trace.span("attn.decode_row", device=q.device):
            return decode_attention(q, k, v, causal, int(q_offset), kv_len,
                                    window)
    n_rep = h // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    q_pos = int(q_offset) + torch.arange(sq, device=q.device)
    neg = torch.full((), _NEG, dtype=torch.float32, device=q.device)
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
        keep = key_mask(q_pos, kpos, causal, kv_len, window)
        s = torch.where(keep[None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attention_split_hd(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                       cols: slice, group, q_offset: int,
                       kv_len: int) -> torch.Tensor:
    """Causal attention over a cache whose head dim is split over a
    group (``cache_specs`` where the KV heads do not divide 16): q (B, Sq,
    H, hd) every head at the full head dim, kc / vc (B, Sk, KV, hd / m)
    this rank's columns ``cols`` of it.  RoPE came before the cache
    write, so the head dim is a pure contraction axis: the scores are
    partial sums over the rank's columns, all-reduced over ``group`` (B
    x H x Sq x Sk fp32), then softmax; p . v gives every head on the
    rank's columns, gathered over ``group``.  The cache is never
    gathered.  -> (B, Sq, H, hd) in q's dtype: the reference's dense
    pass over the cache (one fp32 pass for a decode row)."""
    b, sq, h, hd = q.shape
    sk = kc.shape[1]
    n_rep = h // kc.shape[2]
    k = repeat_kv(kc, n_rep)
    v = repeat_kv(vc, n_rep)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", (q.float() * scale)[..., cols],
                     k.float())
    parallel.all_reduce(s, group)
    q_pos = int(q_offset) + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    neg = torch.full((), _NEG, dtype=torch.float32, device=q.device)
    s = torch.where(key_mask(q_pos, kpos, True, kv_len)[None, None], s, neg)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return parallel.gather_model(out, 3, group).to(q.dtype)


# --------------------------------------------------------------------------
# Activation rematerialisation
# --------------------------------------------------------------------------

#: the products without batch dimensions: a projection's (B·S, d) @ (d, n)
#: (``torch.matmul`` folds the leading dimensions into one ``mm``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat: str, fn: Callable, *args):
    """``fn(*args)`` under the config's rematerialisation: ``"none"``
    keeps every activation; ``"full"`` recomputes the whole call in the
    backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``); ``"dots"`` saves the outputs of the products
    without batch dimensions and recomputes the rest (the reference's
    ``dots_with_no_batch_dims_saveable``), attention's batched products
    and the flash and scan kernels' launches included, in the order of
    the forward."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                     f"{remat!r}")


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down( silu(x @ gate) * (x @ up) )."""
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token cross-entropy of logits whose vocab is split over a
    group: this rank holds columns [lo, lo + Vl).  Forward: the row max
    all-reduced (MAX), the exp-sum (SUM) and the gold logit from the rank
    that owns the label (SUM); the log-sum-exp spans every column, the
    padded tail's too, as the reference's.  Backward: the rank's columns
    of softmax - onehot, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, group):
        mx = parallel.all_reduce(logits.amax(dim=-1), group,
                                 torch.distributed.ReduceOp.MAX)
        sumexp = parallel.all_reduce(
            torch.exp(logits - mx[..., None]).sum(dim=-1), group)
        logz = mx + torch.log(sumexp)
        local = labels.long() - lo
        own = (local >= 0) & (local < logits.shape[-1])
        idx = local.clamp(0, logits.shape[-1] - 1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = parallel.all_reduce(gold.masked_fill(~own, 0), group)
        ctx.save_for_backward(logits, logz, idx, own)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, own = ctx.saved_tensors
        grad = torch.exp(logits - logz[..., None])
        grad.scatter_add_(-1, idx[..., None], -own[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def token_nll(logits: torch.Tensor, labels: torch.Tensor, vocab_lo: int = 0,
              group=None) -> torch.Tensor:
    """Per-token cross-entropy (..., S) in fp32, labels integer.  With a
    ``group`` the logits are this rank's vocab columns from ``vocab_lo``
    (``_VocabParallelNLL``)."""
    logits = logits.float()
    if parallel.size(group) > 1:
        return _VocabParallelNLL.apply(logits, labels, vocab_lo, group)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels (B, S) integer."""
    nll = token_nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
