"""Public wrapper for the flash attention forward.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the Hopper kernel (``kernel.py``), after the checks below, or raises.  A
``meta`` tensor (the dry run, ``launch.dryrun``) gets the kernel's outputs
as meta tensors after the same checks (none reads data), and never the
plain version, whose (S x S) scores the kernel never writes.
``flash_attention_lse`` is the same launch that also writes the rows'
log-sum-exp.  ``window`` > 0 keeps, under ``causal``, only the last
``window`` keys of each row (the reference's sliding window); without
``causal`` it is ignored, as in the reference.
``flash_attention.launches`` counts the kernel launches of both; each
launch, and each meta call in its place, reports ``cost``'s operations
and bytes to the op recorder (``_trace``).
"""
from __future__ import annotations

import torch

from ... import _trace
from . import kernel
from .ref import attention_lse_ref, attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128)
#: head dims of the bf16 kernel under a causal sliding window (no config
#: runs a window at another)
WINDOW_HEAD_DIMS = (16, 32, 64, 128)
_INT_MAX = 2 ** 31 - 1


def kept_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> float:
    """The (q, k) pairs a head keeps: all Sq * Sk without ``causal``; with
    it, row i (at key position Sk - Sq + i) keeps min(pos + 1, window)
    keys (every key up to its own without a window)."""
    if not causal:
        return float(sq * sk)

    def upto(n: int) -> float:      # the rows at positions 0 .. n - 1
        w = window if 0 < window < n else n
        return w * (w + 1) / 2 + (n - w) * w

    return upto(sk) - upto(sk - sq)


def cost(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
         window: int = 0, with_lse: bool = False):
    """(operations, bytes) of one launch: 4 * B * H * D a kept pair (the
    products q k^T and p v), and q, k, v read once, o (and the fp32 lse)
    written once.  The count behind the kernels' ``bound_ms``."""
    b, sq, h, d = q.shape
    ops = 4.0 * b * h * kept_pairs(sq, k.shape[1], causal, window) * d
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    if with_lse:
        nbytes += b * h * sq * 4
    return ops, nbytes


def _report(q, k, v, o, lse, causal: bool, window: int) -> None:
    """One launch to the op recorder: ``cost``, and the shapes and dtypes
    of the operands and the outputs."""
    if _trace.sinks:
        ops, nbytes = cost(q, k, causal, window, lse is not None)
        tensors = [t for t in (q, k, v, o, lse) if t is not None]
        _trace.emit({"kind": "kernel", "op": "flash_attention",
                     "flops": ops, "bytes": nbytes,
                     "dtype": str(q.dtype)[6:],
                     "shapes": [list(t.shape) for t in tensors],
                     "dtypes": [str(t.dtype)[6:] for t in tensors]})


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int = 0) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, Sq, H, D) and k, v (B, Sk, KV, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    (b, sq, h, d), (b2, sk, kv, d2) = q.shape, k.shape
    if b != b2 or d != d2 or kv < 1 or h % kv != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} (H must be a multiple of KV)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if min(b, sq, sk) < 1 or max(b * sq * h * d, b * sk * kv * d) > _INT_MAX:
        raise ValueError(f"sizes out of range: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if window < 0 or window > _INT_MAX:
        raise ValueError(f"window must be >= 0 (0: none), got {window}")
    if causal and sk < sq:
        raise ValueError(f"causal attention needs Sk >= Sq, got Sq={sq}, "
                         f"Sk={sk}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share dtype float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and causal and window > 0 and \
            d not in WINDOW_HEAD_DIMS:
        raise ValueError(f"bf16 head dim {d} under a sliding window: not "
                         f"in {WINDOW_HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start on 16-byte boundaries "
                         "(the kernel copies 16-byte pieces of each row)")


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         with_lse: bool, window: int):
    """(o, lse or None): the plain version for CPU tensors, the kernel's
    outputs on meta, else the kernel after the checks, counted in
    ``flash_attention.launches``."""
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k and v must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0: none), got {window}")
    if q.device.type == "cpu":
        if with_lse:
            return attention_lse_ref(q, k, v, causal, window)
        return attention_ref(q, k, v, causal, window), None
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, causal, window)
    o = torch.empty_like(q)
    lse = None
    if with_lse:
        b, sq, h, _ = q.shape
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.device.type == "cuda":
        with torch.cuda.device(q.device):
            kernel.launch(q, k, v, o, causal, lse, window)
        flash_attention.launches += 1
    _report(q, k, v, o, lse, causal, window)
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in ``q.dtype``.

    All three tensors on the CPU: the plain version.  All three on one CUDA
    device: the kernel.  All three on meta: the kernel's output, unlaunched.
    Anything else raises.
    """
    return _run(q, k, v, causal, False, window)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0):
    """``flash_attention``'s output and the rows' log-sum-exp (B, H, Sq)
    fp32, from the same launch (the training path's forward).  Counted in
    ``flash_attention.launches``."""
    return _run(q, k, v, causal, True, window)


flash_attention.launches = 0
