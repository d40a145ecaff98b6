"""Public wrapper for the flash attention forward.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the Hopper kernel (``kernel.py``), after the checks below, or raises.
``flash_attention.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_INT_MAX = 2 ** 31 - 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
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
    if causal and sk < sq:
        raise ValueError(f"causal attention needs Sk >= Sq, got Sq={sq}, "
                         f"Sk={sk}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share dtype float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start on 16-byte boundaries "
                         "(the kernel copies 16-byte pieces of each row)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in ``q.dtype``.

    All three tensors on the CPU: the plain version.  All three on one CUDA
    device: the kernel.  Anything else raises.
    """
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k and v must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, causal)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        kernel.launch(q, k, v, o, causal)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
