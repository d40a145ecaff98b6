"""ctypes binding of the Hopper flash attention kernel
(csrc/flash_attention.cu).

``launch`` passes device pointers (the row log-sum-exp's null when it is
not asked for), sizes, the causal flag, the sliding window (0: none), the
fp32 scale and the current CUDA stream to the C entry point of the
tensors' dtype and raises if it reports a CUDA error.  It checks nothing else:
``ops.flash_attention`` validates and allocates.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import _build

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention"), _ENTRY[dtype])
    # q, k, v, o, lse, B, Sq, Sk, H, KV, D, causal, window, scale, stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, causal: bool,
           lse: Optional[torch.Tensor] = None, window: int = 0) -> None:
    """o (B, Sq, H, D) <- attention of q (B, Sq, H, D) over k/v
    (B, Sk, KV, D), under ``causal`` within the last ``window`` keys of
    each row (0: all), and, when given, lse (B, H, Sq) fp32 <- the rows'
    log-sum-exp, on the current stream."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse_ptr = None if lse is None else lse.data_ptr()
    err = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse_ptr, b, sq, sk, h, kv, d,
                          int(causal), int(window), 1.0 / math.sqrt(d),
                          stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
