"""ctypes binding of the Hopper flash attention kernel
(csrc/flash_attention.cu).

``launch`` passes device pointers, sizes, the causal flag, the fp32 scale
and the current CUDA stream to the C entry point of the tensors' dtype and
raises if it reports a CUDA error.  It checks nothing else:
``ops.flash_attention`` validates and allocates.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention"), _ENTRY[dtype])
    # q, k, v, o, B, Sq, Sk, H, KV, D, causal, scale, stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, causal: bool) -> None:
    """o (B, Sq, H, D) <- attention of q (B, Sq, H, D) over k/v
    (B, Sk, KV, D), on the current stream."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), b, sq, sk, h, kv, d, int(causal),
                          1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
