"""ctypes binding of the Hopper split-KV decode attention kernel
(csrc/decode_attention.cu).

``launch`` passes device pointers, sizes, q's dtype as a flag, K's and V's
strides in elements, the kept key range, the split plan, the fp32 scale
and the CUDA stream to the C entry point of the cache's dtype, and
raises if it reports a CUDA error.  It checks nothing else:
``ops.decode_attention`` validates, plans the splits and allocates.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("decode_attention"), _ENTRY[dtype])
    # q, k, v, out, scratch, B, H, KV, D, q_bf16, k strides (3), v strides
    # (3), lo, hi, chunk, nsplit, scale, stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, scratch: torch.Tensor, lo: int, hi: int,
           chunk: int, nsplit: int, stream: int) -> None:
    """out (B, 1, H, D) <- attention of q (B, 1, H, D) over keys
    [lo, hi) of k/v (B, Sk, KV, D), in ``nsplit`` splits of ``chunk``
    keys, with ``scratch`` (B * H * nsplit * (D + 2) fp32) for the splits'
    partial results, on ``stream`` (a ``cudaStream_t``) of the current
    device."""
    b, _, h, d = q.shape
    err = _entry(k.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), scratch.data_ptr(), b, h,
                          k.shape[2], d, int(q.dtype == torch.bfloat16),
                          *k.stride()[:3], *v.stride()[:3], lo, hi, chunk,
                          nsplit, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
