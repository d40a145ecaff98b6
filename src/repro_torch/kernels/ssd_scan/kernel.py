"""ctypes binding of the Hopper SSD scan kernel (csrc/ssd_scan.cu).

``launch`` passes device pointers, sizes and the current CUDA stream to the
C entry point of x's dtype and raises if it reports a CUDA error.  It checks
nothing else: ``ops.ssd_scan`` validates and allocates.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("ssd_scan"), _ENTRY[dtype])
    # x, dt, A, Bm, Cm, y, B, S, H, P, N, Q, stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, y: torch.Tensor,
           chunk: int) -> None:
    """y (B, S, H, P) <- SSD scan of x with dt (B, S, H), A (H,) fp32 and
    Bm/Cm (B, S, N), chunk by chunk, on the current stream."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry(x.dtype)(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                          Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                          b, s, h, p, n, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
