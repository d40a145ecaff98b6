"""ctypes binding of the Hopper ``coded_matmul`` kernel (csrc/coded_matmul.cu).

``launch`` passes device pointers, sizes and the current CUDA stream to the
C entry point of the tensors' dtype and raises if it reports a CUDA error.
It checks nothing else: ``ops.coded_matmul`` validates and allocates.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_ENTRY = {torch.float32: "coded_matmul_f32",
          torch.bfloat16: "coded_matmul_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("coded_matmul"), _ENTRY[dtype])
    # G, A, X, C, P, n, k, M, K, N, splits, stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(G32: torch.Tensor, A: torch.Tensor, X: torch.Tensor,
           C: torch.Tensor, P: torch.Tensor) -> None:
    """C (n, M, N) <- coded product of G32 (n, k) fp32, A (k, M, K) and
    X (K, N), using P (S, k, M, N) fp32 as scratch for S slices of the K
    range, on the current stream."""
    n, k = G32.shape
    _, M, K = A.shape
    N = X.shape[1]
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _entry(A.dtype)(G32.data_ptr(), A.data_ptr(), X.data_ptr(),
                          C.data_ptr(), P.data_ptr(), n, k, M, K, N,
                          P.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"coded_matmul kernel launch failed: CUDA error "
                           f"{err}")
