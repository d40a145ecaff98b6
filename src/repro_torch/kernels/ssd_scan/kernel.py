"""ctypes binding of the Hopper SSD scan kernels (csrc/ssd_scan.cu).

``launch`` passes device pointers, sizes, the bf16 schedule's workspace and
the current CUDA stream to the C entry point of x's dtype and raises if it
reports a CUDA error.  It checks nothing else: ``ops.ssd_scan`` validates
and allocates, with ``workspace_bytes`` for the workspace's size.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
# x, dt, A, Bm, Cm, y, B, S, H, P, N, Q, [work,] stream
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
_ARGTYPES = {torch.float32: _ARGS + [ctypes.c_void_p],
             torch.bfloat16: _ARGS + [ctypes.c_void_p] * 2}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("ssd_scan"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES[dtype]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _workspace_fn():
    fn = _build.load("ssd_scan").ssd_scan_bf16_workspace
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn


def workspace_bytes(b: int, s: int, h: int, p: int, n: int,
                    chunk: int) -> int:
    """Bytes of device memory the bf16 schedule needs as workspace: C B^T
    per chunk, (lcum, dt) per step and head, and one fp32 state per chunk
    and head."""
    nbytes = _workspace_fn()(b, s, h, p, n, chunk)
    if nbytes < 0:
        raise ValueError(f"no workspace for B={b} S={s} H={h} P={p} N={n} "
                         f"chunk={chunk}")
    return nbytes


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, y: torch.Tensor,
           chunk: int, work: torch.Tensor = None) -> None:
    """y (B, S, H, P) <- SSD scan of x with dt (B, S, H), A (H,) fp32 and
    Bm/Cm (B, S, N), on the current stream.  bf16 takes ``work``, a device
    buffer of ``workspace_bytes`` bytes; fp32 takes none."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), b, s, h, p, n, chunk]
    if x.dtype == torch.bfloat16:
        args.append(work.data_ptr())
    err = _entry(x.dtype)(*args, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
