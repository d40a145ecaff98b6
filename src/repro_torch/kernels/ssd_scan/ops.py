"""Public wrapper for the Mamba2 SSD chunked scan.

A CPU tensor takes the plain version (``ref.ssd_chunked``).  A CUDA tensor
launches the Hopper kernels (``kernel.py``), after the checks below, or
raises: bf16 x, B and C the tensor-core schedule (four CUDA kernels a call,
with a workspace allocated here), fp32 the SIMT one (one CUDA kernel).  The
kernels themselves refuse what they do not take (``csrc/ssd_scan.cu``: for
fp32 a state or chunk that does not fit one block; for bf16 N not a
multiple of 8, P * N > 8192 or an operand not 16-byte aligned), which
``kernel.launch`` raises as a RuntimeError.  A ``meta`` tensor (the dry
run, ``launch.dryrun``) passes the same checks and refusals (``_refusal``,
which reads no data) and gets y and the bf16 workspace as meta tensors,
never the plain version.  ``ssd_scan.launches`` counts the calls that
launched the kernels; each, and each meta call in its place, reports
``cost``'s operations and bytes to the op recorder (``_trace``).
Training runs this forward inside ``models/mamba2.py``'s ``SSDTrain``,
whose backward is plain PyTorch.
"""
from __future__ import annotations

import torch

from ... import _trace
from . import kernel
from .ref import ssd_chunked

HEAD_DIMS = (16, 32, 64)
_INT_MAX = 2 ** 31 - 1
# csrc/ssd_scan.cu: the SIMT schedule's state per block (kMaxState *
# kThreads), its tile rows TQ and the shared memory it may take; the
# tensor-core schedule's P * N
_F32_MAX_PN, _F32_TQ, _F32_SMEM = 32 * 256, 64, 232448
_BF16_MAX_PN, _GRID_MAX = 8192, 65535


def cost(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         Bm: torch.Tensor, chunk: int):
    """(operations, bytes) of one call: C B^T over the causal half once
    per (batch row, chunk); per head the causal half of the weighted sum,
    C h^T and the state update; x, dt, A, B and C read once, y written
    once.  The count behind the kernel's ``bound_ms``."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc, tri = s // chunk, chunk * (chunk + 1) / 2
    ops = b * nc * (2.0 * tri * n + h * (2.0 * tri * p + 4.0 * chunk * n * p))
    nbytes = (2 * x.numel() * x.element_size() + 4 * (dt.numel() + A.numel())
              + 2 * Bm.numel() * Bm.element_size())
    return ops, nbytes


def _refusal(x: torch.Tensor, Bm: torch.Tensor, chunk: int):
    """Why the kernels refuse shapes that pass ``_check`` (None: they take
    them): ``csrc/ssd_scan.cu``'s ``launch_p`` of each schedule, bar the
    pointers' alignment."""
    b, s, h, p = x.shape
    n, nc = Bm.shape[-1], s // chunk
    if x.dtype == torch.float32:
        ln = n + 1
        smem = 4 * (p * ln + 2 * _F32_TQ * ln + _F32_TQ * p
                    + _F32_TQ * (_F32_TQ + 1) + 2 * chunk)
        if p * n > _F32_MAX_PN or smem > _F32_SMEM:
            return f"fp32 P*N={p * n} or {smem} B of shared memory"
        return None
    if n % 8 or p * n > _BF16_MAX_PN or nc > _GRID_MAX or \
            b * nc > _GRID_MAX or h > _GRID_MAX:
        return f"bf16 N={n}, P*N={p * n}, chunks {nc}, B*chunks {b * nc}"
    return None


def _report(x, dt, A, Bm, Cm, y, chunk: int) -> None:
    """One call to the op recorder: ``cost``, and the shapes and dtypes of
    the operands and y."""
    if _trace.sinks:
        ops, nbytes = cost(x, dt, A, Bm, chunk)
        tensors = (x, dt, A, Bm, Cm, y)
        _trace.emit({"kind": "kernel", "op": "ssd_scan", "flops": ops,
                     "bytes": nbytes, "dtype": str(x.dtype)[6:],
                     "shapes": [list(t.shape) for t in tensors],
                     "dtypes": [str(t.dtype)[6:] for t in tensors]})


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"need x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm "
                         f"(B,S,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape[:2] != (b, s):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"Bm {tuple(Bm.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim {p} not in {HEAD_DIMS}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0: the caller pads S "
                         f"to a multiple of the chunk with dt = 0")
    if x.numel() > _INT_MAX or Bm.numel() > _INT_MAX:
        raise ValueError(f"sizes out of range: x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm and Cm must share dtype float32 or bfloat16, "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, Bm and Cm must be contiguous")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             chunk: int = 256) -> torch.Tensor:
    """y (B, S, H, P) in ``x.dtype``, from a zero initial state.

    All five tensors on the CPU: the plain version.  All on one CUDA device:
    the kernel.  All on meta: y (and the bf16 workspace), unlaunched.
    Anything else raises.
    """
    devices = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devices) != 1:
        raise ValueError(f"x, dt, A, Bm and Cm must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk)[0]
    if x.device.type == "meta":
        _check(x, dt, A, Bm, Cm, chunk)
        why = _refusal(x, Bm, chunk)
        if why is not None:
            raise RuntimeError(f"ssd_scan kernel refuses {why}")
        y = torch.empty_like(x)
        if x.dtype == torch.bfloat16:
            torch.empty(kernel.workspace_layout(*x.shape, Bm.shape[-1], chunk),
                        dtype=torch.uint8, device=x.device)
        _report(x, dt, A, Bm, Cm, y, chunk)
        return y
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, dt, A, Bm, Cm, chunk)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        work = None
        if x.dtype == torch.bfloat16:
            work = torch.empty(kernel.workspace_bytes(*x.shape, Bm.shape[-1],
                                                      chunk),
                               dtype=torch.uint8, device=x.device)
        kernel.launch(x, dt, A, Bm, Cm, y, chunk, work)
    ssd_scan.launches += 1
    _report(x, dt, A, Bm, Cm, y, chunk)
    return y


ssd_scan.launches = 0
