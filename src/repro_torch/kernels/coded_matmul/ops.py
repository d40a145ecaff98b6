"""Public wrapper for the fused MDS-encode matmul.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the Hopper kernel (``kernel.py``), after the checks below, or raises.
``coded_matmul.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import coded_matmul_ref

_INT_MAX = 2 ** 31 - 1


def _check(G: torch.Tensor, A: torch.Tensor, X: torch.Tensor) -> None:
    if G.dim() != 2 or A.dim() != 3 or X.dim() != 2:
        raise ValueError(f"need G (n, k), A (k, M, K), X (K, N); got shapes "
                         f"{tuple(G.shape)}, {tuple(A.shape)}, "
                         f"{tuple(X.shape)}")
    (n, k), (k2, M, K), (K2, N) = G.shape, A.shape, X.shape
    if k != k2 or K != K2:
        raise ValueError(f"shape mismatch: G {tuple(G.shape)}, "
                         f"A {tuple(A.shape)}, X {tuple(X.shape)}")
    if min(n, k, M, K, N) < 1 or max(n, k, M, K, N) > _INT_MAX:
        raise ValueError(f"every dimension must be in [1, 2^31): "
                         f"n={n} k={k} M={M} K={K} N={N}")
    if A.dtype not in (torch.float32, torch.bfloat16) or X.dtype != A.dtype:
        raise TypeError(f"A and X must share dtype float32 or bfloat16, got "
                        f"{A.dtype} and {X.dtype}")
    if not G.is_floating_point():
        raise TypeError(f"G must be floating point, got {G.dtype}")
    if not (A.is_contiguous() and X.is_contiguous()):
        raise ValueError("A and X must be contiguous")


def coded_matmul(G: torch.Tensor, A: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """C (n, M, N) with C_i = sum_j G[i,j] (A_j @ X), in ``A.dtype``.

    All three tensors on the CPU: the plain version.  All three on one
    CUDA device: the kernel.  Anything else raises.
    """
    devices = {G.device, A.device, X.device}
    if len(devices) != 1:
        raise ValueError(f"G, A and X must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if A.device.type == "cpu":
        return coded_matmul_ref(G, A, X)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    _check(G, A, X)
    n, k = G.shape
    _, M, _ = A.shape
    N = X.shape[1]
    G32 = G.to(torch.float32).contiguous()
    C = torch.empty((n, M, N), dtype=A.dtype, device=A.device)
    P = torch.empty((k, M, N), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        kernel.launch(G32, A, X, C, P)
    coded_matmul.launches += 1
    return C


coded_matmul.launches = 0
