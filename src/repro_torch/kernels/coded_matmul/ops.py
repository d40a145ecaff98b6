"""Public wrapper for the fused MDS-encode matmul.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the Hopper kernel (``kernel.py``), after the checks below, or raises.
``coded_matmul.launches`` counts the kernel launches.  ``split_count`` and
``split_ranges`` are the host half of the kernel's N > 8 schedule: how many
slices of the K range its grid takes, and where each begins and ends.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from . import kernel
from .ref import coded_matmul_ref

_INT_MAX = 2 ** 31 - 1
# csrc/coded_matmul.cu: the GEMM's output tile and depth, and the widest N
# that takes the GEMV
BM, BN, BK = 128, 128, 16
SKINNY_N = 8
H100_SMS = 132
# the least share of the busiest SMs' block count that the average SM gets
MIN_FILL = 0.9


def split_count(rows: int, K: int, N: int, sms: int = H100_SMS) -> int:
    """Slices of the K range for a (rows x K) @ (K x N) phase 1 on ``sms``
    SMs.  N <= SKINNY_N takes the GEMV: one slice.  Otherwise the fewest
    slices, each at least BK deep, that give the grid at least two blocks
    per SM and keep the SMs level: blocks that share an SM share its
    throughput, so the time goes as the most blocks any SM runs, and the
    average SM must run at least MIN_FILL of that.  Up to four times the
    least count is tried; if none is level enough, the most level one is
    taken.  Where K is too short for two blocks per SM: one slice per BK."""
    if N <= SKINNY_N:
        return 1
    tiles = math.ceil(rows / BM) * math.ceil(N / BN)
    most = math.ceil(K / BK)
    least = min(most, math.ceil(2 * sms / tiles))

    def fill(s: int) -> float:
        blocks = tiles * s
        return blocks / (math.ceil(blocks / sms) * sms)

    tried = range(least, min(most, 4 * least) + 1)
    for s in tried:
        if fill(s) >= MIN_FILL:
            return s
    return max(tried, key=lambda s: (fill(s), -s))


def split_ranges(K: int, splits: int) -> List[Tuple[int, int]]:
    """[begin, end) of each K slice: the ceil(K / BK) BK-deep slices shared
    out as evenly as whole slices allow (the kernel's ``split_begin``)."""
    nblk = math.ceil(K / BK)
    if not 1 <= splits <= nblk:
        raise ValueError(f"need 1 <= splits <= ceil(K / {BK}) = {nblk}, "
                         f"got {splits}")
    begins = [s * nblk // splits * BK for s in range(splits)]
    return list(zip(begins, begins[1:] + [K]))


def cost(G: torch.Tensor, A: torch.Tensor, X: torch.Tensor):
    """(operations, bytes) of one call: 2*k*M*K*N + 2*n*k*M*N operations
    (the product with the k source blocks, then the encode); G, A and X
    read once, C (n, M, N) written once.  The count behind the kernel's
    ``bound_ms``."""
    n, k = G.shape
    _, M, K = A.shape
    N = X.shape[1]
    nbytes = G.numel() * G.element_size() + (A.numel() + X.numel()
                                             + n * M * N) * A.element_size()
    return 2.0 * k * M * K * N + 2.0 * n * k * M * N, nbytes


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
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    splits = split_count(k * M, A.shape[2], N, sms)
    C = torch.empty((n, M, N), dtype=A.dtype, device=A.device)
    P = torch.empty((splits, k, M, N), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        kernel.launch(G32, A, X, C, P)
    coded_matmul.launches += 1
    return C


coded_matmul.launches = 0
