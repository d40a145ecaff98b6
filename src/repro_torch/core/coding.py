"""Erasure codes for redundant task dispatch (Sec. II-B of the paper).

Two code families, matching the two kinds of distributed jobs the framework
runs:

1. LINEAR jobs (the paper's own exemplar, Fig. 2: coded mat-vec / mat-mul).
   The job's data (e.g. matrix rows) is split into k blocks and encoded by a
   real-valued [n, k] MDS generator; each coded task is the SAME size s=n/k
   as an uncoded one, and any k of the n task outputs decode the job.  This
   is exactly the paper's model: job completion time = Y_{k:n}.

   * ``mds_generator(n, k)``   systematic, any-k-of-n invertible (Chebyshev-
     node Vandermonde, conditioned for real arithmetic)
   * ``decode_matrix(G, S)``   inverse of the surviving k x k submatrix
   * ``encode_blocks / decode_blocks``  block-level encode/decode on the
     device of the blocks (torch)

2. GRADIENT jobs (training steps).  Per-part gradients cannot be encoded in
   the data domain (nonlinear), so the achievable geometry is gradient
   coding (Tandon et al., ICML'17 -- the paper's ref. [16]): n data parts on
   n workers, each part replicated on c workers; any k = n - c + 1 workers
   decode the exact gradient sum.  Task size is s = c = n - k + 1 parts
   (Singleton-type bound), vs. the linear-job s = n/k.  The planner handles
   both geometries (see planner/runtime).

   * ``fractional_repetition_code(n, c)``  assignment B (n x n, 0/1) + group
     structure; decode = pick one finisher per group (coefficients 0/1 --
     numerically exact, no float cancellation)
   * ``gc_decode_weights(groups, alive)``  per-worker decode coefficients
     a_i for a masked weighted all-reduce (a_i = 0 for stragglers)

Replication and splitting are the k=1 / k=n degenerate members of both
families, so every strategy in the paper is one interface.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "mds_generator",
    "decode_matrix",
    "encode_blocks",
    "decode_blocks",
    "FractionalRepetitionCode",
    "fractional_repetition_code",
    "gc_decode_weights",
    "task_size_linear",
    "task_size_gradient",
]


# --------------------------------------------------------------------------
# Real-valued MDS codes for linear jobs
# --------------------------------------------------------------------------

def _vandermonde(nodes: np.ndarray, k: int) -> np.ndarray:
    return np.vander(nodes, N=k, increasing=True)


def mds_generator(n: int, k: int, dtype=np.float32) -> np.ndarray:
    """Systematic real [n, k] MDS generator: G = V @ V_sys^{-1}.

    Uses Chebyshev nodes on [-1, 1]; any k rows of a Vandermonde matrix at
    distinct nodes are invertible, and the systematic transform preserves
    that (row space is unchanged).  The k SYSTEMATIC nodes are chosen
    spread across [-1, 1] (not the first k, which cluster near +1 and make
    extrapolation weights blow up): parity rows then interpolate rather
    than extrapolate, keeping G well-conditioned in fp32.
    """
    if not (1 <= k <= n):
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    nodes = np.cos((2 * np.arange(n) + 1) / (2 * n) * np.pi)  # distinct
    sys_idx = np.unique(np.round(np.linspace(0, n - 1, k)).astype(int))
    assert len(sys_idx) == k
    rest = np.array([i for i in range(n) if i not in set(sys_idx.tolist())],
                    dtype=int)
    order = np.concatenate([sys_idx, rest])
    V = _vandermonde(nodes[order], k).astype(np.float64)
    G = V @ np.linalg.inv(V[:k])
    # clean the systematic part exactly
    G[:k] = np.eye(k)
    return G.astype(dtype)


def decode_matrix(G: np.ndarray, survivors: Sequence[int]) -> np.ndarray:
    """D such that D @ G[survivors] = I_k; requires exactly k survivors."""
    S = list(survivors)
    k = G.shape[1]
    if len(S) != k:
        raise ValueError(f"need exactly k={k} survivors, got {len(S)}")
    sub = np.asarray(G, dtype=np.float64)[S]
    return np.linalg.inv(sub).astype(G.dtype)


def encode_blocks(G, blocks: torch.Tensor) -> torch.Tensor:
    """Coded blocks: C[i] = sum_j G[i, j] * blocks[j].

    ``blocks``: (k, *block_shape) tensor.  Returns (n, *block_shape) on the
    blocks' device.  The plain reference; the fused kernel lives in
    kernels/coded_matmul.
    """
    G = torch.as_tensor(G, dtype=blocks.dtype, device=blocks.device)
    return torch.tensordot(G, blocks, dims=([1], [0]))


def decode_blocks(G, survivors, coded_blocks: torch.Tensor) -> torch.Tensor:
    """Recover the k original blocks from any k coded task outputs.

    The k x k inverse is taken on the host in float64 (``decode_matrix``);
    applying it is one product on the coded blocks' device.
    """
    if isinstance(G, torch.Tensor):
        G = G.detach().cpu().numpy()
    D = decode_matrix(np.asarray(G), survivors)
    D = torch.as_tensor(D, dtype=coded_blocks.dtype,
                        device=coded_blocks.device)
    return torch.tensordot(D, coded_blocks, dims=([1], [0]))


# --------------------------------------------------------------------------
# Gradient coding (fractional repetition) for training jobs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FractionalRepetitionCode:
    """n workers in g = n/c groups of c; group j computes data-part-group j.

    Worker i returns the sum of its group's part gradients.  Any set of
    workers covering every group decodes exactly; tolerating any c-1
    stragglers, i.e. completion at k = n - c + 1 finishers in the worst
    case, and often earlier (first finisher per group).
    """

    n: int
    c: int  # replication factor = task size in parts

    def __post_init__(self):
        if self.n % self.c != 0:
            raise ValueError(f"c={self.c} must divide n={self.n}")

    @property
    def num_groups(self) -> int:
        return self.n // self.c

    @property
    def k(self) -> int:
        """Worst-case finishers needed: n - c + 1."""
        return self.n - self.c + 1

    def group_of(self, worker: int) -> int:
        return worker // self.c

    def assignment(self) -> np.ndarray:
        """B (n x num_groups) 0/1: worker i computes part-group B[i] != 0."""
        B = np.zeros((self.n, self.num_groups), dtype=np.float32)
        for i in range(self.n):
            B[i, self.group_of(i)] = 1.0
        return B


def fractional_repetition_code(n: int, c: int) -> FractionalRepetitionCode:
    return FractionalRepetitionCode(n=n, c=c)


def gc_decode_weights(code: FractionalRepetitionCode, alive: np.ndarray) -> np.ndarray:
    """Decode coefficients a (n,) s.t. sum_i a_i * out_i = full gradient.

    ``alive``: bool (n,) -- workers that finished (non-stragglers).  Picks the
    lowest-index finisher per group (coefficient 1), zeros elsewhere.  Raises
    if some group has no finisher (more than c-1 stragglers hit one group):
    callers fall back to waiting/restart -- this is the fault-tolerance path.
    """
    alive = np.asarray(alive, dtype=bool)
    if alive.shape != (code.n,):
        raise ValueError(f"alive must be shape ({code.n},)")
    # groups are contiguous: one reshape + per-row argmax replaces the
    # per-group Python loop (argmax of a bool row = lowest-index finisher)
    by_group = alive.reshape(code.num_groups, code.c)
    has_finisher = by_group.any(axis=1)
    if not has_finisher.all():
        g = int(np.argmin(has_finisher))
        raise RuntimeError(
            f"group {g} has no finisher; job cannot decode "
            f"(needs restart or re-plan)"
        )
    first = by_group.argmax(axis=1)
    a = np.zeros(code.n, dtype=np.float32)
    a[np.arange(code.num_groups) * code.c + first] = 1.0
    return a


# --------------------------------------------------------------------------
# Task-size geometries (used by the planner)
# --------------------------------------------------------------------------

def task_size_linear(k: int, n: int) -> int:
    """Linear/MDS jobs: s = n/k (the paper's geometry)."""
    if n % k:
        raise ValueError(f"k={k} must divide n={n}")
    return n // k


def task_size_gradient(k: int, n: int) -> int:
    """Gradient-coding jobs: s = c = n - k + 1 (Singleton-type bound).

    Legal only when c divides n for the fractional-repetition construction.
    """
    c = n - k + 1
    if n % c:
        raise ValueError(f"c={c}=n-k+1 must divide n={n} for FR codes")
    return c
