"""Plain PyTorch version of the fused MDS-encode matmul.

The paper's exemplar job (Fig. 2): A (split into k row-blocks) times X,
dispatched as n MDS-coded tasks.  Coded task i computes
    C_i = (sum_j G[i, j] A_j) @ X = sum_j G[i, j] (A_j @ X).

This is the mathematical spec the CUDA kernel is held to: encode in fp32,
multiply in fp32, cast to ``A.dtype``.
"""
from __future__ import annotations

import torch


def coded_matmul_ref(G: torch.Tensor, A: torch.Tensor,
                     X: torch.Tensor) -> torch.Tensor:
    """G (n, k), A (k, M, K) row-blocks, X (K, N) -> C (n, M, N)."""
    Ae = torch.einsum("ij,jmk->imk", G.to(torch.float32), A.to(torch.float32))
    return torch.einsum("imk,kn->imn", Ae, X.to(torch.float32)).to(A.dtype)
