"""Plain PyTorch version of the flash attention forward.

The port of the reference oracle ``flash_attention/ref.py::attention_ref``
on the model's own (B, S, H, D) layout, with GQA by indexing: q head h
attends with KV head h // (H / KV).  Scores, softmax and the weighted sum
are fp32; the output is cast to ``q.dtype``.  Causal rows sit at key
positions (Sk - Sq) + i, as in ``models/layers.py``'s attention.  A
sliding ``window`` > 0 under ``causal`` keeps key j for that row iff
0 <= (Sk - Sq + i) - j < window (the reference's ``_block_mask``,
``models/layers.py:197-203``); without ``causal`` it is ignored, as there.

This is the function the CUDA kernel is held to, and what the wrapper runs
for tensors on the CPU.  ``attention_lse_ref`` also returns the rows'
log-sum-exp, the second output of the training path's forward.
"""
from __future__ import annotations

import math

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: int = 0) -> torch.Tensor:
    """fp32 scores (B, H, Sq, Sk) of q against k, scaled, causally masked
    (and to the window under ``causal``)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    head = torch.arange(h, device=q.device) // (h // kv)
    k32 = k.float()[:, :, head]                          # (B, Sk, H, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k32)
    if causal:
        qpos = (sk - sq) + torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
            # the diagonal is always kept: no row is fully masked
            assert bool(mask.any(dim=1).all()), "a fully masked row"
        logits = torch.where(mask[None, None], logits,
                             torch.full((), -1e30, device=q.device))
    return logits


def _weighted_sum(p: torch.Tensor, v: torch.Tensor, h: int) -> torch.Tensor:
    """(B, Sq, H, D) fp32 sum of v's rows (KV head h // (H / KV)) by p."""
    head = torch.arange(h, device=v.device) // (h // v.shape[2])
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()[:, :, head])


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D); fp32 softmax."""
    logits = _scores(q, k, causal, window)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return _weighted_sum(p, v, q.shape[2]).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0):
    """(o, lse): ``attention_ref``'s output and the rows' log-sum-exp
    (B, H, Sq) fp32 in the scaled units of the scores, the ``lse`` that
    the reference's ``_flash_fwd_scan`` returns."""
    logits = _scores(q, k, causal, window)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    return _weighted_sum(p, v, q.shape[2]).to(q.dtype), lse
