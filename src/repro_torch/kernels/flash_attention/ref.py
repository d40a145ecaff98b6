"""Plain PyTorch version of the flash attention forward.

The port of the reference oracle ``flash_attention/ref.py::attention_ref``
on the model's own (B, S, H, D) layout, with GQA by indexing: q head h
attends with KV head h // (H / KV).  Scores, softmax and the weighted sum
are fp32; the output is cast to ``q.dtype``.  Causal rows sit at key
positions (Sk - Sq) + i, as in ``models/layers.py``'s attention.

This is the function the CUDA kernel is held to, and what the wrapper runs
for tensors on the CPU.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D); fp32 softmax."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    head = torch.arange(h, device=q.device) // (h // kv)
    k32 = k.float()[:, :, head]                          # (B, Sk, H, D)
    v32 = v.float()[:, :, head]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k32)
    if causal:
        qpos = (sk - sq) + torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits,
                             torch.full((), -1e30, device=q.device))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v32)
    return out.to(q.dtype)
