"""Plain PyTorch version of the decode attention: ``models.layers``'
one-query-row branch as it was before the kernel (``_attend_row``).

The port of the reference's ``attention`` at one query row
(``src/repro/models/layers.py``, ``sq == 1``): the KV heads repeated to
the query heads (GQA: q head h reads KV head h // (H / KV)), then one
dense fp32 pass over every key of the cache: scores of ``q.float()``
scaled by 1/sqrt(D), the mask (causal at ``q_offset``, the sliding
``window`` under ``causal``, keys below ``kv_len``) as -1e30, softmax, and
p . v, cast to ``q.dtype``.

This is the function the CUDA kernel is held to, and what the wrapper runs
for tensors on the CPU and on meta (the dry run traces it).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...models._attn_mask import key_mask, repeat_kv

_NEG = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, q_offset: int, kv_len: Optional[int],
                         window: int) -> torch.Tensor:
    """q (B, 1, H, D), k/v (B, Sk, KV, D) -> (B, 1, H, D) in q's dtype:
    the KV heads repeated to the query heads, then one dense fp32 pass
    over the keys (scores, mask, softmax, p . v)."""
    sk, hd = k.shape[1], q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    q_pos = int(q_offset) + torch.arange(1, device=q.device)
    neg = torch.full((), _NEG, dtype=torch.float32, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(hd)),
                     k.float())
    kpos = torch.arange(sk, device=q.device)
    s = torch.where(key_mask(q_pos, kpos, causal, kv_len, window)[None, None],
                    s, neg)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.transpose(1, 2).to(q.dtype)
