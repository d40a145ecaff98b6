"""The head repetition and key mask that ``models.layers``' attention
branches and the decode kernel's plain version
(``kernels/decode_attention/ref.py``) share."""
from __future__ import annotations

import torch


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV * n_rep, hd) by head repetition (GQA)."""
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def key_mask(q_pos, kpos, causal: bool, kv_len,
             window: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: the keys at ``kpos`` that rows at ``q_pos`` keep
    (``models.layers.attention``'s mask on every branch but flash's)."""
    mask = torch.ones((q_pos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=kpos.device)
    if causal:
        mask &= q_pos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= q_pos[:, None] - kpos[None, :] < window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    return mask
