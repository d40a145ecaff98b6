"""The reference's readings of served tokens: the logits of the same
prompts and tokens, fp32, row by row and in blocks of positions."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..spec import Spec
from .model import decode_over_prefix, hidden, logits
from .numerics import Numerics

POS_BLOCK = 2048


@torch.no_grad()
def decode(spec: Spec, P, tokens: torch.Tensor, p_lo: int,
           prefix_kv: Callable, precision: str = "fp32"):
    """(logits (B, T, V) fp32, k and v at the T positions) of the spec's
    family fed ``tokens`` after the KV cache prefix."""
    num = Numerics(precision)
    h, k, v = decode_over_prefix(spec, num, P, tokens, p_lo, prefix_kv)
    return logits(num, P, h), k, v


@torch.no_grad()
def prefill_row(spec: Spec, P, tokens: torch.Tensor, served: torch.Tensor,
                sample: torch.Tensor, precision: str = "fp32") -> Dict:
    """One row's readings: tokens (S,) prompt, served (S,) the token the
    program puts first at each position, sample (k,) positions whose
    logits are kept.  Returns the largest logit at each position, the
    logit of the served token, the top token, and the sampled logits."""
    num = Numerics(precision)
    h = hidden(spec, num, P, tokens[None])[0]
    best, at_served, top = [], [], []
    for lo in range(0, h.shape[0], POS_BLOCK):
        lg = logits(num, P, h[lo:lo + POS_BLOCK])
        mx, arg = lg.max(dim=-1)
        best.append(mx)
        top.append(arg)
        at_served.append(lg.gather(-1, served[lo:lo + POS_BLOCK, None])[:, 0])
    sampled = logits(num, P, h[sample])
    return {"best": torch.cat(best), "served": torch.cat(at_served),
            "top": torch.cat(top), "sampled": sampled}
