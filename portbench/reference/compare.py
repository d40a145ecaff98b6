"""The numbers that decide ``correct``, each the widest gap of the
program's readings from the reference's (see PERF.md for the limits and
the readings they were set from)."""
from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

#: a leaf whose first gradient in the reference is under this share of
#: the median leaf's is nought to rounding: its change under AdamW is
#: round-off, and it is left out of the change
NOUGHT = 1e-3


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep) -> float:
    floor = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in keep)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the widest relative gap of a step's loss; grad_gap: of a
    leaf's first-gradient norm; change_gap: of a leaf's change after the
    steps.  A leaf's gap is over the larger of its reference norm and the
    median leaf's."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                        ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    g_ref = ref["grad1"]
    floor = statistics.median(g_ref.values())
    keep = [n for n, g in g_ref.items() if g >= NOUGHT * floor]
    return {"loss_gap": loss_gap,
            "grad_gap": _norm_gap(prog["grad1"], g_ref, keep),
            "change_gap": _norm_gap(prog["change"], ref["change"], keep)}


def token_gap(best: torch.Tensor, at_served: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at that position."""
    return float((best - at_served).max())


def row_error(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest relative error of a row (the last two axes, KV x hd)."""
    p, r = prog.float().flatten(-2), ref.float().flatten(-2)
    return float(((p - r).norm(dim=-1) / r.norm(dim=-1)).max())


def logit_error(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest absolute gap of a logit over the largest reference
    logit's magnitude."""
    return float((prog.float() - ref).abs().max() / ref.abs().max())
