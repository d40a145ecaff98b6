"""Elastic scaling: re-derive the redundancy plan when workers join or
leave, without touching the model (a port of the JAX package's
``runtime/elastic.py``).

On a resize the driver (1) checkpoints or keeps the host copy, (2)
restores onto the new device layout (``checkpoint.restore(...,
device=)``), (3) asks this module for a new coded-step config consistent
with the new worker count, and (4) resumes.  Node failure is the special
case "shrink by the dead nodes": the planner treats permanent failure as
Bi-Modal straggling with B -> inf (a worker that never finishes), which
drives the optimal plan toward more redundancy (Sec. VI of the paper).
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

from .._device import DEFAULT_DEVICE
from ..core.distributions import BiModal, Scaling, ServiceTime
from ..core.policy import Policy
from ..core.scenario import Scenario
from .coded_step import CodedStepConfig
from .straggler import best_fr_policy

logger = logging.getLogger(__name__)


def round_unique_batch(unique_batch: int, num_groups: int) -> Tuple[int, int]:
    """Round ``unique_batch`` UP to a multiple of ``num_groups``.

    The coded step splits the unique batch over the k part groups, so the
    batch must divide evenly.  Returns ``(rounded, adjustment)`` with
    ``adjustment = rounded - unique_batch`` (0 when no rounding happened)
    — the single rounding contract shared by ``resize_plan`` and the
    control loop's trainer actuator, so a silent global-batch change can
    never hide: callers get the adjustment back and this module logs it.
    """
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    rem = unique_batch % num_groups
    rounded = unique_batch if rem == 0 else unique_batch + (num_groups - rem)
    return rounded, rounded - unique_batch


def resize_plan(old: CodedStepConfig, new_n: int,
                dist: Optional[ServiceTime] = None,
                scaling: Scaling = Scaling.DATA_DEPENDENT,
                delta: Optional[float] = None,
                keep_unique_batch: bool = True,
                device=DEFAULT_DEVICE) -> CodedStepConfig:
    """A coded-step config for ``new_n`` workers.

    Re-plans the policy for the fitted service model on the new n (falls
    back to the legal policy nearest the old replication fraction c/n).
    The unique batch is kept so the optimization trajectory is unchanged
    across resizes — EXCEPT when it does not divide the new group count:
    it is then rounded up to the next multiple (``round_unique_batch``),
    which changes the global batch; the adjustment is logged here and
    visible to callers as ``result.unique_batch - old.unique_batch``.
    ``device``: where the planner draws its Monte-Carlo tails (Pareto
    under additive scaling only).
    """
    if dist is not None:
        policy, _ = best_fr_policy(Scenario(dist, scaling, new_n, delta=delta),
                                   device)
    else:
        policy = Policy.nearest_legal(new_n, old.c / old.n_workers,
                                      axis="replication")
    unique = old.unique_batch if keep_unique_batch else \
        old.unique_batch * new_n // old.n_workers
    unique, adjustment = round_unique_batch(unique, policy.num_groups)
    if adjustment:
        logger.warning(
            "resize_plan: unique_batch %d does not split over %d part "
            "groups; rounded up to %d (global batch grows by %d)",
            unique - adjustment, policy.num_groups, unique, adjustment)
    return CodedStepConfig.from_policy(policy, unique_batch=unique)


def failure_adjusted_model(eps_fail: float, base_eps: float = 0.05,
                           B: float = 100.0) -> BiModal:
    """Service model that folds permanent node failure into straggling.

    A failed node is a straggler of unbounded magnitude; numerically we cap
    B (the planner's optima are insensitive to B beyond ~100x, cf. paper
    Fig. 12).  eps = P(slow or dead).
    """
    eps = min(base_eps + eps_fail, 1.0)
    return BiModal(B=B, eps=eps)
