"""Straggler process simulation + expected step-time accounting.

Bridges the paper's service-time models to the runtime: samples per-worker
task completion times for a given redundancy plan, converts a step deadline
into an alive mask, and computes the expected step time of the
fractional-repetition coded step (max over part groups of the min over the
group's workers) -- the runtime's analogue of the paper's Y_{k:n}.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Tuple

import numpy as np

from .._device import DEFAULT_DEVICE, generator
from ..core.distributions import Scaling, ServiceTime
from ..core.policy import Policy
from ..core.scenario import Scenario, task_survival
from ..core import order_stats as osl


@dataclasses.dataclass
class StragglerSim:
    """Samples worker completion times for tasks of s CUs.

    Step ``step`` draws from a generator on ``device`` seeded
    ``seed * 1_000_003 + step``, so every step is reproducible on its own.
    """
    dist: ServiceTime
    scaling: Scaling
    n: int
    s: int                         # task size in CUs (parts per worker)
    delta: Optional[float] = None
    seed: int = 0
    device: str = DEFAULT_DEVICE

    def sample_times(self, step: int) -> np.ndarray:
        """(n,) task completion times (numpy; host-side path)."""
        gen = generator(self.seed * 1_000_003 + step, self.device)
        t = self.dist.sample_task(gen, (self.n,), self.s, self.scaling,
                                  delta=self.delta)
        return t.cpu().numpy()

    def alive_mask(self, step: int, deadline: float) -> np.ndarray:
        """Workers finished by the deadline."""
        return self.sample_times(step) <= deadline

    def alive_fn(self, deadline: float) -> Callable[[int], np.ndarray]:
        return lambda step: self.alive_mask(step, deadline)


# --------------------------------------------------------------------------
# FR-coded step completion time (the achievable gradient-code geometry, vs
# the paper's MDS order statistic)
# --------------------------------------------------------------------------

def fr_completion_survival(dist: ServiceTime, scaling: Scaling, n: int,
                           c: int, delta: Optional[float] = None,
                           device=DEFAULT_DEVICE):
    """Survival function of T = max_{g<=n/c} min_{i in group g} Y_i.

    Y is the task time of c parts (task size s = c CUs under the given
    scaling).  Pr{T > t} = 1 - (1 - S_Y(t)^c)^{n/c}.  The Pareto-additive
    task tail is a Monte-Carlo estimate drawn on ``device``.
    """
    if n % c:
        raise ValueError("c must divide n")
    g = n // c

    def surv(t: np.ndarray) -> np.ndarray:
        s = np.clip(task_survival(dist, scaling, c, t, delta, device),
                    0.0, 1.0)
        return 1.0 - (1.0 - s**c) ** g

    return surv


def fr_expected_completion(dist: ServiceTime, scaling: Scaling, n: int,
                           c: int, delta: Optional[float] = None,
                           device=DEFAULT_DEVICE) -> float:
    """E[T] for the FR-coded step by survival quadrature."""
    surv = fr_completion_survival(dist, scaling, n, c, delta, device)
    scale = max(dist.mean() * c, 1.0) if math.isfinite(dist.mean()) else 10.0 * c
    # reuse the generic quadrature with k=n=1 trick: surv already composed
    return osl.expected_order_stat(surv, 1, 1, lower=0.0, scale=scale)


def best_fr_policy(scenario: Scenario,
                   device=DEFAULT_DEVICE) -> Tuple[Policy, dict]:
    """(best policy, c-curve) for the FR gradient code on a scenario.

    Scores every legal policy with the FR-geometry objective through the
    planner and arg-mins on the c axis (ties -> smaller c, the legacy
    ``plan_fr`` convention).  ``max_c`` constraints are expressed as
    ``Scenario.max_task_size`` (c IS the task size).
    """
    from ..api import FRCompletionTime, Planner
    k_curve = Planner(FRCompletionTime(device=device)).curve(scenario)
    c_curve = {Policy(scenario.n, k).c: v for k, v in k_curve.items()}
    c_best = min(c_curve, key=lambda c: (c_curve[c], c))
    return Policy.from_c(scenario.n, c_best), c_curve


def plan_fr(dist: ServiceTime, scaling: Scaling, n: int,
            delta: Optional[float] = None,
            max_c: Optional[int] = None,
            device=DEFAULT_DEVICE) -> dict:
    """DEPRECATED shim: use ``Planner.plan(scenario, FRCompletionTime())``
    or ``best_fr_policy(scenario)``.

    Returns {"c": c*, "expected_time": E, "curve": {c: E_c}, "policy": ...}
    over divisors of n (c=1 splitting ... c=n replication).
    """
    warnings.warn(
        "runtime.straggler.plan_fr() is deprecated; use "
        "repro_torch.api.Planner.plan(Scenario(...), FRCompletionTime()) or "
        "runtime.straggler.best_fr_policy(Scenario(...)) instead",
        DeprecationWarning, stacklevel=2)
    scenario = Scenario(dist, scaling, n, delta=delta, max_task_size=max_c)
    policy, curve = best_fr_policy(scenario, device)
    return {"c": policy.c, "expected_time": curve[policy.c], "curve": curve,
            "policy": policy}
