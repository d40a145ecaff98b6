"""Optimal diversity/parallelism planning (the paper's Sec. III-VI results).

Given a fitted CU service-time distribution, a scaling model, and n workers,
``plan()`` returns the k* minimizing E[Y_{k:n}] over the divisors of n
(task sizes must be integers, exactly as in the paper's figures), together
with the closed-form/theorem-predicted k* where one exists:

  * Thm. 1  S-Exp  x server-dep : k* = 1 (replication)
  * Thm. 2  S-Exp  x data-dep   : k* = n(-d/2 + sqrt(d + d^2/4)), d = Delta/W
  * Thm. 4/5 S-Exp x additive   : splitting beats replication (large n);
                                  rate-1/2 coding beats splitting when Delta=0
  * Thm. 6  Pareto x server-dep : k* = round((alpha n - 1)/(alpha + 1))
  * Sec.V-B Pareto x data-dep   : replication if Delta << E[X], splitting if >>
  * Thm. 7  Pareto x additive   : splitting beats replication (alpha > 4, large n)
  * Prop. 1/2, Thm. 8  Bi-Modal x server-dep : splitting if B <= 2;
      LLN: coding at r = 1-eps iff eps <= (B-1)/B else splitting
  * Thm. 9  Bi-Modal x data-dep : LLN: coding at r = 1-eps iff
      eps <= (B-1)/(Delta+B-1) else splitting

The exact arg-min over divisors is always computed as well — the theorem
prediction is advisory (and unit-tested to agree where the paper claims it).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Optional, Sequence

from .._device import DEFAULT_DEVICE
from .batched import divisors as batched_divisors
from .distributions import BiModal, Pareto, Scaling, ServiceTime, ShiftedExp

__all__ = ["Plan", "Strategy", "divisors", "plan", "plan_grid", "theorem_kstar",
           "strategy_table"]


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} (repro_torch.api) instead",
        DeprecationWarning, stacklevel=3)


def divisors(n: int) -> List[int]:
    """All positive divisors of n, ascending (legal k values)."""
    return batched_divisors(n)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The planner's decision for one (dist, scaling, n) problem."""

    n: int
    k: int                      # argmin over divisors of n
    expected_time: float        # E[Y_{k*:n}]
    strategy: str               # "replication" | "splitting" | "coding"
    code_rate: float            # k/n
    task_size: int              # s = n/k
    curve: dict                 # k -> E[Y_{k:n}] for all divisors
    theorem_k: Optional[float]  # closed-form k* where the paper gives one
    theorem_name: Optional[str]
    #: co-optimized task placement (None = all-workers fan-out; see
    #: ``api.Planner.co_plan``).  Excluded from the decision identity like
    #: Policy's field.
    assignment: Optional["Assignment"] = dataclasses.field(
        default=None, compare=False)

    @property
    def policy(self) -> "Policy":
        """The decision as the runtime's typed ``Policy`` (lossless k<->c;
        a co-optimized placement rides along on ``Policy.assignment``)."""
        from .policy import Policy
        return Policy(n=self.n, k=self.k, assignment=self.assignment)


class Strategy:
    REPLICATION = "replication"
    SPLITTING = "splitting"
    CODING = "coding"


def theorem_kstar(
    dist: ServiceTime, scaling: Scaling, n: int, delta: Optional[float] = None
):
    """The paper's closed-form/asymptotic k* prediction, if one exists.

    Returns (k_star_float_or_None, theorem_name_or_None).  k* may be
    fractional (continuous relaxation); the caller rounds to legal divisors.
    """
    if isinstance(dist, ShiftedExp):
        if scaling is Scaling.SERVER_DEPENDENT:
            return 1.0, "Thm1:replication"
        if scaling is Scaling.DATA_DEPENDENT:
            if dist.W == 0.0:
                return float(n), "Thm2:W=0->splitting"
            d = dist.delta / dist.W
            k = n * (-d / 2.0 + math.sqrt(d + d * d / 4.0))
            return min(max(k, 1.0), float(n)), "Thm2"
        return None, None  # additive: Thm 4/5 give orderings, not k*
    if isinstance(dist, Pareto):
        if scaling is Scaling.SERVER_DEPENDENT:
            k = (dist.alpha * n - 1.0) / (dist.alpha + 1.0)
            return min(max(k, 1.0), float(n)), "Thm6"
        return None, None
    if isinstance(dist, BiModal):
        if scaling is Scaling.SERVER_DEPENDENT:
            if dist.B <= 2.0:
                return float(n), "Prop1:splitting"
            # Thm 8 (LLN): coding at r=1-eps iff eps <= (B-1)/B
            if dist.eps <= (dist.B - 1.0) / dist.B:
                return (1.0 - dist.eps) * n, "Thm8:r=1-eps"
            return float(n), "Thm8:splitting"
        if scaling is Scaling.DATA_DEPENDENT:
            # explicit is-None check: delta=0.0 means "zero deterministic
            # work", not "unset" (the old ``delta or 0.0`` conflated them)
            d = 0.0 if delta is None else float(delta)
            if dist.eps <= (dist.B - 1.0) / (d + dist.B - 1.0):
                return (1.0 - dist.eps) * n, "Thm9:r=1-eps"
            return float(n), "Thm9:splitting"
        if dist.B <= 2.0:
            return float(n), "Prop2:splitting"
        return None, None
    return None, None


def plan(
    dist: ServiceTime,
    scaling: Scaling,
    n: int,
    delta: Optional[float] = None,
    candidate_ks: Optional[Sequence[int]] = None,
    max_task_size: Optional[int] = None,
    mc_trials: int = 100_000,
    mc_seed: int = 0,
    device=DEFAULT_DEVICE,
) -> Plan:
    """DEPRECATED shim: use ``repro_torch.api.Planner.plan(Scenario(...))``.

    Exact arg-min of E[Y_{k:n}] over legal k, with theorem annotation;
    delegates to the unified front door with the default mean objective
    (plans are bit-identical).
    """
    _deprecated("core.planner.plan()", "Planner.plan(Scenario(...))")
    from ..api import MeanCompletionTime, Planner, Scenario
    scenario = Scenario(
        dist, scaling, n, delta=delta, max_task_size=max_task_size,
        candidate_ks=None if candidate_ks is None else tuple(candidate_ks))
    return Planner(MeanCompletionTime(
        mc_trials=mc_trials, mc_seed=mc_seed, device=device)).plan(scenario)


def plan_grid(
    dists: Sequence[ServiceTime],
    scaling: Scaling,
    n: int,
    delta: Optional[float] = None,
    mc: bool = False,
    trials: int = 20_000,
    seed: int = 0,
    device=DEFAULT_DEVICE,
) -> List[Plan]:
    """DEPRECATED shim: use ``repro_torch.api.Planner.sweep([Scenario(...), ...])``.

    ``mc=False`` (default): each scenario's k-curve comes from the batched
    analytic engine -- the production planner's many-scenario hot path.
    ``mc=True``: the ENTIRE grid's curves are estimated from one shared
    base sample with common random numbers, drawn on ``device``.
    """
    _deprecated("core.planner.plan_grid()", "Planner.sweep(scenarios)")
    from ..api import MeanCompletionTime, Planner, Scenario
    scenarios = [Scenario(d, scaling, n, delta=delta) for d in dists]
    return Planner(MeanCompletionTime(mc=mc, trials=trials, seed=seed,
                                      device=device)).sweep(scenarios)


def strategy_table(n: int = 12, mc: bool = False, trials: int = 20_000,
                   device=DEFAULT_DEVICE) -> dict:
    """Reproduce the qualitative structure of the paper's Table I.

    For each (PDF, scaling) we sweep the straggling knob from light to heavy
    and report the sequence of optimal strategies; arrows in the paper's
    table correspond to changes along each sweep.  Each sweep goes through
    ``repro_torch.api.Planner.sweep``; with ``mc=True`` every (family,
    scaling) block is one shared-sample Monte-Carlo grid on ``device``.
    """
    sweeps = {
        ("shifted_exp", "server"): [ShiftedExp(1.0, w) for w in (0.1, 1.0, 5.0, 10.0)],
        ("shifted_exp", "data"): [ShiftedExp(10.0, 0.5), ShiftedExp(10.0, 1.0),
                                  ShiftedExp(5.0, 5.0), ShiftedExp(1.0, 10.0),
                                  ShiftedExp(0.0, 10.0)],
        ("shifted_exp", "additive"): [ShiftedExp(10.0, 1.0), ShiftedExp(5.0, 5.0),
                                      ShiftedExp(1.0, 10.0), ShiftedExp(0.0, 10.0)],
        ("pareto", "server"): [Pareto(1.0, a) for a in (5.0, 3.0, 2.0, 1.5)],
        ("pareto", "data"): [Pareto(1.0, a) for a in (5.0, 3.0, 2.0, 1.5)],
        ("pareto", "additive"): [Pareto(1.0, a) for a in (5.0, 3.0, 2.0, 1.3)],
        ("bimodal", "server"): [BiModal(10.0, e) for e in (0.005, 0.2, 0.6, 0.9)],
        ("bimodal", "data"): [BiModal(10.0, e) for e in (0.05, 0.2, 0.5, 0.9)],
        ("bimodal", "additive"): [BiModal(10.0, e) for e in (0.005, 0.2, 0.6, 0.9)],
    }
    scalings = {
        "server": Scaling.SERVER_DEPENDENT,
        "data": Scaling.DATA_DEPENDENT,
        "additive": Scaling.ADDITIVE,
    }
    from ..api import MeanCompletionTime, Planner, Scenario
    planner = Planner(MeanCompletionTime(mc=mc, trials=trials, device=device))
    table = {}
    for (fam, sc), dists in sweeps.items():
        delta = 5.0 if (fam in ("pareto", "bimodal") and sc == "data") else None
        plans = planner.sweep(
            [Scenario(d, scalings[sc], n, delta=delta) for d in dists])
        seq = [p.strategy for p in plans]
        # collapse consecutive repeats: "splitting -> coding -> splitting"
        collapsed = [seq[0]]
        for x in seq[1:]:
            if x != collapsed[-1]:
                collapsed.append(x)
        table[(fam, sc)] = collapsed
    return table
