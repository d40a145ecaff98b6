"""The Scenario/Policy front door: one typed API from the planner to the
coded job.

  * ``Scenario``  — the frozen problem statement (dist, scaling, n, delta,
                    constraints).
  * ``Policy``    — the frozen decision (n, k) with lossless k<->c
                    conversion for the runtime.
  * ``Objective`` — a pluggable protocol mapping a scenario to a k-curve.
                    ``MeanCompletionTime`` wraps the batched analytic
                    engine (core.batched via core.expectations);
                    ``QuantileCompletionTime(p)`` inverts the order-statistic
                    CDF for tail-aware planning; ``FRCompletionTime`` scores
                    the achievable fractional-repetition geometry the coded
                    training step actually runs; ``LoadAwareLatency``
                    runs the queueing simulation — by default on the
                    batched lane engine (``runtime.cluster_batched``, one
                    engine call per curve or per whole load surface), with
                    ``backend="oracle"`` as the discrete-event escape
                    hatch.
  * ``Planner``   — the facade: ``plan(scenario)``, ``curve(scenario)``,
                    ``sweep(scenarios)``, ``kstar_vs_load(scenario,
                    loads)`` — the whole load-aware k* map in one engine
                    call — and the (k, assignment) co-planners ``co_plan``
                    and ``co_kstar_vs_load``.

The analytic curves are numpy on the host.  Every objective carries a
``device`` (default ``"cuda"``) that receives its draws — the Monte-Carlo
mean objective, the Pareto-additive task tail and the queueing lanes —
and a curve asked of an objective whose device this machine does not
have raises.

    >>> from repro_torch.api import Planner, Scenario
    >>> from repro_torch.core import BiModal, Scaling
    >>> plan = Planner().plan(Scenario(BiModal(10.0, 0.3),
    ...                                Scaling.SERVER_DEPENDENT, n=12))
    >>> plan.policy.k, plan.policy.c, plan.strategy       # doctest: +SKIP
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from ._device import DEFAULT_DEVICE, resolve
from .assign.strategies import (AllWorkers, Assignment, RandomGroups,
                                ReplicationGroups, RoundRobin, SpeedAware)
from .core.batched import binom_lt_curves
from .core.expectations import completion_curve
from .core.planner import Plan, theorem_kstar
from .core.policy import Policy
from .core.scenario import (ArrivalProcess, DeterministicArrivals,
                            MMPPArrivals, PoissonArrivals, Scenario)
from .runtime.cluster_batched import Infeasible, InfeasibleSurfaceError

__all__ = [
    "Scenario", "Policy", "Plan", "Objective",
    "MeanCompletionTime", "QuantileCompletionTime", "LoadAwareLatency",
    "FRCompletionTime", "Planner", "Infeasible", "InfeasibleSurfaceError",
    "ArrivalProcess", "PoissonArrivals", "DeterministicArrivals",
    "MMPPArrivals",
    "Assignment", "AllWorkers", "ReplicationGroups", "RoundRobin",
    "RandomGroups", "SpeedAware",
]


# --------------------------------------------------------------------------
# The objective protocol
# --------------------------------------------------------------------------

@runtime_checkable
class Objective(Protocol):
    """Maps a scenario to the curve k -> cost; the planner arg-mins it."""

    name: str

    def curve(self, scenario: Scenario, ks: Sequence[int]) -> Dict[int, float]:
        """Cost of every candidate k (lower is better)."""
        ...


@dataclasses.dataclass(frozen=True)
class MeanCompletionTime:
    """E[Y_{k:n}] — the paper's objective, on the batched analytic engine.

    ``mc=True`` estimates the curve by the common-random-number Monte-Carlo
    simulator on ``device`` instead.  ``mc_trials``/``mc_seed``
    parameterize the deterministic numpy Monte-Carlo the analytic engine
    itself uses for Pareto-additive (paper Fig. 9).
    """

    mc: bool = False
    trials: int = 20_000
    seed: int = 0
    mc_trials: int = 100_000
    mc_seed: int = 0
    name: str = "mean_completion_time"
    device: str = DEFAULT_DEVICE

    def curve(self, scenario: Scenario, ks: Sequence[int]) -> Dict[int, float]:
        device = resolve(self.device)
        if self.mc:
            from .core.simulator import completion_curve_mc
            return completion_curve_mc(
                scenario.dist, scenario.scaling, scenario.n, ks=list(ks),
                trials=self.trials, seed=self.seed, delta=scenario.delta,
                device=device)
        return completion_curve(
            scenario.dist, scenario.scaling, scenario.n, ks=list(ks),
            delta=scenario.delta, mc_trials=self.mc_trials,
            mc_seed=self.mc_seed)


@dataclasses.dataclass(frozen=True)
class QuantileCompletionTime:
    """The p-quantile of Y_{k:n}, from the order-statistic CDF.

    Pr{Y_{k:n} > t} = Pr{Binom(n, F_Y(t)) < k} with F_Y the task-time CDF
    at task size s = n/k (core.scenario.task_survival); the quantile is the
    smallest t with that survival <= 1-p, found by bracketed bisection.
    """

    p: float = 0.99
    tol: float = 1e-10
    name: str = "quantile_completion_time"
    device: str = DEFAULT_DEVICE

    def __post_init__(self):
        if not (0.0 < self.p < 1.0):
            raise ValueError(f"p must be in (0, 1), got {self.p}")

    def _order_stat_survival(self, scenario: Scenario, k: int,
                             t: np.ndarray) -> np.ndarray:
        s = scenario.n // k
        S = np.clip(scenario.task_survival(s, np.atleast_1d(t), self.device),
                    0.0, 1.0)
        return binom_lt_curves(scenario.n, [k], 1.0 - S)[:, 0]

    def curve(self, scenario: Scenario, ks: Sequence[int]) -> Dict[int, float]:
        resolve(self.device)
        tail = 1.0 - self.p
        mean = scenario.dist.mean()
        out: Dict[int, float] = {}
        for k in ks:
            s = scenario.n // k
            surv = lambda t: self._order_stat_survival(scenario, k, t)
            hi = max(scenario.effective_delta * s, 1.0) * (
                s if not np.isfinite(mean) else max(mean, 1.0))
            for _ in range(200):                       # bracket: G(hi) <= 1-p
                if surv(np.array([hi]))[0] <= tail:
                    break
                hi *= 1.7
            lo = 0.0
            if surv(np.array([lo]))[0] <= tail:
                out[int(k)] = lo
                continue
            while hi - lo > self.tol * max(hi, 1.0):   # bisect the crossing
                mid = 0.5 * (lo + hi)
                if surv(np.array([mid]))[0] <= tail:
                    hi = mid
                else:
                    lo = mid
            out[int(k)] = hi
        return out


@dataclasses.dataclass(frozen=True)
class LoadAwareLatency:
    """Job latency under ARRIVALS, by the cluster/queueing simulator.

    The paper scores a single job in isolation; under load, redundancy also
    inflates server occupancy, shifting k* (Joshi-Soljanin-Wornell; the
    "Straggler Mitigation at Scale" regimes).  ``backend="batched"``
    (default) runs the whole candidate-k curve as ONE lane grid on
    ``runtime.cluster_batched`` — honoring the scenario's arrival process
    and heterogeneous worker speeds — while ``backend="oracle"`` is the
    escape hatch onto the reference discrete-event loop (one run per k;
    Poisson-or-``scenario.arrivals`` arrivals, same semantics).
    ``metric`` is one of "mean", "p50", "p95", "p99".  ``warmup=None``
    discards min(num_jobs // 10, 200) transient jobs from the latency
    stats (the empty-system start otherwise biases tail quantiles);
    ``reps`` averages that many replications on either backend — common-
    random-number lanes in the same engine call (batched) or repeated
    cells on shifted seeds (oracle), pooled the same way.

    ``assignment`` scores every k under that task placement
    (``repro_torch.assign``); None is the paper's all-workers fan-out.
    To OPTIMIZE over placements instead of fixing one, use
    ``Planner.co_plan`` / ``Planner.co_kstar_vs_load``.

    ``device`` (default ``"cuda"``) receives the draws and runs the
    lanes.  ``backend="cached"`` and the fleet-scale knobs
    ``chunk_size`` / ``stream`` are accepted here as in the JAX package
    and raise ``NotImplementedError`` when a surface is asked for: the
    compiled-surface cache and the chunked engine come with the next
    slice of the port.
    """

    arrival_rate: float = 0.05
    num_jobs: int = 1500
    metric: str = "mean"
    preempt: bool = True
    cancel_overhead: float = 0.0
    seed: int = 0
    backend: str = "batched"
    warmup: Optional[int] = None
    reps: int = 1
    assignment: Optional["Assignment"] = None
    chunk_size: Optional[int] = None
    stream: bool = False
    name: str = "load_aware_latency"
    device: str = DEFAULT_DEVICE

    def __post_init__(self):
        if self.metric not in ("mean", "p50", "p95", "p99"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.backend not in ("batched", "oracle", "cached"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend == "oracle" and (self.chunk_size is not None
                                         or self.stream):
            raise ValueError("chunk_size/stream need the batched or "
                             "cached backend (the chunked engine), not "
                             "the discrete-event oracle")

    def _chunk_kwargs(self) -> dict:
        if self.chunk_size is not None or self.stream:
            return dict(chunk_size=self.chunk_size, stream=self.stream)
        return {}

    def curve(self, scenario: Scenario, ks: Sequence[int]) -> Dict[int, float]:
        return self.surface(scenario, [self.arrival_rate],
                            ks).curve(0, self.metric)

    def surface(self, scenario: Scenario, loads: Sequence[float],
                ks: Optional[Sequence[int]] = None):
        """The full (loads x ks) ``ClusterSweep`` — one engine call on the
        batched backend, cell-by-cell discrete-event runs on the oracle
        backend (same result type, same warmup/reps aggregation, so the
        escape hatch really cross-checks the fast engine)."""
        from .runtime.cluster import resolve_sweep_backend
        run = resolve_sweep_backend(self.backend)
        return run(scenario, loads=list(loads),
                   ks=list(ks) if ks is not None else None,
                   num_jobs=self.num_jobs, reps=self.reps,
                   preempt=self.preempt,
                   cancel_overhead=self.cancel_overhead,
                   seed=self.seed, warmup=self.warmup,
                   assignment=self.assignment, device=self.device,
                   **self._chunk_kwargs())

    def co_surface(self, scenario: Scenario, loads: Sequence[float],
                   assignments: Sequence, ks: Optional[Sequence[int]] = None):
        """The (loads x ks x assignments) ``AssignmentSurface`` — the whole
        co-optimization grid in one engine call on the batched backend
        (``assign.surface.co_sweep`` with this objective's queueing
        knobs)."""
        from .assign.surface import co_sweep
        return co_sweep(scenario, list(loads), assignments,
                        ks=list(ks) if ks is not None else None,
                        num_jobs=self.num_jobs, reps=self.reps,
                        preempt=self.preempt,
                        cancel_overhead=self.cancel_overhead,
                        seed=self.seed, warmup=self.warmup,
                        backend=self.backend, device=self.device,
                        **self._chunk_kwargs())


@dataclasses.dataclass(frozen=True)
class FRCompletionTime:
    """E[T] of the achievable fractional-repetition coded step.

    The FR gradient code assigns each of the k part groups to c = n/k
    workers; the step completes at max over groups of the min within each
    group (runtime.straggler.fr_expected_completion).
    """

    name: str = "fr_completion_time"
    device: str = DEFAULT_DEVICE

    def curve(self, scenario: Scenario, ks: Sequence[int]) -> Dict[int, float]:
        from .runtime.straggler import fr_expected_completion
        device = resolve(self.device)
        return {
            int(k): fr_expected_completion(
                scenario.dist, scenario.scaling, scenario.n,
                Policy(scenario.n, int(k)).c, delta=scenario.delta,
                device=device)
            for k in ks
        }


# --------------------------------------------------------------------------
# The planner facade
# --------------------------------------------------------------------------

class Planner:
    """``plan(scenario)`` / ``curve(scenario)`` / ``sweep(scenarios)`` /
    ``kstar_vs_load`` / ``co_plan`` / ``co_kstar_vs_load``.

    The default objective is the paper's ``MeanCompletionTime``; pass any
    ``Objective`` at construction or per call.
    """

    def __init__(self, objective: Optional[Objective] = None):
        self.objective: Objective = (
            MeanCompletionTime() if objective is None else objective)

    def curve(self, scenario: Scenario,
              objective: Optional[Objective] = None) -> Dict[int, float]:
        """k -> objective cost over the scenario's legal k values."""
        obj = self.objective if objective is None else objective
        return obj.curve(scenario, scenario.legal_ks())

    def plan(self, scenario: Scenario,
             objective: Optional[Objective] = None) -> Plan:
        """The arg-min policy, with the paper's theorem annotation."""
        return self._finalize(scenario, self.curve(scenario, objective))

    def kstar_vs_load(self, scenario: Scenario, loads: Sequence[float],
                      objective: Optional["LoadAwareLatency"] = None
                      ) -> Dict[float, int]:
        """load -> k* for a whole load sweep — the beyond-paper surface.

        Every (load, k) queueing cell — each legal k at each mean arrival
        rate, with the scenario's arrival process, worker speeds, and the
        objective's cancel/preempt semantics — runs in ONE engine call on
        the batched cluster engine; an ``objective`` with
        ``backend="oracle"`` falls back to per-cell discrete-event runs.
        """
        obj = self._load_aware(objective)
        return obj.surface(scenario, loads,
                           scenario.legal_ks()).kstar(obj.metric)

    def _load_aware(self, objective) -> "LoadAwareLatency":
        if objective is not None:
            return objective
        if isinstance(self.objective, LoadAwareLatency):
            return self.objective
        return LoadAwareLatency()

    def co_plan(self, scenario: Scenario, assignments: Sequence,
                objective: Optional["LoadAwareLatency"] = None) -> Plan:
        """The jointly optimal (k, assignment) decision at one load.

        Every (k, assignment) cell of the grid — each legal k under each
        candidate placement, exactly CRN-paired on service draws — runs
        in ONE engine call (``assign.surface.co_sweep``); the argmin is a
        within-sample decision.  The returned ``Plan`` carries the
        winning placement (``plan.assignment``, also attached to
        ``plan.policy``) and its ``curve`` is the ENVELOPE: per k, the
        best placement's cost.  Put ``AllWorkers()`` (or None) first in
        ``assignments`` to prefer the paper's dispatch on ties.
        """
        obj = self._load_aware(objective)
        surf = obj.co_surface(scenario, [obj.arrival_rate], assignments,
                              ks=scenario.legal_ks())
        cube = surf.metric(obj.metric)[:, 0, :]          # (A, K)
        if not np.any(np.isfinite(cube)):
            raise InfeasibleSurfaceError(
                f"no feasible (k, assignment): every cell of the "
                f"{cube.shape} co-surface is non-finite")
        flat = int(np.argmin(cube))                      # first min wins
        ai, kj = divmod(flat, len(surf.ks))
        k_best = int(surf.ks[kj])
        tk, tname = theorem_kstar(scenario.dist, scenario.scaling,
                                  scenario.n, scenario.delta)
        policy = Policy(n=scenario.n, k=k_best)
        return Plan(
            n=scenario.n,
            k=k_best,
            expected_time=float(cube[ai, kj]),
            strategy=policy.strategy,
            code_rate=policy.code_rate,
            task_size=policy.task_size,
            curve=surf.min_curve(0, obj.metric),
            theorem_k=tk,
            theorem_name=tname,
            assignment=surf.assignments[ai],
        )

    def co_kstar_vs_load(self, scenario: Scenario, loads: Sequence[float],
                         assignments: Sequence,
                         objective: Optional["LoadAwareLatency"] = None
                         ) -> Dict[float, tuple]:
        """load -> jointly optimal (k, assignment) over a load sweep —
        the co-optimized counterpart of ``kstar_vs_load``, still one
        engine call for the whole (loads x ks x assignments) grid."""
        obj = self._load_aware(objective)
        return obj.co_surface(scenario, loads, assignments,
                              ks=scenario.legal_ks()).kstar(obj.metric)

    def sweep(self, scenarios: Sequence[Scenario],
              objective: Optional[Objective] = None) -> List[Plan]:
        """Plans for a whole scenario grid.

        With the Monte-Carlo mean objective and a homogeneous grid (same
        scaling, n, delta, and unconstrained k support — one distribution
        family), the WHOLE grid is estimated from one shared base sample
        (``simulator.completion_curves_grid_mc``); otherwise scenarios are
        planned independently.
        """
        scenarios = list(scenarios)
        if not scenarios:
            return []
        obj = self.objective if objective is None else objective
        if isinstance(obj, MeanCompletionTime) and obj.mc and \
                self._homogeneous(scenarios):
            from .core.simulator import completion_curves_grid_mc
            ref = scenarios[0]
            ks = ref.legal_ks()
            curves = completion_curves_grid_mc(
                [s.dist for s in scenarios], ref.scaling, ref.n, ks=ks,
                trials=obj.trials, seed=obj.seed, delta=ref.delta,
                device=obj.device)
            return [
                self._finalize(s, {k: float(v) for k, v in zip(ks, row)})
                for s, row in zip(scenarios, curves)
            ]
        return [self.plan(s, obj) for s in scenarios]

    @staticmethod
    def _homogeneous(scenarios: Sequence[Scenario]) -> bool:
        ref = scenarios[0]
        return all(
            s.scaling is ref.scaling and s.n == ref.n and s.delta == ref.delta
            and s.max_task_size is None and s.candidate_ks is None
            and type(s.dist) is type(ref.dist)
            for s in scenarios)

    @staticmethod
    def _finalize(scenario: Scenario, curve: Dict[int, float]) -> Plan:
        """Arg-min + theorem annotation over a computed k-curve (the single
        implementation behind both the API and the legacy shims).

        Raises ``InfeasibleSurfaceError`` when no candidate is finite.
        """
        if curve and not any(np.isfinite(v) for v in curve.values()):
            raise InfeasibleSurfaceError(
                f"no feasible k: every candidate in {sorted(curve)} is "
                f"non-finite (all jobs failed in every cell)")
        k_best = min(curve, key=lambda k: (curve[k], k))
        tk, tname = theorem_kstar(scenario.dist, scenario.scaling, scenario.n,
                                  scenario.delta)
        policy = Policy(n=scenario.n, k=k_best)
        return Plan(
            n=scenario.n,
            k=k_best,
            expected_time=curve[k_best],
            strategy=policy.strategy,
            code_rate=policy.code_rate,
            task_size=policy.task_size,
            curve=curve,
            theorem_k=tk,
            theorem_name=tname,
        )
