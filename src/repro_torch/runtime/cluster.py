"""Cluster/queueing simulation: shared types + the two-backend front door.

The paper computes E[Y_{k:n}] for one job in isolation.  In a real cluster
jobs ARRIVE; redundancy then has a second cost besides lost parallelism:
it inflates server occupancy, so the optimal redundancy level shifts with
LOAD (Joshi-Soljanin-Wornell [18]; Aktas-Soljanin "Straggler Mitigation at
Scale").  Two backends measure that shift end to end:

  * ``runtime.cluster_oracle`` — the reference discrete-event simulator:
    a Python heapq event loop, one (scenario, load, k) cell at a time.
    Trusted, slow, and the ground truth the batched engine is validated
    against.
  * ``runtime.cluster_batched`` — the production engine: the exact same
    dynamics as one loop over jobs in which every operation covers all
    (replications x loads x k) lanes at once, with common random
    numbers, so a whole ``optimal_k_vs_load`` surface is one engine call
    on the card.

System model (Fig. 1 as a queueing system): n workers, each an exclusive
FCFS server; jobs arrive (Poisson by default, or any
``core.scenario.ArrivalProcess``), each of size n CUs; the master
pre-processes each job with an [n, k] strategy into n tasks of s = n/k
CUs, one per worker; a job completes when any k tasks finish; remnants
are cancelled (queue purge; in-service remnants preempted when
``preempt``, each preemption paying ``cancel_overhead`` of busy-but-
wasted server time).

This module holds the shared config/result types and the dispatching
entry points (``simulate``, ``latency_vs_redundancy``,
``optimal_k_vs_load``); the backends import the types from here.  Every
entry point draws and runs on ``device`` (default ``"cuda"``); on a
machine without a card it raises unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .._device import DEFAULT_DEVICE, resolve
from ..core.distributions import Scaling, ServiceTime
from ..core.policy import RetryPolicy
from ..core.scenario import (ArrivalProcess, FailureModel, Scenario,
                             validate_worker_speeds)

__all__ = [
    "ClusterConfig", "ClusterResult", "JobStats", "default_warmup",
    "resolve_sweep_backend", "simulate", "latency_vs_redundancy",
    "optimal_k_vs_load",
]


def default_warmup(num_jobs: int) -> int:
    """The shared ``warmup=None`` resolution of every sweep surface —
    min(num_jobs // 10, 200) transient jobs discarded — so the two
    backends always summarize the same job window."""
    return min(num_jobs // 10, 200)


@dataclasses.dataclass
class ClusterConfig:
    n_workers: int
    k: int                        # diversity/parallelism knob (divides n)
    arrival_rate: float           # jobs / unit time (mean rate)
    num_jobs: int = 2000
    preempt: bool = True          # cancel in-service remnant tasks
    cancel_overhead: float = 0.0  # busy-but-wasted time to purge a task
    seed: int = 0
    warmup: int = 0               # jobs excluded from latency quantiles
    arrivals: Optional[ArrivalProcess] = None   # None -> Poisson
    worker_speeds: Optional[Tuple[float, ...]] = None  # heterogeneous fleet
    failures: Optional[FailureModel] = None     # None -> fault-free fleet
    retry: Optional[RetryPolicy] = None         # None -> RetryPolicy() when
    #                                             failures are modeled
    assignment: Optional["Assignment"] = None   # None -> all-workers fan-out

    def __post_init__(self):
        if self.n_workers % self.k:
            raise ValueError("k must divide n")
        if not (0 <= self.warmup < self.num_jobs):
            raise ValueError(
                f"warmup must be in [0, num_jobs), got {self.warmup}")
        if self.worker_speeds is not None:
            self.worker_speeds = validate_worker_speeds(self.worker_speeds,
                                                        self.n_workers)
        if self.failures is not None and \
                not isinstance(self.failures, FailureModel):
            raise TypeError(
                f"failures must be a FailureModel, got {self.failures!r}")
        if self.retry is not None and not isinstance(self.retry, RetryPolicy):
            raise TypeError(f"retry must be a RetryPolicy, got {self.retry!r}")
        if self.assignment is not None:
            from ..assign.strategies import Assignment
            if not isinstance(self.assignment, Assignment):
                raise TypeError(f"assignment must be an Assignment strategy, "
                                f"got {self.assignment!r}")
            self.assignment.validate(self.n_workers, self.k)


@dataclasses.dataclass
class JobStats:
    arrival: float
    start: float = 0.0
    done: float = 0.0

    @property
    def latency(self) -> float:
        return self.done - self.arrival


@dataclasses.dataclass
class ClusterResult:
    latencies: np.ndarray         # per-job, in arrival order (ALL jobs);
    #                               for a FAILED job this is its time to
    #                               resolution (the give-up instant)
    utilization: float
    wasted_frac: float            # cancelled-work time / total busy time
    throughput: float             # COMPLETED jobs per unit time
    warmup: int = 0               # first W jobs excluded from quantiles
    job_failed: Optional[np.ndarray] = None  # per-job bool; None = fault-free

    @property
    def steady_latencies(self) -> np.ndarray:
        """Latencies with the warm-up transient discarded: the first
        ``warmup`` jobs see an emptier-than-steady-state system, so
        including them biases quantiles (especially p99) optimistic.
        Under a failure model, FAILED jobs are excluded too — their
        "latency" is a give-up instant, not a completion time."""
        lat = self.latencies[self.warmup:]
        if self.job_failed is None:
            return lat
        return lat[~self.job_failed[self.warmup:]]

    @property
    def failure_rate(self) -> float:
        """Post-warmup fraction of jobs that FAILED (fewer than k tasks
        survived their retry budgets).  0.0 on a fault-free run."""
        if self.job_failed is None:
            return 0.0
        f = self.job_failed[self.warmup:]
        return float(f.mean()) if f.size else 0.0

    def summary(self) -> dict:
        lat = self.steady_latencies
        q = np.quantile
        out = dict(
            mean=float(lat.mean()) if lat.size else float("inf"),
            p50=float(q(lat, 0.50)) if lat.size else float("inf"),
            p95=float(q(lat, 0.95)) if lat.size else float("inf"),
            p99=float(q(lat, 0.99)) if lat.size else float("inf"),
            utilization=self.utilization,
            wasted_frac=self.wasted_frac,
            throughput=self.throughput,
        )
        if self.job_failed is not None:
            out["failure_rate"] = self.failure_rate
        return out


def _resolve_backend(backend: str):
    if backend == "oracle":
        from .cluster_oracle import simulate_oracle
        return simulate_oracle
    if backend == "batched":
        from .cluster_batched import simulate_one
        return simulate_one
    raise ValueError(f"backend must be 'oracle' or 'batched', got {backend!r}")


def resolve_sweep_backend(backend: str):
    """The (loads x ks) surface runner for a backend name — the single
    dispatch shared by the module-level sweep entry points and
    ``api.LoadAwareLatency.surface``.  ``"cached"`` is the batched engine
    through the surface cache (``runtime.surface_cache``): identical
    results, each call counted under its structural key.  ``"fleet"`` is
    the chunked streaming engine (``runtime.fleet``) at its defaults —
    the memory-bounded path for fleet-scale surfaces."""
    if backend == "oracle":
        from .cluster_oracle import sweep_oracle
        return sweep_oracle
    if backend == "batched":
        from .cluster_batched import sweep
        return sweep
    if backend == "cached":
        from .surface_cache import cached_sweep
        return cached_sweep
    if backend == "fleet":
        from .fleet import fleet_sweep
        return fleet_sweep
    raise ValueError(
        f"backend must be 'oracle', 'batched', 'cached', or 'fleet', "
        f"got {backend!r}")


def simulate(cfg: ClusterConfig, dist: ServiceTime, scaling: Scaling,
             delta: Optional[float] = None, backend: str = "oracle",
             service_times: Optional[np.ndarray] = None,
             arrival_times: Optional[np.ndarray] = None,
             crash_times: Optional[np.ndarray] = None,
             recovery_times: Optional[np.ndarray] = None,
             device=DEFAULT_DEVICE) -> ClusterResult:
    """Run one (scenario, load, k) cell; returns latency/utilization stats.

    ``backend="oracle"`` (default) runs the Python discrete-event loop;
    ``backend="batched"`` runs the identical dynamics through the lane
    engine — same sample path for the same config, since both draw from
    ``core.scenario.sample_task_matrix`` under the same generator seed.
    Draws and the batched lane run on ``device``; the oracle's event
    loop is host Python in float64 either way.
    ``service_times`` (num_jobs, n) / ``arrival_times`` (num_jobs,)
    override the sampling entirely (parity tests inject both), and
    ``crash_times`` / ``recovery_times`` ((n, M) each) inject a
    deterministic failure schedule the same way — the exact-parity path
    for failure cells (``cfg.failures`` samples a stochastic schedule
    instead).
    """
    run = _resolve_backend(backend)
    return run(cfg, dist, scaling, delta=delta,
               service_times=service_times, arrival_times=arrival_times,
               crash_times=crash_times, recovery_times=recovery_times,
               device=resolve(device))


def latency_vs_redundancy(dist: ServiceTime, scaling: Scaling, n: int,
                          arrival_rate: float, num_jobs: int = 2000,
                          delta: Optional[float] = None,
                          seed: int = 0, backend: str = "oracle",
                          warmup: int = 0,
                          arrivals: Optional[ArrivalProcess] = None,
                          worker_speeds: Optional[Sequence[float]] = None,
                          device=DEFAULT_DEVICE,
                          **cfg_kwargs) -> Dict[int, dict]:
    """Mean/percentile latency for every legal k at one load level.

    Both backends take the same knobs — ``arrivals`` / ``worker_speeds``
    travel via the ``Scenario``, and ``cfg_kwargs`` are the shared sweep
    parameters (``preempt``, ``cancel_overhead``, ``reps``) — so an
    oracle cross-check of a batched run is a one-argument change.
    """
    run = resolve_sweep_backend(backend)
    scenario = Scenario(dist, scaling, n, delta=delta, arrivals=arrivals,
                        worker_speeds=None if worker_speeds is None
                        else tuple(worker_speeds))
    sw = run(scenario, loads=[arrival_rate], num_jobs=num_jobs,
             seed=seed, warmup=warmup, device=device, **cfg_kwargs)
    return {k: sw.summary(0, i) for i, k in enumerate(sw.ks)}


def optimal_k_vs_load(dist: ServiceTime, scaling: Scaling, n: int,
                      loads: Sequence[float], num_jobs: int = 1500,
                      delta: Optional[float] = None,
                      backend: str = "batched", metric: str = "mean",
                      seed: int = 0, warmup: Optional[int] = None,
                      arrivals: Optional[ArrivalProcess] = None,
                      worker_speeds: Optional[Sequence[float]] = None,
                      device=DEFAULT_DEVICE,
                      **cfg_kwargs) -> Dict[float, int]:
    """k* (by ``metric``) at each load — the beyond-paper surface.

    ``loads`` are mean arrival rates.  With the default batched backend
    the ENTIRE (load x k) surface — every legal k at every load, cancel
    and preempt semantics included — runs in one engine call with
    common random numbers across lanes; ``backend="oracle"`` falls back
    to one discrete-event run per cell (the validation path).  Both
    backends resolve ``warmup=None`` through the same ``default_warmup``
    rule, so their statistics cover the same job window.
    """
    if warmup is None:
        warmup = default_warmup(num_jobs)
    run = resolve_sweep_backend(backend)
    scenario = Scenario(dist, scaling, n, delta=delta, arrivals=arrivals,
                        worker_speeds=None if worker_speeds is None
                        else tuple(worker_speeds))
    sw = run(scenario, loads=list(loads), num_jobs=num_jobs,
             seed=seed, warmup=warmup, device=device, **cfg_kwargs)
    return sw.kstar(metric)
