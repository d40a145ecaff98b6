"""The typed problem statement: ``Scenario`` = (dist, scaling, n, delta,
constraints).

One frozen object carries everything the planner and the runtime take —
in particular the exogenous per-CU deterministic time ``delta`` that the
paper introduces for Pareto/Bi-Modal under data-dependent scaling
(Sec. V-B, VI-B).  ShiftedExp carries its own shift internally; a
Scenario that tries to override it with a conflicting value is rejected
at construction.

``task_survival`` is the single implementation of Pr{Y > t} for a task
of s CUs under every (distribution x scaling) pair — shared by the
quantile objective (``api``) and the FR-coded runtime
(``runtime.straggler``).

The arrival-process and failure-model types are here with their fields
and validation, so that ``Scenario`` checks what it is given; their
samplers belong to the queueing engines.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np

from .._device import DEFAULT_DEVICE, generator, resolve
from .batched import divisors
from .distributions import BiModal, Scaling, ServiceTime, ShiftedExp
from .policy import Policy, RetryPolicy  # noqa: F401  (re-export)

__all__ = [
    "ArrivalProcess", "FailureModel", "PoissonArrivals",
    "DeterministicArrivals", "MMPPArrivals", "RetryPolicy", "Scenario",
    "task_survival", "validate_worker_speeds",
]


# --------------------------------------------------------------------------
# Arrival processes
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """A stationary arrival process with mean rate ``rate`` (jobs/time).

    One process object describes the SHAPE of the workload; a load sweep
    rescales its intensity.
    """

    rate: float

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals: i.i.d. Exp(1/rate) gaps (the paper refs' M/·)."""


@dataclasses.dataclass(frozen=True)
class DeterministicArrivals(ArrivalProcess):
    """Clockwork arrivals: constant gap 1/rate (D/·; zero arrival CV)."""


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """Two-state Markov-modulated Poisson bursts (per-arrival modulation).

    After each arrival the state flips with probability ``switch``; gaps
    are Exp with per-state rates ``rate * slow`` / ``rate * burst``,
    normalized so the long-run mean rate equals ``rate``.
    """

    slow: float = 0.25
    burst: float = 4.0
    switch: float = 0.05

    def __post_init__(self):
        super().__post_init__()
        if self.slow <= 0 or self.burst <= 0:
            raise ValueError("slow and burst multipliers must be > 0")
        if not (0.0 < self.switch < 1.0):
            raise ValueError(f"switch must be in (0,1), got {self.switch}")


def validate_worker_speeds(speeds, n: int) -> Tuple[float, ...]:
    """Coerce/validate per-worker speed factors (length n, positive)."""
    out = tuple(float(v) for v in speeds)
    if len(out) != n:
        raise ValueError(
            f"worker_speeds must have length n={n}, got {len(out)}")
    if any(v <= 0 for v in out):
        raise ValueError("worker_speeds must be positive")
    return out


# --------------------------------------------------------------------------
# Worker failure model
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Per-worker exponential crash-restart process.

    Each worker alternates independent up intervals ~ Exp(mean ``mttf``)
    and down intervals ~ Exp(mean ``mttr``), anchored at time 0 (every
    worker starts up).  A crash kills the task in service; relaunch is
    governed by the job's ``RetryPolicy``.  ``max_events`` bounds the
    sampled schedule length per worker.
    """

    mttf: float
    mttr: float
    max_events: int = 64

    def __post_init__(self):
        if self.mttf <= 0:
            raise ValueError(f"mttf must be > 0, got {self.mttf}")
        if self.mttr < 0:
            raise ValueError(f"mttr must be >= 0, got {self.mttr}")
        if int(self.max_events) < 1:
            raise ValueError(
                f"max_events must be >= 1, got {self.max_events}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One (service PDF x scaling model x n) planning problem.

    ``delta``          exogenous per-CU deterministic time (Pareto/Bi-Modal
                       data-dependent paths; ShiftedExp carries its own and
                       must not be contradicted here).
    ``max_task_size``  caps s = n/k (lower-bounds k) — per-worker memory.
    ``candidate_ks``   restricts the searched k values (divisors of n).
    ``worker_speeds``  length-n positive multiplicative slowdowns — worker w
                       serves tasks ``speeds[w]`` x slower (heterogeneous
                       cluster); None means a homogeneous fleet.
    ``arrivals``       the arrival-process SHAPE for load-aware objectives;
                       None means Poisson.
    ``failures``       per-worker crash-restart behavior (``FailureModel``);
                       None means a fault-free fleet.
    """

    dist: ServiceTime
    scaling: Scaling
    n: int
    delta: Optional[float] = None
    max_task_size: Optional[int] = None
    candidate_ks: Optional[Tuple[int, ...]] = None
    worker_speeds: Optional[Tuple[float, ...]] = None
    arrivals: Optional[ArrivalProcess] = None
    failures: Optional[FailureModel] = None

    def __post_init__(self):
        if int(self.n) < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if not isinstance(self.scaling, Scaling):
            raise TypeError(f"scaling must be a Scaling, got {self.scaling!r}")
        if self.delta is not None:
            if self.delta < 0:
                raise ValueError(f"delta must be >= 0, got {self.delta}")
            if isinstance(self.dist, ShiftedExp) and \
                    float(self.delta) != self.dist.delta:
                raise ValueError(
                    "ShiftedExp carries its shift internally "
                    f"(delta={self.dist.delta}); a Scenario delta of "
                    f"{self.delta} would contradict it")
        if self.candidate_ks is not None:
            object.__setattr__(self, "candidate_ks",
                               tuple(int(k) for k in self.candidate_ks))
        if self.worker_speeds is not None:
            object.__setattr__(
                self, "worker_speeds",
                validate_worker_speeds(self.worker_speeds, self.n))
        if self.arrivals is not None and \
                not isinstance(self.arrivals, ArrivalProcess):
            raise TypeError(
                f"arrivals must be an ArrivalProcess, got {self.arrivals!r}")
        if self.failures is not None and \
                not isinstance(self.failures, FailureModel):
            raise TypeError(
                f"failures must be a FailureModel, got {self.failures!r}")

    # -- delta, resolved once ----------------------------------------------
    @property
    def effective_delta(self) -> float:
        """The per-CU deterministic component, resolved with explicit
        ``is None`` semantics (delta=0.0 means zero, not unset)."""
        return self.dist.shift if self.delta is None else float(self.delta)

    # -- the legal decision space -------------------------------------------
    def legal_ks(self) -> List[int]:
        """Legal k values after constraints (ascending)."""
        ks = list(self.candidate_ks) if self.candidate_ks is not None \
            else divisors(self.n)
        if self.max_task_size is not None:
            ks = [k for k in ks if self.n // k <= self.max_task_size]
        if not ks:
            raise ValueError("no legal k after constraints")
        return ks

    def legal_policies(self) -> List[Policy]:
        return [Policy(n=self.n, k=k) for k in self.legal_ks()]

    def task_survival(self, s: int, t: np.ndarray,
                      device=DEFAULT_DEVICE) -> np.ndarray:
        """Pr{Y > t} for a task of ``s`` CUs under this scenario."""
        return task_survival(self.dist, self.scaling, s, t, delta=self.delta,
                             device=device)

    def with_n(self, n: int) -> "Scenario":
        """The same problem on a different worker count (constraints kept;
        an explicit candidate_ks is dropped since the divisors change)."""
        return dataclasses.replace(self, n=n, candidate_ks=None)


# The additive-scaling building blocks depend only on (dist, s), and callers
# like the quantile objective's bisection evaluate the survival at one t per
# call: cache the expensive constructions (the s-fold Bi-Modal PMF
# convolution; the 200k-draw sorted Pareto sample) so repeated evaluations
# are array lookups.  Distributions are frozen dataclasses, hence hashable.

@functools.lru_cache(maxsize=256)
def _bimodal_sum_pmf_cached(B: float, eps: float, s: int):
    from . import order_stats as osl
    return osl.bimodal_sum_pmf(s, B, eps)


@functools.lru_cache(maxsize=64)
def _additive_mc_sorted_sums(dist: ServiceTime, s: int,
                             device: str) -> np.ndarray:
    """The sorted float32 sums of 200k s-CU draws, drawn and sorted on
    ``device`` from a generator seeded 12345, returned to the host."""
    draws = dist.sample(generator(12345, device), (200_000, s)).sum(dim=-1)
    return draws.sort().values.cpu().numpy()


def task_survival(dist: ServiceTime, scaling: Scaling, s: int, t: np.ndarray,
                  delta: Optional[float] = None,
                  device=DEFAULT_DEVICE) -> np.ndarray:
    """Pr{Y > t} for a task of s CUs under the scaling model (closed forms
    where available; the Pareto-additive tail is a Monte-Carlo estimate
    whose draws go to ``device``)."""
    from . import order_stats as osl

    t = np.asarray(t, dtype=np.float64)
    d = dist.shift if delta is None else float(delta)
    if scaling is Scaling.SERVER_DEPENDENT:
        # Y = d + s * Z with Z = X - shift
        if isinstance(dist, ShiftedExp):
            z = np.maximum((t - d) / max(s, 1), 0.0)
            return np.where(t < d, 1.0, np.exp(-z / max(dist.W, 1e-300)))
        return dist.tail(np.maximum((t - d), 0.0) / s + dist.shift)
    if scaling is Scaling.DATA_DEPENDENT:
        if isinstance(dist, ShiftedExp):
            z = np.maximum(t - s * d, 0.0)
            return np.where(t < s * d, 1.0, np.exp(-z / max(dist.W, 1e-300)))
        return dist.tail(t - s * d + dist.shift)
    # additive
    if isinstance(dist, ShiftedExp):
        return osl.erlang_survival(t - s * dist.delta, s, dist.W) \
            if dist.W > 0 else (t < s * dist.delta).astype(float)
    if isinstance(dist, BiModal):
        vals, probs = _bimodal_sum_pmf_cached(dist.B, dist.eps, s)
        return np.array([probs[vals > x].sum() for x in np.atleast_1d(t)]
                        ).reshape(t.shape)
    # Pareto additive: MC empirical tail
    draws = _additive_mc_sorted_sums(dist, s, str(resolve(device)))
    idx = np.searchsorted(draws, np.atleast_1d(t), side="right")
    return (1.0 - idx / draws.size).reshape(t.shape)
