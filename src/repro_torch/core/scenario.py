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

This module is also the shared SAMPLING substrate of the two cluster
backends (``runtime.cluster_oracle``, ``runtime.cluster_batched``):

  * ``ArrivalProcess`` and its concrete families (``PoissonArrivals``,
    ``DeterministicArrivals``, ``MMPPArrivals``) are frozen, hashable
    dataclasses whose ``times(generator, num_jobs, rate)`` draws the
    arrival instants on the generator's device; ``rate`` may be a tensor
    of load lanes, so the batched engine sweeps the rate over one draw.
  * ``FailureModel.schedule`` draws the per-worker crash/recovery
    instants, and ``sample_task_matrix`` the (num_jobs, n) per-job/
    per-worker task-time matrix, applying per-worker speed factors —
    heterogeneous machines — multiplicatively.  The oracle and the
    batched engine's single-cell path consume the same matrix for a
    given generator seed, which is what makes exact sample-path parity
    possible.
  * The chunked fleet engine draws from per-GLOBAL-job-index row keys
    instead (``job_row_keys``, ``ArrivalProcess.gaps_chunk``,
    ``FailureModel.schedule_chunk``, ``sample_task_matrix(start_job=)``):
    counter-based Threefry bits (``core.threefry``), so job j's row is a
    pure function of (key, j) and any chunking of [0, N) draws the same
    rows bit for bit, on the host and on the card alike.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, generator, resolve, target
from . import threefry
from .batched import divisors
from .distributions import (BiModal, Scaling, ServiceTime, ShiftedExp,
                            exponential_from_uniform)
from .policy import Policy, RetryPolicy  # noqa: F401  (re-export)

__all__ = [
    "ArrivalProcess", "FailureModel", "PoissonArrivals",
    "DeterministicArrivals", "MMPPArrivals", "RetryPolicy", "Scenario",
    "arrival_gap", "job_row_keys", "sample_task_matrix", "task_survival",
    "validate_worker_speeds",
]


# --------------------------------------------------------------------------
# Chunk-offset sampling discipline
# --------------------------------------------------------------------------
# A bulk draw sliced at an offset is not reproducible: which elements a
# generator fills depends on the whole draw.  The chunked fleet engine
# therefore derives one key PER JOB INDEX — ``fold_in(key, j)`` — and
# draws each job's row from its own key, so any chunk [start, start + m)
# of such a draw is bit-identical to the same rows of the full draw BY
# CONSTRUCTION.

def job_row_keys(key: torch.Tensor, start_job: int,
                 num_jobs: int) -> torch.Tensor:
    """Per-job keys ``fold_in(key, start_job + i)`` for i in
    [0, num_jobs): a (num_jobs, 2) tensor on ``key``'s device."""
    idx = int(start_job) + torch.arange(int(num_jobs), dtype=torch.int64,
                                        device=key.device)
    return threefry.fold_in(key, idx)


# --------------------------------------------------------------------------
# Arrival processes
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """A stationary arrival process with mean rate ``rate`` (jobs/time).

    Subclasses implement ``times``; ``rate`` may be overridden per call
    so one process object describes the SHAPE of the workload while a
    load sweep scales its intensity.
    """

    rate: float

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")

    def times(self, generator: torch.Generator, num_jobs: int, rate=None,
              device=None, batch: Tuple[int, ...] = ()) -> torch.Tensor:
        """Arrival instants of the first ``num_jobs`` jobs (ascending,
        float32), drawn as ``batch + (num_jobs,)`` on ``device`` (default:
        the generator's).  ``rate`` (default ``self.rate``) is a float or
        a tensor that broadcasts against the draw: the batched engine
        passes its (L, 1) load lanes and a ``batch`` of (reps, 1), so one
        draw serves every load with only the rate swept."""
        raise NotImplementedError

    def _rate(self, rate, device) -> torch.Tensor:
        r = self.rate if rate is None else rate
        # a float32 tensor on the draw's device: a true division, as the
        # reference's, where a host scalar could become a reciprocal
        return torch.as_tensor(r, dtype=torch.float32, device=device)

    @staticmethod
    def _exponential(generator, shape, device) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=device
                           ).exponential_(generator=generator)

    # -- chunk-offset sampling (fleet-scale streaming engine) ---------------
    def arrival_state0(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """Initial cross-chunk state for ``gaps_chunk`` (an int64 scalar
        on ``device``; an opaque carry — only MMPP uses it, for its
        modulating chain)."""
        return torch.zeros((), dtype=torch.int64, device=resolve(device))

    def gaps_chunk(self, key: torch.Tensor, start_job: int, num_jobs: int,
                   rate=None, state=None):
        """Interarrival gaps of jobs [start_job, start_job + num_jobs).

        Returns ``(gaps, state')`` where ``gaps[i]`` is the gap ending at
        the arrival of job ``start_job + i``, drawn on ``key``'s device
        from the per-job row keys (``job_row_keys``), so sampling any
        chunking of [0, N) with the state carried yields bit-identical
        gaps to one call over [0, N).  A different (equal-in-law) sample
        path from the generator-based ``times``.
        """
        raise NotImplementedError

    def _state(self, key, state):
        return self.arrival_state0(key.device) if state is None else state


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals: i.i.d. Exp(1/rate) gaps (the paper refs' M/·)."""

    def times(self, generator, num_jobs, rate=None, device=None, batch=()):
        dev = target(generator, device)
        e = self._exponential(generator, tuple(batch) + (num_jobs,), dev)
        return torch.cumsum(e / self._rate(rate, dev), dim=-1)

    def gaps_chunk(self, key, start_job, num_jobs, rate=None, state=None):
        rks = job_row_keys(key, start_job, num_jobs)
        e = exponential_from_uniform(threefry.uniform(rks, 1)[:, 0])
        return e / self._rate(rate, key.device), self._state(key, state)


@dataclasses.dataclass(frozen=True)
class DeterministicArrivals(ArrivalProcess):
    """Clockwork arrivals: constant gap 1/rate (D/·; zero arrival CV).

    The generator is not drawn from, so replication lanes share the
    identical arrival path."""

    def times(self, generator, num_jobs, rate=None, device=None, batch=()):
        dev = target(generator, device)
        steps = torch.arange(1, num_jobs + 1, dtype=torch.float32,
                             device=dev)
        return steps.expand(tuple(batch) + (num_jobs,)) / \
            self._rate(rate, dev)

    def gaps_chunk(self, key, start_job, num_jobs, rate=None, state=None):
        ones = torch.ones((int(num_jobs),), dtype=torch.float32,
                          device=key.device)
        return ones / self._rate(rate, key.device), self._state(key, state)


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

    def times(self, generator, num_jobs, rate=None, device=None, batch=()):
        dev = target(generator, device)
        shape = tuple(batch) + (num_jobs,)
        e = self._exponential(generator, shape, dev)
        flips = torch.rand(shape, generator=generator, device=dev) \
            < self.switch
        state = torch.cumsum(flips.to(torch.int32), dim=-1) % 2  # start slow
        # normalize: stationary per-arrival state is 1/2-1/2 (symmetric
        # flips), so E[gap] = c/2 * (1/slow + 1/burst) / r == 1/r
        c = 0.5 * (1.0 / self.slow + 1.0 / self.burst)
        rates = self._rate(rate, dev) * c * torch.where(
            state == 0, self.slow, self.burst)
        return torch.cumsum(e / rates, dim=-1)

    def gaps_chunk(self, key, start_job, num_jobs, rate=None, state=None):
        # Same per-arrival modulation as ``times``, with the chain's
        # parity carried ACROSS chunks: ``state`` counts flips so far
        # (mod 2), so any chunking of [0, N) walks the identical chain.
        state = self._state(key, state)
        u = threefry.uniform(job_row_keys(key, start_job, num_jobs), 2)
        e = exponential_from_uniform(u[:, 0])
        flips = (u[:, 1] < self.switch).to(torch.int64)
        st = (state + torch.cumsum(flips, dim=0)) % 2        # start slow
        c = 0.5 * (1.0 / self.slow + 1.0 / self.burst)
        rates = self._rate(rate, key.device) * c * torch.where(
            st == 0, self.slow, self.burst)
        return e / rates, (state + flips.sum()) % 2


def arrival_gap(last_ts: float, timestamp: float) -> float:
    """The interarrival gap between consecutive job instants — the ONE
    clock-tolerance rule shared by every timestamp consumer.

    float32-sourced clocks (e.g. a reassociating cumsum) can tick
    backwards by an ulp; such a tick clamps to a zero gap, while a
    decrease beyond rounding scale is a caller error and raises.  The
    tolerance is ~3 float32 ulps of the timestamp magnitude (an epoch-
    scale clock at 1.7e9 s tolerates ~11 min of float32 quantization,
    not hours), so genuinely out-of-order delivery still raises.  A
    non-finite timestamp raises too — silently skipping one would merge
    its two neighboring gaps into a doubled gap (rate biased low), and
    letting it through would poison every decayed moment with NaN.
    """
    t = float(timestamp)
    if not math.isfinite(t):
        raise ValueError(f"arrival timestamp must be finite, got {t}")
    gap = t - float(last_ts)
    if gap < -4e-7 * max(abs(t), 1.0):
        raise ValueError(
            f"timestamps must be non-decreasing "
            f"(got {timestamp} after {last_ts})")
    return max(gap, 0.0)


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
    governed by the job's ``RetryPolicy``.  The process is exogenous
    wall-clock machine behavior, independent of the workload, which is
    what lets both cluster backends consume ONE pre-sampled schedule
    (``schedule``) and walk identical failure trajectories.

    ``max_events`` bounds the sampled schedule length per worker: beyond
    the last sampled crash a worker never fails again.  Size it so
    ``max_events * (mttf + mttr)`` comfortably exceeds the simulated
    horizon (the default 64 covers ~64 MTTFs).
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

    def schedule(self, generator: torch.Generator, n: int,
                 max_events: Optional[int] = None,
                 batch: Tuple[int, ...] = ()):
        """Sample (crash_times, recovery_times), each
        ``batch + (n, max_events)`` float32 on the generator's device.

        Rows are per-worker, columns ascending: worker w is UP on
        [R[w, m-1], C[w, m]) and DOWN on [C[w, m], R[w, m]) (with
        R[w, -1] = 0).  CRN discipline: one draw covers the whole fleet,
        so sweep lanes (k, load) share the identical machine behavior and
        only the ``batch`` (replication) axis refreshes it.
        """
        m = self.max_events if max_events is None else int(max_events)
        dev = generator.device
        shape = tuple(batch) + (n, m)
        up = torch.empty(shape, dtype=torch.float32, device=dev
                         ).exponential_(generator=generator) * self.mttf
        down = torch.empty(shape, dtype=torch.float32, device=dev
                           ).exponential_(generator=generator) * self.mttr
        # C[., 0] = up_0; R = C + down; C[., m] = R[., m-1] + up_m
        crash = torch.cumsum(
            up + torch.nn.functional.pad(down[..., :-1], (1, 0)), dim=-1)
        return crash, crash + down

    def schedule_chunk(self, key: torch.Tensor, n: int, start_event: int,
                       num_events: int, state: Optional[torch.Tensor] = None):
        """Chunk-offset twin of ``schedule``: columns [start_event,
        start_event + num_events) of the crash/recovery schedule, with
        the per-worker clock carried across chunks, drawn on ``key``'s
        device.

        Returns ``(crash, recover, state')`` where ``state`` is the (n,)
        recovery instant preceding the chunk (zeros initially).  Event
        column m draws its n up and n down intervals from
        ``fold_in(key, m)``, so the interval draws of any chunking of
        [0, M) are bit-identical to one call over [0, M); the cumulative
        instants agree to float rounding (a chunk boundary restarts the
        cumsum from ``state``).
        """
        n = int(n)
        if state is None:
            state = torch.zeros((n,), dtype=torch.float32, device=key.device)
        u = threefry.uniform(job_row_keys(key, start_event, num_events),
                             2 * n)
        e = exponential_from_uniform(u)                 # (m, 2n)
        up = (e[:, :n] * self.mttf).T                   # (n, m)
        down = (e[:, n:] * self.mttr).T
        crash = state[:, None] + torch.cumsum(
            up + torch.nn.functional.pad(down[:, :-1], (1, 0)), dim=1)
        recover = crash + down
        return crash, recover, recover[:, -1]


def sample_task_matrix(
    dist: ServiceTime,
    scaling: Scaling,
    n: int,
    s: int,
    num_jobs: int,
    generator: torch.Generator,
    delta: Optional[float] = None,
    worker_speeds: Optional[Sequence[float]] = None,
    start_job: Optional[int] = None,
) -> torch.Tensor:
    """(num_jobs, n) float32 task service times for tasks of ``s`` CUs,
    drawn from ``generator`` on its device.

    ``worker_speeds`` (length n, positive) are multiplicative slowdown
    factors — worker w serves every task ``speeds[w]`` times its sampled
    duration (heterogeneous machines).  Both cluster backends draw from
    here, so a shared generator seed yields the same sample path.

    ``start_job=None`` is the bulk draw from ``generator``.
    ``start_job=j0`` switches to the chunk-offset row-key discipline:
    job ``j0 + i``'s row is drawn from ``fold_in(key, j0 + i)`` so any
    chunking of [0, N) is bit-identical to slicing one call over [0, N)
    — the streaming engine's contract (a different, equal-in-law sample
    path from the bulk draw).  ``generator`` is then a ``core.threefry``
    key, or a ``torch.Generator`` keyed by its initial seed on its
    device (its state is not consumed).
    """
    if start_job is None:
        t = dist.sample_task(generator, (num_jobs, n), s, scaling,
                             delta=delta)
    else:
        key = generator
        if isinstance(key, torch.Generator):
            key = threefry.key(key.initial_seed(), key.device)
        width = n * int(s) if scaling is Scaling.ADDITIVE else n
        u = threefry.uniform(job_row_keys(key, start_job, num_jobs), width)
        if scaling is Scaling.ADDITIVE:
            u = u.view(int(num_jobs), n, int(s))
        t = dist.task_from_uniform(u, s, scaling, delta=delta)
    if worker_speeds is not None:
        t = t * torch.as_tensor(worker_speeds, dtype=t.dtype,
                                device=t.device)[None, :]
    return t


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
