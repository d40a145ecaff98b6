"""Per-worker step-time telemetry -> fitted service-time model -> re-plan.

The paper's planner needs the service-time PDF and scaling model.  In
production neither is known a priori: this module keeps a sliding window of
per-worker task times (from the step barrier), fits each candidate family
by maximum likelihood / method of moments, selects the best fit by EXACT
log-likelihood (``core.distributions.service_loglik``), and hands the
fitted model to the planner -- the paper's Table I as a control loop.

This is the one-shot windowed fit.  The streaming counterpart with
exponential forgetting and drift detection lives in ``repro_torch.control``
(estimators/detector/controller); both route model selection through the
same exact per-family ``logpdf``/``logpmf``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Tuple, Union

import numpy as np

from ..core.distributions import (FAMILIES, ServiceTime,  # noqa: F401
                                  select_service_time)


@dataclasses.dataclass(frozen=True)
class StraggleStats:
    """Typed straggle summary of one telemetry window."""

    median: float
    p99: float
    straggle_frac: float        # fraction of samples above 2x median
    straggle_magnitude: float   # mean straggler time / median
    num_samples: int


@dataclasses.dataclass(frozen=True)
class FleetHealth:
    """Typed liveness/loss summary of one telemetry window of task
    OUTCOMES (completed vs terminally lost, per worker).

    Mirrors the ``StraggleStats`` / ``InsufficientTelemetry`` contract:
    too few recorded outcomes returns the typed insufficiency result.
    ``worker_live`` is per-worker "delivered at least one completion in
    the window"; a worker with recorded outcomes that are ALL losses is
    the canonical crash-looping signature the controller quarantines on.
    """

    worker_live: Tuple[bool, ...]       # any completion in the window
    worker_loss_frac: Tuple[float, ...]  # per-worker loss fraction (0 when
                                         # the worker has no outcomes yet)
    loss_rate: float                    # pooled task-loss fraction
    retries_per_task: float             # mean relaunches per recorded task
    num_outcomes: int

    @property
    def num_live(self) -> int:
        return sum(self.worker_live)


@dataclasses.dataclass(frozen=True)
class ArrivalStats:
    """Typed arrival summary of one telemetry window of job timestamps.

    Mirrors the ``StraggleStats`` / ``InsufficientTelemetry`` contract:
    too few interarrival gaps returns the typed insufficiency result
    instead of NaN-laden stats or an exception.
    """

    rate: float                 # jobs per unit time (1 / mean gap)
    mean_gap: float
    dispersion: float           # Var[gap] / E[gap]^2 (CV^2; 1 = Poisson)
    num_gaps: int


@dataclasses.dataclass(frozen=True)
class SojournStats:
    """Typed end-to-end sojourn summary of the recorded (arrival,
    completion) pairs — completion-ordered observation: the latency a
    serving master actually sees, service PLUS queueing, which is the
    axis SLOs are written on.  Same short-window contract as the other
    typed summaries.
    """

    mean: float
    p50: float
    p95: float
    p99: float
    dispersion: float           # Var[sojourn] / E[sojourn]^2 (CV^2)
    num_jobs: int


@dataclasses.dataclass(frozen=True)
class WorkerSpeedStats:
    """Typed per-worker relative-speed estimate from step telemetry.

    ``speeds`` are decayed-mean service-time multipliers NORMALIZED by
    the fleet median — 1.0 is a median machine, 3.0 a machine whose
    tasks take three times as long.  The convention matches
    ``Scenario.worker_speeds`` (and ``assign.SpeedAware``): multipliers
    scale task time, larger = slower.  ``counts`` are the (decayed)
    per-worker sample masses behind each estimate; workers that have
    contributed fewer than the minimum keep the neutral 1.0.
    """

    speeds: Tuple[float, ...]          # median-normalized multipliers
    counts: Tuple[float, ...]          # decayed sample mass per worker
    num_samples: int                   # raw (undecayed) recordings

    @property
    def slowest(self) -> int:
        """Index of the slowest (largest-multiplier) worker."""
        return int(np.argmax(self.speeds))

    @property
    def spread(self) -> float:
        """max/min speed ratio — 1.0 on a homogeneous fleet; the
        controller's trigger for considering placement re-plans."""
        return float(max(self.speeds) / min(self.speeds))


@dataclasses.dataclass(frozen=True)
class InsufficientTelemetry:
    """Typed "not enough data" result — returned instead of NaN-laden
    stats when the window is empty or shorter than the minimum (the seed
    path warned via ``np.median([])`` and propagated NaNs downstream)."""

    have: int
    needed: int

    def __bool__(self) -> bool:   # `if stats:` reads as "usable"
        return False


@dataclasses.dataclass
class Telemetry:
    window: int = 512
    min_samples: int = 8
    #: per-step decay of the per-worker speed accumulators (exponential
    #: forgetting, so speed estimates track the CURRENT fleet)
    speed_decay: float = 0.97
    #: minimum decayed sample mass before a worker's own estimate is
    #: trusted (below it the worker reads as a neutral 1.0)
    min_worker_mass: float = 4.0
    #: optional streaming SLO monitor (``repro_torch.obs.SLOMonitor``): job
    #: latencies recorded via :meth:`record_latency` feed it, and its
    #: burn alarms land on the flight recorder
    slo: object = None

    def __post_init__(self):
        self._times: Deque[float] = collections.deque(maxlen=self.window)
        self._latencies: Deque[float] = collections.deque(maxlen=self.window)
        self._arrivals: Deque[float] = collections.deque(maxlen=self.window)
        self._sojourns: Deque[float] = collections.deque(maxlen=self.window)
        self._task_size: int = 1
        # task outcomes: (worker index, completed?) pairs, ring-bounded so
        # liveness tracks the RECENT fleet, not its whole history
        self._outcomes: Deque[Tuple[int, bool]] = collections.deque(
            maxlen=self.window)
        self._retries: Deque[int] = collections.deque(maxlen=self.window)
        # per-worker decayed service sums/masses (lazily sized to the
        # fleet on the first aligned recording)
        self._w_sum: np.ndarray = None
        self._w_cnt: np.ndarray = None
        self._w_raw: int = 0

    def record_step(self, worker_times: np.ndarray, task_size: int = 1):
        """Record the per-worker completion times of one step."""
        self._task_size = task_size
        for t in np.asarray(worker_times, dtype=np.float64).ravel():
            if math.isfinite(t):
                self._times.append(float(t))

    def record_worker_times(self, worker_times) -> None:
        """Record one step's per-worker service times, ALIGNED by index.

        Unlike :meth:`record_step` (which pools times for the family
        fit), position w here is worker w's time — the alignment is what
        makes per-worker speed estimation possible.  Non-finite or
        non-positive entries mean "worker contributed no completion this
        step" and are skipped.  A recording with a different fleet size
        resets the accumulators (the fleet was resized; old per-index
        estimates no longer describe the same machines).
        """
        x = np.asarray(worker_times, dtype=np.float64).ravel()
        if self._w_sum is None or self._w_sum.size != x.size:
            self._w_sum = np.zeros(x.size)
            self._w_cnt = np.zeros(x.size)
            self._w_raw = 0
        fin = np.isfinite(x) & (x > 0)
        self._w_sum *= self.speed_decay
        self._w_cnt *= self.speed_decay
        self._w_sum[fin] += x[fin]
        self._w_cnt[fin] += 1.0
        self._w_raw += int(fin.sum())

    def worker_speed_stats(self) -> Union["WorkerSpeedStats",
                                          "InsufficientTelemetry"]:
        """Typed per-worker speed multipliers from the decayed sums.

        Follows the ``InsufficientTelemetry`` contract: too few total
        recordings — or no worker past ``min_worker_mass`` — returns the
        typed insufficiency result.  Workers individually below the mass
        floor read as neutral 1.0, so one barely-seen machine cannot be
        declared the fleet's straggler off a single draw.  The returned
        multipliers are median-normalized, ready for
        ``assign.SpeedAware.with_speeds`` or ``Scenario.worker_speeds``.
        """
        if self._w_sum is None or self._w_raw < self.min_samples:
            return InsufficientTelemetry(have=self._w_raw,
                                         needed=self.min_samples)
        mass = self._w_cnt
        good = mass >= self.min_worker_mass
        if not good.any():
            return InsufficientTelemetry(have=self._w_raw,
                                         needed=self.min_samples)
        est = np.where(good, self._w_sum / np.maximum(mass, 1e-300), 1.0)
        med = float(np.median(est[good]))
        speeds = np.ones(est.size)
        speeds[good] = est[good] / max(med, 1e-300)
        return WorkerSpeedStats(
            speeds=tuple(float(s) for s in speeds),
            counts=tuple(float(c) for c in mass),
            num_samples=int(self._w_raw),
        )

    def record_latency(self, latency: float):
        """Record one end-to-end JOB completion latency (as opposed to
        the per-worker step times of :meth:`record_step`) and feed the
        attached SLO monitor, if any.  Returns the monitor's alarm when
        this observation crossed the multi-window burn rule (also
        recorded on the flight recorder), else None.
        """
        x = float(latency)
        if not math.isfinite(x):
            raise ValueError(f"latency must be finite, got {latency}")
        self._latencies.append(x)
        if self.slo is None:
            return None
        alarm = self.slo.observe(x)
        if alarm is not None:
            from ..obs import recorder as _trace
            rec = _trace.active()
            if rec is not None:
                rec.event("slo_alarm", name="slo_burn", at=alarm.at,
                          burn_fast=alarm.burn_fast,
                          burn_slow=alarm.burn_slow,
                          threshold=alarm.threshold, target=alarm.target,
                          quantile_est=alarm.quantile_est)
        return alarm

    @property
    def num_latencies(self) -> int:
        return len(self._latencies)

    def latencies(self) -> np.ndarray:
        return np.asarray(self._latencies, dtype=np.float64)

    def record_arrival(self, timestamp: float):
        """Record one job arrival instant (monotone non-decreasing)."""
        t = float(timestamp)
        if self._arrivals:
            # shared clock-tolerance rule (core.scenario.arrival_gap):
            # ulp-backward float32 ticks clamp; larger decreases and
            # non-finite instants raise (silently skipping one would
            # merge its neighboring gaps into a doubled gap)
            from ..core.scenario import arrival_gap
            t = self._arrivals[-1] + arrival_gap(self._arrivals[-1], t)
        elif not math.isfinite(t):
            raise ValueError(f"arrival timestamp must be finite, got {t}")
        self._arrivals.append(t)

    def record_job(self, arrival: float, completion: float):
        """Record one job's realized (arrival, completion) pair — the
        completion-ordered observation a serving master sees.

        One call does the whole serving-side bookkeeping: the arrival
        instant feeds the interarrival window (:meth:`record_arrival`'s
        clock-tolerance rule), and the sojourn ``completion - arrival``
        is recorded both as the job's end-to-end latency (so an attached
        SLO monitor sees it, exactly like :meth:`record_latency`) and in
        the sojourn window behind :meth:`sojourn_stats`.  Returns the
        SLO monitor's burn alarm when this job crossed it, else None.
        """
        a, c = float(arrival), float(completion)
        if not math.isfinite(a):
            raise ValueError(f"arrival must be finite, got {arrival}")
        # shared clock-tolerance rule: an ulp-backward completion clamps
        # to a zero-length sojourn, a larger inversion raises
        from ..core.scenario import arrival_gap
        sojourn = max(arrival_gap(a, c), 0.0)
        self.record_arrival(a)
        self._sojourns.append(sojourn)
        return self.record_latency(sojourn)

    @property
    def num_jobs(self) -> int:
        return len(self._sojourns)

    def sojourn_stats(self) -> Union["SojournStats", InsufficientTelemetry]:
        """Typed sojourn summary of the recorded (arrival, completion)
        pairs; fewer than ``min_samples`` jobs returns
        ``InsufficientTelemetry`` like the sibling summaries."""
        if self.num_jobs < self.min_samples:
            return InsufficientTelemetry(have=self.num_jobs,
                                         needed=self.min_samples)
        x = np.asarray(self._sojourns, dtype=np.float64)
        mean = float(x.mean())
        var = float(x.var())
        return SojournStats(
            mean=mean,
            p50=float(np.quantile(x, 0.50)),
            p95=float(np.quantile(x, 0.95)),
            p99=float(np.quantile(x, 0.99)),
            dispersion=var / max(mean * mean, 1e-300),
            num_jobs=int(x.size),
        )

    def record_outcomes(self, completed, lost) -> None:
        """Record one step's task outcomes, per worker.

        ``completed`` / ``lost`` are same-length boolean masks over the
        fleet: worker w delivered its task, or worker w's task terminally
        failed (relaunch budget exhausted).  A worker flagged in neither
        mask (still running, cancelled by the job resolving) contributes
        no outcome.  A worker flagged in both raises — a task cannot both
        complete and be lost.
        """
        done = np.asarray(completed, dtype=bool).ravel()
        dead = np.asarray(lost, dtype=bool).ravel()
        if done.shape != dead.shape:
            raise ValueError(
                f"completed/lost masks must have the same shape, got "
                f"{done.shape} vs {dead.shape}")
        if bool((done & dead).any()):
            raise ValueError("a task cannot be both completed and lost")
        for w in np.flatnonzero(done | dead):
            self._outcomes.append((int(w), bool(done[w])))

    def record_retries(self, count: int) -> None:
        """Record the relaunch count of one task attempt chain."""
        c = int(count)
        if c < 0:
            raise ValueError(f"retry count must be >= 0, got {count}")
        self._retries.append(c)

    @property
    def num_samples(self) -> int:
        return len(self._times)

    @property
    def num_outcomes(self) -> int:
        return len(self._outcomes)

    @property
    def num_arrivals(self) -> int:
        return len(self._arrivals)

    def samples(self) -> np.ndarray:
        return np.asarray(self._times, dtype=np.float64)

    # -- model selection ----------------------------------------------------

    def fit(self, task_size=None, scaling=None) -> Tuple[ServiceTime, str]:
        """Best-fitting family among the paper's three, by exact
        log-likelihood (``core.distributions.select_service_time``; the
        seed's finite-difference density was identically ~0 on Bi-Modal's
        step tail, so bimodal could essentially never win selection).

        ``task_size`` / ``scaling`` switch the SCORE to the task-level
        predictive likelihood of s-block sums (additive scaling only) —
        rank models at the size the plan will actually run, not at CU
        granularity; see ``select_service_time``."""
        if self.num_samples < self.min_samples:
            raise ValueError(
                f"not enough telemetry samples "
                f"({self.num_samples} < {self.min_samples})")
        return select_service_time(self.samples(), task_size=task_size,
                                   scaling=scaling)

    def arrival_stats(self) -> Union[ArrivalStats, InsufficientTelemetry]:
        """Typed rate/burstiness summary of the recorded job timestamps.

        A window of fewer than ``min_samples`` interarrival GAPS (note:
        one more timestamp than gaps) returns ``InsufficientTelemetry``
        — the same contract as ``straggle_stats``, instead of the NaN
        mean/variance a short window would otherwise propagate into the
        load-aware planner.
        """
        gaps = np.diff(np.asarray(self._arrivals, dtype=np.float64))
        if gaps.size < self.min_samples:
            return InsufficientTelemetry(have=int(gaps.size),
                                         needed=self.min_samples)
        mean = float(gaps.mean())
        var = float(gaps.var())
        return ArrivalStats(
            rate=1.0 / max(mean, 1e-300),
            mean_gap=mean,
            dispersion=var / max(mean * mean, 1e-300),
            num_gaps=int(gaps.size),
        )

    def fleet_health(self) -> Union[FleetHealth, InsufficientTelemetry]:
        """Typed liveness/loss summary of the recorded task outcomes.

        Fewer than ``min_samples`` outcomes returns
        ``InsufficientTelemetry`` — the short-window contract shared with
        ``straggle_stats``/``arrival_stats``, so a fleet that has barely
        booted cannot read as "everything is down" (or "nothing ever
        fails") off three data points.
        """
        if self.num_outcomes < self.min_samples:
            return InsufficientTelemetry(have=self.num_outcomes,
                                         needed=self.min_samples)
        n = max(w for w, _ in self._outcomes) + 1
        seen = np.zeros(n, dtype=np.int64)
        okc = np.zeros(n, dtype=np.int64)
        for w, ok in self._outcomes:
            seen[w] += 1
            okc[w] += ok
        frac = np.where(seen > 0, (seen - okc) / np.maximum(seen, 1), 0.0)
        return FleetHealth(
            worker_live=tuple(bool(c) for c in okc),
            worker_loss_frac=tuple(float(f) for f in frac),
            loss_rate=float((seen - okc).sum() / seen.sum()),
            retries_per_task=float(np.mean(self._retries))
            if self._retries else 0.0,
            num_outcomes=self.num_outcomes,
        )

    def straggle_stats(self) -> Union[StraggleStats, InsufficientTelemetry]:
        if self.num_samples < self.min_samples:
            return InsufficientTelemetry(have=self.num_samples,
                                         needed=self.min_samples)
        x = self.samples()
        med = float(np.median(x))
        stragglers = x > 2.0 * med
        return StraggleStats(
            median=med,
            p99=float(np.quantile(x, 0.99)),
            straggle_frac=float(stragglers.mean()),
            straggle_magnitude=float(x[stragglers].mean() / med)
            if stragglers.any() else 1.0,
            num_samples=x.size,
        )
