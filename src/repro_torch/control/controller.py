"""The closed-loop redundancy controller.

Dataflow (DESIGN.md §7):

    telemetry batch --> OnlineSelector (streaming fits, forgetting)
                    --> DriftDetector (CUSUM + straggle EWMA vs committed model)
    job timestamps  --> ArrivalEstimator (decayed rate + dispersion)
                    --> LoadDriftDetector (block CUSUM vs committed model)
    task outcomes   --> LossRateEstimator (decayed Bernoulli loss rate)
                    --> FailureDriftDetector (CUSUM vs committed loss rate)
                    --> quarantine + rule-of-three redundancy floor
                        (the fleet-degradation path, DESIGN.md §9)
    drift alarm     --> wait for ``refit_samples`` post-change samples
                        (``arrival_refit_gaps`` clean gaps for a load alarm)
                    --> one-shot exact-likelihood refit of the post-change
                        window (``fit_window``; a load alarm re-commits the
                        arrival model instead — the service fit is kept)
                    --> rule-of-three hedge if the fit claims stragglers
                        are impossible AND its k-curve is flat
                    --> ``Planner.plan`` on the closed-form path
                        (microseconds at production n) — or, in the
                        load-aware objective mode with an arrival model
                        committed, one ``runtime.surface_cache``
                        queueing surface at the estimated rate, run on
                        the objective's device (the card by default)
                    --> hysteresis + switching-cost gate
                    --> actuators (coded training, hedged serving)

Decisions are pure functions of the sample stream and the configuration —
no wall-clock, no internal RNG — so a replayed trace reproduces the exact
same policy trajectory (pinned by tests).

The closed-form planner and the default load-aware objective take the
controller's ``device`` (default ``"cuda"``; pass ``device="cpu"`` for
the host).  A ``LoadAwareLatency`` passed in keeps its own ``device``,
and every surface call and its oracle fallback run there.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .._device import DEFAULT_DEVICE
from ..core.distributions import BiModal, ShiftedExp
from ..core.policy import Policy
from ..core.scenario import Scenario
from ..obs import metrics as _obs_metrics
from ..obs import recorder as _obs_trace
from .detector import (DriftDetector, DriftEvent, FailureDriftDetector,
                       LoadDriftDetector, SojournDriftDetector)
from .estimators import (ArrivalEstimator, ArrivalModel, FittedModel,
                         LossModel, LossRateEstimator, OnlineSelector,
                         SojournEstimator, fit_window, model_median)

__all__ = ["ControlEvent", "ControllerConfig", "RedundancyController",
           "HedgedServeActuator"]

_logger = logging.getLogger(__name__)

#: Fraction of jobs a unit of plan-curve gain accrues to, per objective
#: metric: a p99 curve dropping by one unit moves ~1% of the jobs by
#: that much, so the AMORTIZED switch-cost gate weights a quantile gain
#: by its tail mass before comparing against ``switch_cost`` (the
#: relative hysteresis bar stays in quantile plan-curve units — see
#: DESIGN.md §13).
_TAIL_MASS = {"mean": 1.0, "p50": 0.5, "p95": 0.05, "p99": 0.01}

#: Surface-fallback warnings are rate-limited on the MONOTONIC clock:
#: the first failure logs, then identical warnings are suppressed for
#: this many seconds.  (Only the LOGGING is clocked — the controller's
#: decisions stay wall-clock-free by contract; every fallback still
#: increments the ``controller.surface_fallbacks`` counter and lands on
#: the flight recorder, so suppressed warnings are never lost evidence.)
_FALLBACK_LOG_SECONDS = 30.0
_fallback_last_log: Optional[float] = None

#: Every oracle fallback, suppressed-log or not (obs metrics plane).
_C_FALLBACKS = _obs_metrics.REGISTRY.counter("controller.surface_fallbacks")


def _warn_surface_fallback(exc: BaseException) -> None:
    global _fallback_last_log
    _C_FALLBACKS.inc()
    rec = _obs_trace.active()
    if rec is not None:
        rec.event("oracle_fallback", name=type(exc).__name__,
                  error=str(exc))
    now = time.monotonic()
    if _fallback_last_log is None or \
            now - _fallback_last_log >= _FALLBACK_LOG_SECONDS:
        _logger.warning(
            "surface re-plan failed (%s: %s); falling back to "
            "the oracle engine for this commit (suppressing identical "
            "warnings for the next %.0f s)",
            type(exc).__name__, exc, _FALLBACK_LOG_SECONDS)
        _fallback_last_log = now


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs of the control loop (all sample counts are CU samples)."""

    boot_samples: int = 96      # evidence before the first committed plan
    refit_samples: int = 96     # post-change samples before a drift commit
    max_window: int = 1024      # refit window cap
    hysteresis: float = 0.10    # min relative predicted gain to switch k
    switch_cost: float = 0.0    # absolute time units charged per switch
    amortize_steps: int = 100   # steps a switch is amortized over
    refresh_every: int = 1024   # streaming-estimate resync cadence; 0 = off
    hedge: bool = True          # rule-of-three rare-straggler hedge
    hedge_B: float = 100.0      # hedge straggler magnitude (plan-insensitive
                                # beyond ~100x, cf. elastic.failure_adjusted_model)
    hedge_flat_tol: float = 0.15  # curve spread below which the fit carries
                                  # no k-preference and the hedge may decide
    forget: float = 0.999       # streaming estimator forgetting
    buffer: int = 4096          # telemetry ring for change-point refits
    arrival_forget: float = 0.998   # arrival-estimator forgetting
    arrival_min_gaps: int = 16  # gaps before the first arrival commit
    arrival_refit_gaps: int = 48    # clean post-alarm gaps before a load
                                    # commit (the estimator is reset at the
                                    # alarm, so these are post-change)
    arrival_refresh_gaps: int = 256     # periodic load-recommit cadence (a
                                        # slow drift the CUSUM won't alarm
                                        # on still reaches the plan); 0=off
    arrival_block: int = 12     # gaps per load-CUSUM block
    loss_forget: float = 0.998  # loss-rate estimator forgetting
    loss_min_outcomes: int = 32     # outcomes before the first loss commit
    loss_refit_outcomes: int = 32   # clean post-alarm outcomes before a
                                    # failure commit (the estimator is reset
                                    # at the alarm, so these are post-change)
    quarantine_loss: float = 0.5    # decayed per-worker loss fraction at or
                                    # beyond which a worker is quarantined
    quarantine_weight: float = 8.0  # per-worker evidence mass (outcome
                                    # count decayed on the fleet-wide
                                    # outcome clock) before quarantine
                                    # may fire — three unlucky losses on
                                    # a barely observed worker are not a
                                    # crash loop.  Must sit below the
                                    # per-worker saturation mass
                                    # ~1/(1 - loss_forget^n) or no
                                    # worker can ever reach it
    loss_refresh_outcomes: int = 1024   # periodic loss-recommit cadence:
                                        # a healed worker whose storm-era
                                        # evidence has decayed is restored
                                        # here even when the CUSUM never
                                        # alarms again (p0 ~ 0 after the
                                        # heal commit leaves nothing for
                                        # the down side to detect); 0=off
    #: candidate task placements for (k, assignment) co-optimization in
    #: load-aware mode (``repro_torch.assign`` strategies; () = placement
    #: off, every plan is all-workers fan-out).  Put ``AllWorkers()`` first:
    #: ties then prefer the paper's dispatch.  A ``SpeedAware`` entry
    #: without explicit speeds is re-resolved against the controller's
    #: measured per-worker estimates at every commit — slow-machine
    #: packing, quarantine, and redundancy become one decision.
    assignments: Tuple = ()
    speed_forget: float = 0.995     # per-step decay of the per-worker
                                    # speed accumulators
    speed_min_mass: float = 4.0     # decayed per-worker sample mass
                                    # before its own estimate is trusted
                                    # (below: neutral 1.0)
    sojourn_forget: float = 0.995   # completion-ordered sojourn-moment
                                    # forgetting (control.estimators.
                                    # SojournEstimator)
    sojourn_min_jobs: int = 48      # (arrival, completion) pairs before
                                    # the sojourn channel is trusted, and
                                    # fresh jobs after a commit before it
                                    # may page again
    sojourn_band: float = 0.75      # sojourn-inflation alarm band
                                    # (SojournDriftDetector)
    sojourn_refit_gaps: int = 16    # clean post-alarm gaps before a
                                    # SOJOURN-armed load commit: the
                                    # inflation band only trips on large
                                    # shifts, so a short refit buys speed
                                    # without the marginal channels'
                                    # false-commit risk
    arrival_emergency_ratio: float = 5.0    # pending-load commits fire at
                                    # arrival_min_gaps (skipping the refit
                                    # floor) when the clean post-alarm rate
                                    # sits beyond this factor of the
                                    # committed rate, either way: a shift
                                    # that large is beyond any MMPP dwell's
                                    # aliasing, and waiting out the refit
                                    # floor deepens a backlog (up) or
                                    # strands an over-provisioned plan
                                    # (down).  0 = off

    def __post_init__(self):
        if self.boot_samples < 2 or self.refit_samples < 2:
            raise ValueError("boot/refit sample minimums must be >= 2")
        if not (0.0 <= self.hysteresis):
            raise ValueError("hysteresis must be >= 0")
        if not (0.0 < self.arrival_forget <= 1.0):
            raise ValueError(
                f"arrival_forget must be in (0, 1], got {self.arrival_forget}")
        if self.arrival_min_gaps < 2 or self.arrival_block < 2:
            raise ValueError("arrival_min_gaps and arrival_block must be >= 2")
        if self.arrival_refresh_gaps < 0:
            raise ValueError(
                f"arrival_refresh_gaps must be >= 0 (0 = off), "
                f"got {self.arrival_refresh_gaps}")
        if self.arrival_refit_gaps < self.arrival_min_gaps:
            raise ValueError(
                "arrival_refit_gaps must be >= arrival_min_gaps "
                f"({self.arrival_refit_gaps} < {self.arrival_min_gaps})")
        if not (0.0 < self.loss_forget <= 1.0):
            raise ValueError(
                f"loss_forget must be in (0, 1], got {self.loss_forget}")
        if self.loss_min_outcomes < 2 or self.loss_refit_outcomes < 2:
            raise ValueError(
                "loss_min_outcomes and loss_refit_outcomes must be >= 2")
        if not (0.0 < self.quarantine_loss <= 1.0):
            raise ValueError(
                f"quarantine_loss must be in (0, 1], "
                f"got {self.quarantine_loss}")
        if self.quarantine_weight <= 0.0:
            raise ValueError(
                f"quarantine_weight must be > 0, "
                f"got {self.quarantine_weight}")
        if self.loss_refresh_outcomes < 0:
            raise ValueError(
                f"loss_refresh_outcomes must be >= 0 (0 = off), "
                f"got {self.loss_refresh_outcomes}")
        if self.assignments:
            from ..assign.strategies import Assignment
            for a in self.assignments:
                if not isinstance(a, Assignment):
                    raise TypeError(
                        f"assignments must be Assignment strategies, "
                        f"got {a!r}")
        if not (0.0 < self.speed_forget <= 1.0):
            raise ValueError(
                f"speed_forget must be in (0, 1], got {self.speed_forget}")
        if self.speed_min_mass <= 0.0:
            raise ValueError(
                f"speed_min_mass must be > 0, got {self.speed_min_mass}")
        if not (0.0 < self.sojourn_forget <= 1.0):
            raise ValueError(
                f"sojourn_forget must be in (0, 1], got {self.sojourn_forget}")
        if self.sojourn_min_jobs < 2:
            raise ValueError(
                f"sojourn_min_jobs must be >= 2, got {self.sojourn_min_jobs}")
        if self.sojourn_band <= 0.0:
            raise ValueError(
                f"sojourn_band must be > 0, got {self.sojourn_band}")
        if self.sojourn_refit_gaps < 2:
            raise ValueError(
                f"sojourn_refit_gaps must be >= 2, got "
                f"{self.sojourn_refit_gaps}")
        if self.arrival_emergency_ratio < 0.0 or \
                0.0 < self.arrival_emergency_ratio <= 1.0:
            raise ValueError(
                f"arrival_emergency_ratio must be 0 (off) or > 1, got "
                f"{self.arrival_emergency_ratio}")


@dataclasses.dataclass(frozen=True)
class ControlEvent:
    """One committed control decision (model and/or policy update)."""

    kind: str        # "boot" | "drift" | "refresh" | "load" | "failure"
    at: int                     # absolute CU-sample index of the commit
    model: FittedModel
    hedged: bool                # planned under the rare-straggler hedge
    old_policy: Policy
    new_policy: Policy          # == old_policy when the gate held the switch
    switched: bool
    replan_ms: float            # wall time of the Planner.plan call
    drift: Optional[DriftEvent] = None
    arrival: Optional[ArrivalModel] = None  # arrival model planned under
    cached: bool = False        # re-planned on a surface-cache queueing
                                # curve (vs the closed form)
    warm: bool = False          # ... and that call's structural key was
                                # already seen (False on the first call
                                # of a new (family, ..., bucket) key)
    loss: Optional[LossModel] = None    # loss model planned under
    quarantined: Tuple[int, ...] = ()   # workers excluded from the plan
    fallback: bool = False      # the sweep backend failed and the commit
                                # re-planned on the oracle engine instead
    metric: str = "mean"        # the objective metric the plan rode: a
                                # quantile ("p95"/"p99") means the curve
                                # was the tail row of the surface

    @property
    def family(self) -> str:
        return self.model.family


class Actuator:
    """Anything that applies a committed (policy, model) to the runtime."""

    def apply(self, policy: Policy, model: FittedModel) -> None:
        raise NotImplementedError


class TrainerActuator(Actuator):
    """Re-plans a ``CodedTrainer`` in place: swaps its step config to the
    new policy (the step_cfg setter rebuilds the step), rounding the
    unique batch by the shared ``elastic.round_unique_batch`` contract."""

    def __init__(self, trainer):
        self.trainer = trainer
        # round from the ORIGINAL unique batch on every apply — rounding
        # from the current (already-rounded) config would ratchet the
        # global batch monotonically upward across re-plans and never
        # restore it when a compatible k returns
        self.base_unique_batch = int(trainer.step_cfg.unique_batch)
        self.adjustments: List[int] = []    # logged unique-batch roundings

    def apply(self, policy: Policy, model: FittedModel) -> None:
        from ..runtime.coded_step import CodedStepConfig
        from ..runtime.elastic import round_unique_batch
        rounded, adj = round_unique_batch(self.base_unique_batch,
                                          policy.num_groups)
        cfg = CodedStepConfig.from_policy(policy, unique_batch=rounded)
        if cfg == self.trainer.step_cfg:
            return    # actuators fire on EVERY commit; don't rebuild the
                      # step when the config is unchanged
        if adj:
            self.adjustments.append(adj)
        self.trainer.step_cfg = cfg


class HedgedServeActuator(Actuator):
    """Re-plans the hedged-serving replica count from the committed model
    (``launch.serve.plan_replicas``; the hedge gain is a tail RATIO, so
    the unit-convention BiModal scale cancels), and derives the hedge
    FIRE DELAY from the committed plan.

    ``hedge_delay`` is the raw-time instant (after a request's own
    arrival) at which the backup fires.  On every commit ``apply`` sets
    the single-job fallback — the fitted model's straggler cut — and
    when the controller planned on a load-aware surface it additionally
    hands every actuator the raw-time TAIL row of the committed curve
    (``apply_plan``): the delay then becomes the plan's own tail latency
    at the committed k, so hedging fires where the COMMITTED objective
    says the tail begins (queueing included) instead of at a single-job
    model heuristic.  ``delay_source`` records which path set it."""

    def __init__(self, max_r: int = 4, cost_weight: float = 0.25):
        self.max_r = max_r
        self.cost_weight = cost_weight
        self.replicas = 1
        self.hedge_delay: Optional[float] = None
        self.delay_source = "model"

    def apply(self, policy: Policy, model: FittedModel) -> None:
        from ..launch.serve import plan_replicas
        self.replicas = plan_replicas(model.dist, max_r=self.max_r,
                                      cost_weight=self.cost_weight)
        self.hedge_delay = model.straggle_threshold()
        self.delay_source = "model"

    def apply_plan(self, policy: Policy, model: FittedModel,
                   tail_curve, unit: float) -> None:
        """Adopt the committed plan's tail latency at the committed k
        (``tail_curve`` is already in raw time units); a missing or
        non-finite entry keeps the ``apply`` fallback."""
        if not tail_curve:
            return
        v = tail_curve.get(policy.k)
        if v is not None and math.isfinite(v):
            self.hedge_delay = float(v)
            self.delay_source = "plan"


class RedundancyController:
    """Closed-loop (n, k) control for one scenario skeleton.

    ``scenario`` fixes everything but the service-time law: n, the
    scaling model, exogenous delta, constraints.  Its ``dist`` is the
    PRIOR — it sets the initial policy until ``boot_samples`` of real
    telemetry arrive.  ``observe`` is the single entry point: feed it the
    per-CU completion times of each step and it returns a ``ControlEvent``
    when (and only when) a commit happened.

    ``objective`` selects the planning mode.  Any ordinary ``Objective``
    (or None, the paper's mean) re-plans on the single-job closed form.
    The string ``"load_aware"`` — or a ``LoadAwareLatency`` instance for
    explicit queueing knobs — turns on LOAD-AWARE control: pass job
    arrival ``timestamp``s to ``observe`` and the controller estimates
    the arrival process (rate + burstiness with exponential forgetting),
    watches it with a block-CUSUM load-drift channel, and once an
    arrival model is committed every re-plan routes through the batched
    cluster engine at the estimated load (a surface-cache call,
    ``runtime.surface_cache``, on the objective's device) instead of the
    closed form — under
    arrivals, redundancy also consumes service capacity, so the
    single-job optimum systematically over-provisions.  Until the first
    arrival commit (or when timestamps are never supplied) it plans with
    the closed form, exactly like the single-job mode.
    """

    def __init__(self, scenario: Scenario,
                 objective=None,
                 config: Optional[ControllerConfig] = None,
                 detector: Optional[DriftDetector] = None,
                 selector: Optional[OnlineSelector] = None,
                 actuators: Sequence[Actuator] = (),
                 slo=None, slo_drift: bool = True,
                 device=DEFAULT_DEVICE):
        from ..api import LoadAwareLatency, MeanCompletionTime, Planner
        closed_form = MeanCompletionTime(device=device)
        self.scenario = scenario
        self.config = config or ControllerConfig()
        #: optional streaming SLO monitor (``obs.slo.SLOMonitor``):
        #: ``observe(latency=...)`` feeds it, and with ``slo_drift``
        #: a multi-window burn alarm becomes a pending service drift —
        #: the SLO channel joins the CUSUM/EWMA channels as an alarm
        #: source, resolved by the normal refit-commit path.
        self.slo = slo
        self.slo_drift = bool(slo_drift)
        if isinstance(objective, str):
            if objective != "load_aware":
                raise ValueError(
                    f"unknown objective mode {objective!r} "
                    f"(the only string mode is 'load_aware')")
            # controller defaults: short surfaces, a couple of CRN reps
            objective = LoadAwareLatency(num_jobs=600, reps=2,
                                         backend="cached", device=device)
        if isinstance(objective, LoadAwareLatency):
            self.load_objective: Optional[LoadAwareLatency] = objective
            # closed form until arrivals commit
            self.planner = Planner(closed_form)
        else:
            self.load_objective = None
            self.planner = Planner(closed_form if objective is None
                                   else objective)
        self.detector = detector or DriftDetector()
        self.selector = selector or OnlineSelector(forget=self.config.forget)
        self.actuators = list(actuators)
        self._policy = self.planner.plan(scenario).policy
        self.model: Optional[FittedModel] = None
        self.events: List[ControlEvent] = []
        self._buffer = collections.deque(maxlen=self.config.buffer)
        self._seen = 0
        self._pending: Optional[DriftEvent] = None
        self._last_commit = 0
        # -- the arrival (load) side ----------------------------------------
        self.arrival_estimator = ArrivalEstimator(
            forget=self.config.arrival_forget,
            min_gaps=self.config.arrival_min_gaps,
            block=self.config.arrival_block)
        self.load_detector = LoadDriftDetector()
        self.arrival_model: Optional[ArrivalModel] = None
        self._pending_load: Optional[DriftEvent] = None
        self._gaps_seen = 0
        self._last_load_commit = 0
        # -- the failure (fleet-degradation) side ---------------------------
        self.loss_estimator = LossRateEstimator(
            forget=self.config.loss_forget,
            min_outcomes=self.config.loss_min_outcomes)
        self.failure_detector = FailureDriftDetector()
        self.loss_model: Optional[LossModel] = None
        self.quarantined: Tuple[int, ...] = ()
        self._pending_loss: Optional[DriftEvent] = None
        self._outcomes_seen = 0
        self._last_loss_commit = 0
        self._w_out = np.zeros(scenario.n)    # decayed per-worker outcomes
        self._w_loss = np.zeros(scenario.n)   # decayed per-worker losses
        self._fell_back = False
        # -- the completion-ordered (sojourn) side ---------------------------
        self.sojourn_estimator = SojournEstimator(
            forget=self.config.sojourn_forget,
            min_jobs=self.config.sojourn_min_jobs)
        self.sojourn_detector = SojournDriftDetector(
            band=self.config.sojourn_band,
            min_jobs=self.config.sojourn_min_jobs)
        self._jobs_seen = 0
        # -- the placement (assignment) side --------------------------------
        self._w_time = np.zeros(scenario.n)   # decayed per-worker service
        self._w_tcnt = np.zeros(scenario.n)   # sums and sample masses
        self._co_curve = None     # (assignments, ks, (A, K) cube) of the
        #                           last co-optimized re-plan, for the
        #                           placement hysteresis gate
        self._tail_curve = None   # k -> raw-time tail latency of the last
        #                           load-aware surface, for hedge actuation

    # -- read side ----------------------------------------------------------
    @property
    def policy(self) -> Policy:
        return self._policy

    @property
    def num_samples(self) -> int:
        return self._seen

    @property
    def switches(self) -> List[ControlEvent]:
        return [e for e in self.events if e.switched]

    def measured_speeds(self) -> Optional[Tuple[float, ...]]:
        """Median-normalized per-worker speed multipliers from the
        decayed accumulators (the ``Telemetry.worker_speed_stats``
        convention: larger = slower).  None until at least one worker
        clears the evidence floor; workers individually below it read as
        neutral 1.0."""
        mass = self._w_tcnt
        good = mass >= self.config.speed_min_mass
        if not good.any():
            return None
        est = self._w_time / np.maximum(mass, 1e-300)
        med = float(np.median(est[good]))
        speeds = np.ones(mass.size)
        speeds[good] = est[good] / max(med, 1e-300)
        return tuple(float(s) for s in speeds)

    def drift_events(self) -> List[ControlEvent]:
        return [e for e in self.events if e.kind == "drift"]

    # -- the loop -----------------------------------------------------------
    def observe(self, worker_times: np.ndarray,
                timestamp: Optional[float] = None,
                losses: Optional[np.ndarray] = None,
                latency: Optional[float] = None,
                completion: Optional[float] = None
                ) -> Optional[ControlEvent]:
        """Feed one step's per-CU completion times; maybe commit.

        ``timestamp`` is the job's absolute arrival instant (any monotone
        clock): it feeds the arrival-rate estimator and the load-drift
        channel.  Omitting it leaves the load side dormant — the
        controller then behaves exactly like the single-job mode.

        ``losses`` is a per-worker boolean mask: worker w's task of this
        step was terminally LOST (crash-relaunch budget exhausted).
        Workers with a finite entry in ``worker_times`` count as
        completions; flagged workers count as losses; the rest (still
        running, cancelled by the job resolving) contribute no outcome.
        Supplying it turns on the fleet-degradation path — loss-rate
        estimation, the failure-drift CUSUM, quarantine, and the
        rule-of-three redundancy floor.  Omitting it leaves that side
        dormant, exactly like the load side without timestamps.

        ``latency`` is the step/job's observed END-TO-END completion
        latency (queueing included).  With an ``slo`` monitor attached
        it feeds the streaming p-quantile-vs-target state; a
        multi-window burn alarm is recorded on the flight recorder and
        (under ``slo_drift``) parked as a pending service drift, so a
        blown SLO re-fits and re-plans through exactly the machinery a
        CUSUM alarm uses.  Omitting it (or the monitor) leaves the SLO
        side dormant, like the other optional channels.

        ``completion`` is the job's absolute completion instant; paired
        with ``timestamp`` it feeds the completion-ordered sojourn
        channel (``SojournEstimator`` + ``SojournDriftDetector``) — the
        end-to-end latency a serving master actually sees.  A sojourn
        inflation alarm re-plans at the CURRENT arrival estimate through
        the load-commit path, catching queueing-regime shifts that move
        neither the service marginal nor the committed arrival model far
        enough to alarm on their own.  Requires the load-aware objective;
        dormant otherwise, like the other optional channels.

        When the scenario carries an exogenous per-CU ``delta`` (known
        deterministic work), the controller estimates the NOISE
        distribution: delta is subtracted here once and re-injected at
        planning time.  Fitting the raw times would absorb delta into the
        fitted parameters and the re-plan scenario would then add it
        again — a double count that distorts the whole k-curve.
        """
        if latency is not None and self.slo is not None:
            slo_alarm = self.slo.observe(latency)
            if slo_alarm is not None:
                rec = _obs_trace.active()
                if rec is not None:
                    rec.event(
                        "slo_alarm", name="slo_burn", at=slo_alarm.at,
                        sample=self._seen, burn_fast=slo_alarm.burn_fast,
                        burn_slow=slo_alarm.burn_slow,
                        threshold=slo_alarm.threshold,
                        target=slo_alarm.target,
                        quantile_est=slo_alarm.quantile_est)
                if self.slo_drift and self._pending is None:
                    # the burn alarm is anchored at the CURRENT sample
                    # index: everything after it is post-breach by
                    # construction, the same anchoring rule as
                    # _maybe_drift_commit's alarm-index window
                    self._pending = DriftEvent(
                        kind="slo_burn", at=self._seen, start=self._seen,
                        stat=slo_alarm.burn_fast,
                        threshold=slo_alarm.threshold)
        raw = np.asarray(worker_times, dtype=np.float64).ravel()
        if raw.size == self.scenario.n:
            # positional per-worker speed attribution (same alignment
            # rule as the quarantine counters): decayed per-worker mean
            # service times feed SpeedAware placement re-plans
            fin = np.isfinite(raw) & (raw > 0)
            self._w_time *= self.config.speed_forget
            self._w_tcnt *= self.config.speed_forget
            self._w_time[fin] += raw[fin]
            self._w_tcnt[fin] += 1.0
        x = raw[np.isfinite(raw)]
        if x.size == 0:
            # the job still ARRIVED even if its step produced no finite
            # telemetry (failed/timed-out step): dropping the timestamp
            # would merge two arrivals into one doubled gap and bias the
            # rate estimate low.  Its outcomes still RESOLVED, too — a
            # step whose every task crashed out is exactly the signal
            # the failure channel exists for
            load_event = self._observe_arrival(timestamp)
            loss_event = self._observe_losses(
                raw, losses, allow_commit=load_event is None)
            self._observe_sojourn(timestamp, completion)
            for ev in (load_event, loss_event):
                if ev is not None:
                    return ev
            return None
        if self.scenario.delta is not None:
            x = np.maximum(x - self.scenario.delta, 1e-12)
        start = self._seen
        self._seen += x.size
        self._buffer.extend(x.tolist())
        self.selector.update(x)
        load_event = self._observe_arrival(timestamp)
        loss_event = self._observe_losses(raw, losses,
                                          allow_commit=load_event is None)
        self._observe_sojourn(timestamp, completion)

        if self.model is None:                           # bootstrapping
            if self._seen < self.config.boot_samples:
                return None
            if self.load_objective is not None and timestamp is not None \
                    and not self.arrival_estimator.ready:
                # timestamps ARE flowing (this very observation carries
                # one): hold the boot until the arrival model can commit
                # alongside, so the very first committed plan is
                # load-aware — a closed-form boot can pick a single-job k
                # (e.g. full replication) whose un-preempted remnants
                # poison the queue long after the load-aware re-plan
                # corrects it.  A caller that STOPS supplying timestamps
                # falls through to the closed-form boot on the next
                # timestamp-less observation instead of wedging forever.
                return None
            return self._commit("boot", self._window(self._seen))
        if load_event is not None or loss_event is not None:
            # the service channel still sees this batch: a load/failure
            # commit does not rebase the service detector (see _commit),
            # so its statistics keep accumulating; a service alarm
            # raised here is parked and committed by the normal drift
            # path
            alarm = self.detector.update(x, at=start)
            if alarm is not None and self._pending is None:
                self._pending = alarm
                self._trace_alarm("service", alarm)
            for ev in (load_event, loss_event):
                if ev is not None:
                    return ev

        if self._pending is not None:                    # drift: wait + refit
            return self._maybe_drift_commit()

        alarm = self.detector.update(x, at=start)
        if alarm is not None:
            self._pending = alarm
            self._trace_alarm("service", alarm)
            return self._maybe_drift_commit()

        if self.config.refresh_every and \
                self._seen - self._last_commit >= self.config.refresh_every:
            model = self.selector.best()
            if model is not None:
                return self._commit("refresh", window=None, model=model)
            self._last_commit = self._seen     # nothing to sync yet
        return None

    def _observe_arrival(self, timestamp: Optional[float]
                         ) -> Optional[ControlEvent]:
        """The load side of one observation: estimator update, load-drift
        CUSUM, and (maybe) a "load" commit.  Returns the commit event, or
        None.  A no-op without a timestamp or a load-aware objective."""
        if timestamp is None:
            return None
        est = self.arrival_estimator
        had_last = est.primed
        est.observe(timestamp)
        if not had_last:
            return None                        # first instant: no gap yet
        gap_idx = self._gaps_seen
        self._gaps_seen += 1
        if self.load_objective is None:
            return None                        # estimation only, no control
        if self.arrival_model is None:
            # arrival boot: commit as soon as the evidence floor is met
            # AND the service side has booted (plans need both models)
            if est.ready and self.model is not None:
                return self._commit("load", window=None, model=self.model)
            return None
        if self._pending_load is None:
            alarm = self.load_detector.update(
                np.asarray([est.last_gap]), at=gap_idx)
            if alarm is not None:
                self._pending_load = alarm
                self._trace_alarm("load", alarm)
                est.reset()          # clean post-change gap accumulation
                return None
            if self.config.arrival_refresh_gaps and \
                    self._gaps_seen - self._last_load_commit >= \
                    self.config.arrival_refresh_gaps and \
                    self.load_detector.charge < 0.25:
                # periodic resync to the decayed estimate: slow drifts
                # (e.g. burstiness bleeding away after a burst regime)
                # reach the plan without ever alarming; silent unless
                # the policy actually moves.  Held off while a CUSUM side
                # is charged — the recommit would rebase away evidence an
                # in-progress change has banked
                return self._commit("load", window=None, model=self.model,
                                    quiet=True)
            return None
        need = self.config.sojourn_refit_gaps \
            if self._pending_load.kind.startswith("sojourn") \
            else self.config.arrival_refit_gaps
        enough = est.num_gaps >= max(need, self.config.arrival_min_gaps)
        if not enough and self.config.arrival_emergency_ratio and \
                est.num_gaps >= self.config.arrival_min_gaps:
            # emergency refit: the clean post-alarm gaps already prove a
            # rate shift no MMPP dwell can fake, and every job spent
            # waiting for the refit floor either deepens a backlog the
            # eventual plan must drain (up) or leaves the fleet planned
            # for a world that ended (down)
            ratio = est.rate() / self.arrival_model.rate
            if ratio >= self.config.arrival_emergency_ratio or \
                    ratio <= 1.0 / self.config.arrival_emergency_ratio:
                enough = True
        if enough:
            ev = self._commit("load", window=None, model=self.model,
                              drift=self._pending_load)
            self._pending_load = None
            return ev
        return None

    def _observe_sojourn(self, arrival: Optional[float],
                         completion: Optional[float]) -> None:
        """The completion-ordered side of one observation: sojourn-moment
        update, inflation-band check, and (maybe) ARMING a "load" commit.
        A no-op without an (arrival, completion) pair or a load-aware
        objective.

        An inflation alarm does not commit by itself: the decayed
        arrival-rate estimate is exactly what a sudden regime shift
        leaves STALE (a 10x flash crowd takes hundreds of gaps to move
        a decayed mean), so committing at it would re-plan for the old
        world — and, worse, rebase the load CUSUM away from the very
        evidence the shift is banking.  Instead the alarm pre-empts the
        marginal detector: it becomes the pending load alarm and resets
        the arrival estimator, so the normal refit path commits a few
        gaps later at the CLEAN post-change rate.  The channel's speed
        is in the ALARM — queue inflation shows up in completions many
        jobs before gap statistics can prove a rate change.
        """
        if arrival is None or completion is None:
            return None
        est = self.sojourn_estimator
        est.observe(arrival, completion)
        self._jobs_seen += 1
        if self.load_objective is None or self.model is None or \
                not est.ready:
            return None
        if self.sojourn_detector.reference is None:
            # first eligible observation anchors the reference; the
            # detector's own min_jobs cooldown runs from here
            self.sojourn_detector.rebase(est.mean(), at=self._jobs_seen)
            return None
        if self._pending_load is not None or \
                not self.arrival_estimator.primed:
            return None          # the refit path already owns the commit
        alarm = self.sojourn_detector.update(est.mean(), at=self._jobs_seen)
        if alarm is None:
            return None
        self._trace_alarm("sojourn", alarm)
        self._pending_load = alarm
        self.arrival_estimator.reset()   # clean post-change gaps only
        return None

    def _observe_losses(self, raw: np.ndarray,
                        losses: Optional[np.ndarray],
                        allow_commit: bool = True
                        ) -> Optional[ControlEvent]:
        """The failure side of one observation: loss-rate estimator
        update, per-worker liveness accounting, failure-drift CUSUM, and
        (maybe) a "failure" commit.  A no-op without a ``losses`` mask.

        ``allow_commit=False`` still absorbs the outcomes but defers any
        ready commit to the next observation — one observation commits at
        most one event, and a simultaneous load commit takes precedence.
        """
        if losses is None:
            return None
        lost = np.asarray(losses, dtype=bool).ravel()
        n = self.scenario.n
        if lost.size != n:
            raise ValueError(
                f"losses must be a per-worker mask of length n={n}, "
                f"got {lost.size}")
        # positional per-worker attribution when the step reports one
        # time per worker; a pooled multi-task step still feeds the
        # pooled estimator, just not the per-worker quarantine counters
        aligned = raw.size == n
        done = (np.isfinite(raw) & ~lost) if aligned \
            else np.zeros(n, dtype=bool)
        if aligned:
            # worker order, not successes-then-losses: a fixed batch
            # ordering would phase-lock the failure CUSUM to the step
            outcomes = lost[done | lost]
        else:
            outcomes = np.concatenate(
                [np.zeros(int(np.isfinite(raw).sum()), dtype=bool),
                 np.ones(int(lost.sum()), dtype=bool)])
        if outcomes.size == 0:
            return None
        # per-worker counters forget on the OUTCOME clock (one unit per
        # recorded outcome, same clock as the pooled estimator and the
        # refresh cadence) — not per observe() call.  A quarantined
        # worker produces no outcomes, so its storm-era evidence decays
        # with the surviving fleet's throughput and the probational
        # restore arrives within a bounded number of fleet outcomes; a
        # per-call decay would stretch that by a factor n and strand a
        # healed worker in quarantine long after the storm
        d = self.config.loss_forget ** outcomes.size
        self._w_out *= d
        self._w_loss *= d
        self._w_out += done + lost
        self._w_loss += lost
        start = self._outcomes_seen
        self._outcomes_seen += outcomes.size
        self.loss_estimator.observe(outcomes)
        if self.loss_model is None:
            # failure boot: commit as soon as the evidence floor is met
            # AND the service side has booted (the plan needs a model)
            if allow_commit and self.loss_estimator.ready and \
                    self.model is not None:
                return self._commit("failure", window=None,
                                    model=self.model)
            return None
        if self._pending_loss is None:
            alarm = self.failure_detector.update(outcomes, at=start)
            if alarm is not None:
                self._pending_loss = alarm
                self._trace_alarm("failure", alarm)
                self.loss_estimator.reset()     # clean post-change stream
                return None
            if allow_commit and self.config.loss_refresh_outcomes and \
                    self._outcomes_seen - self._last_loss_commit >= \
                    self.config.loss_refresh_outcomes and \
                    self.failure_detector.banked < 0.25:
                # periodic resync to the decayed loss estimate: tracks
                # slow loss drifts the CUSUM was not designed against,
                # quarantines a persistent crash-looper once its healthy
                # history decays, and restores one whose storm-era
                # evidence decayed away; silent unless the policy moves.
                # Held off only while the up side has CROSS-batch banked
                # evidence (rebasing would erase it); neither the
                # end-of-batch up value (pinned above zero by a matched
                # steady stream's own within-step losses) nor the down
                # side (a genuine heal alarms within a few steps by
                # itself) gates — either would starve the resync exactly
                # when quarantine needs it
                return self._commit("failure", window=None,
                                    model=self.model, quiet=True)
            return None
        if allow_commit and \
                self.loss_estimator.num_outcomes >= \
                self.config.loss_refit_outcomes:
            ev = self._commit("failure", window=None, model=self.model,
                              drift=self._pending_loss)
            self._pending_loss = None
            return ev
        return None

    def _refresh_quarantine(self) -> None:
        """Re-derive the quarantine set from the decayed per-worker loss
        fractions.  Quarantine is evidence-bound, not sticky: a worker
        that stops producing outcomes decays below the evidence floor
        and is probationally restored — the next failure commit removes
        it again if the crash loop persists."""
        cfg = self.config
        frac = self._w_loss / np.maximum(self._w_out, 1e-12)
        bad = [w for w in range(self.scenario.n)
               if self._w_out[w] >= cfg.quarantine_weight
               and frac[w] >= cfg.quarantine_loss]
        # never quarantine below the smallest legal k of the full
        # scenario: drop the worst offenders first, keep the rest
        max_drop = self.scenario.n - min(self.scenario.legal_ks())
        if len(bad) > max_drop:
            bad = sorted(bad, key=lambda w: frac[w],
                         reverse=True)[:max_drop]
        previous = self.quarantined
        self.quarantined = tuple(sorted(bad))
        if self.quarantined != previous:
            rec = _obs_trace.active()
            if rec is not None:
                rec.event("quarantine", name="refresh",
                          at=self._seen, workers=self.quarantined,
                          previous=previous)

    def _degraded(self, scenario: Scenario) -> Scenario:
        """The plan scenario after graceful degradation: quarantined
        workers leave the fleet (n shrink + worker_speeds subset), and
        the committed loss model floors the redundancy — no legal k may
        leave fewer parity tasks than the rule-of-three loss rate
        predicts losing per job (capped at half the fleet), so in
        particular k = n (zero redundancy) is off the table whenever ANY
        loss evidence is committed."""
        if self.loss_model is None:
            return scenario
        drop = set(w for w in self.quarantined if w < scenario.n)
        if drop:
            keep = [w for w in range(scenario.n) if w not in drop]
            nn = len(keep)
            speeds = None if scenario.worker_speeds is None else \
                tuple(scenario.worker_speeds[w] for w in keep)
            cks = scenario.candidate_ks
            if cks is not None:
                cks = tuple(k for k in cks if k <= nn and nn % k == 0)
            if cks != () and nn >= 1:
                try:
                    shrunk = dataclasses.replace(
                        scenario, n=nn, worker_speeds=speeds,
                        candidate_ks=cks)
                    shrunk.legal_ks()
                    scenario = shrunk
                except ValueError:
                    pass    # no legal k at the shrunk size: keep the
                            # full fleet and rely on the k floor below
        need = int(math.ceil(
            scenario.n * min(self.loss_model.upper, 0.5)))
        if need > 0:
            ks = scenario.legal_ks()
            floored = [k for k in ks if scenario.n - k >= need] \
                or [min(ks)]
            if floored != ks:
                scenario = dataclasses.replace(
                    scenario, candidate_ks=tuple(floored))
        return scenario

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _trace_alarm(channel: str, alarm: DriftEvent) -> None:
        """One detector crossing onto the flight recorder (no-op when
        tracing is disabled — the guard precedes any payload build)."""
        rec = _obs_trace.active()
        if rec is not None:
            rec.event("drift_alarm", name=channel, channel=channel,
                      alarm_kind=alarm.kind, at=alarm.at,
                      start=alarm.start, stat=alarm.stat,
                      threshold=alarm.threshold)

    def _maybe_drift_commit(self) -> Optional[ControlEvent]:
        """Commit the pending drift once enough GUARANTEED post-change
        samples exist.  The window is anchored at the ALARM index, not the
        CUSUM start estimate: the estimate can reach back into pre-change
        wander (the statistic need not have sat at zero when the change
        hit), and a contaminated window misfits the family; everything
        after the alarm is post-change by construction."""
        if self._seen - self._pending.at < self.config.refit_samples:
            return None
        ev = self._commit(
            "drift", self._window(self._seen - self._pending.at),
            drift=self._pending)
        self._pending = None
        return ev

    def _window(self, length: int) -> np.ndarray:
        take = min(length, self.config.max_window, len(self._buffer))
        return np.asarray(list(self._buffer)[-take:], dtype=np.float64)

    def _commit(self, kind: str, window: Optional[np.ndarray],
                drift: Optional[DriftEvent] = None,
                model: Optional[FittedModel] = None,
                quiet: bool = False) -> Optional[ControlEvent]:
        fitted = model if model is not None else fit_window(window)
        plan_dist, plan_delta, hedged, unit = self._hedged_plan_dist(fitted)
        scenario = dataclasses.replace(
            self.scenario, dist=plan_dist, delta=plan_delta)
        if kind == "load" or (kind == "boot" and
                              self.load_objective is not None and
                              self.arrival_estimator.ready):
            # a "load" commit is exactly a post-alarm (or boot/refresh)
            # re-estimate of the arrival model; a boot in load-aware mode
            # commits both models at once so the first plan is already
            # load-aware.  Other commit kinds keep the COMMITTED arrival
            # model — it is the load detector's reference, and rebasing
            # it on every service refresh would reset the CUSUM faster
            # than a real load change can accumulate evidence (the load
            # channel would be blind).
            self.arrival_model = self.arrival_estimator.model()
            self.load_detector.rebase(self.arrival_model,
                                      at=self._gaps_seen)
            self._last_load_commit = self._gaps_seen
        if kind == "failure" or (kind == "boot" and
                                 self.loss_estimator.ready):
            # a "failure" commit re-estimates the loss model on the
            # post-alarm outcome stream; a boot with outcomes flowing
            # commits it alongside so the very first plan already
            # carries the redundancy floor.  Other commit kinds keep
            # the COMMITTED loss model — it is the failure detector's
            # reference (the same asymmetry as the arrival model above).
            self.loss_model = self.loss_estimator.model()
            self.failure_detector.rebase(self.loss_model.rate,
                                         at=self._outcomes_seen)
            self._last_loss_commit = self._outcomes_seen
            self._refresh_quarantine()
        scenario = self._degraded(scenario)
        # every engine hands its surface back as host numpy (one
        # synchronising copy), so the card's work lies inside this window
        t0 = time.perf_counter()
        self._fell_back = False
        self._tail_curve = None
        cached = warm = False
        metric = "mean"
        from ..runtime.cluster_batched import InfeasibleSurfaceError
        try:
            with _obs_trace.span("replan", kind=kind, family=fitted.family):
                if self.load_objective is not None and \
                        self.arrival_model is not None:
                    from ..api import Planner
                    metric = self.load_objective.metric
                    cached = self.load_objective.backend == "cached"
                    if cached:
                        from ..runtime.surface_cache import \
                            surface_cache_stats
                        misses0 = surface_cache_stats()["misses"]
                    plan = Planner._finalize(
                        scenario, self._load_aware_curve(scenario, unit))
                    if cached:
                        warm = not self._fell_back and \
                            surface_cache_stats()["misses"] == misses0
                else:
                    plan = self.planner.plan(scenario)
        except InfeasibleSurfaceError as exc:
            # every candidate came back non-finite (failure-storm
            # surface): committing any k would be fiction.  Keep the
            # standing policy, keep the re-committed estimator models
            # (they are valid regardless of plan feasibility), surface
            # the evidence, and let the next alarm retry once the storm
            # moves
            _logger.warning("%s commit aborted: %s", kind, exc)
            rec = _obs_trace.active()
            if rec is not None:
                rec.event("infeasible", name=kind, at=self._seen,
                          error=str(exc))
            return None
        replan_ms = (time.perf_counter() - t0) * 1e3
        new = plan.policy
        old = self._policy
        switched = False
        if new.k != old.k or new.n != old.n:
            # a fleet shrink (quarantine) changed n: the old policy is
            # not comparable on the new curve, the plan must move
            cost_old = plan.curve.get(old.k) if new.n == old.n else None
            cost_new = plan.curve[new.k]
            if cost_old is None:
                switched = True          # old k no longer legal: must move
            else:
                # the curve is in the plan model's time units (normalized
                # low-mode or hedge-typical units); switch_cost is in raw
                # time units, so the absolute gain must be re-scaled.
                # Under a quantile objective the gain is additionally in
                # QUANTILE plan-curve units — tail displacement, not
                # per-job saving — so the amortized leg weights it by the
                # tail mass it moves (_TAIL_MASS); the relative bar rides
                # the quantile curve untouched
                gain = cost_old - cost_new
                rel = gain / max(cost_new, 1e-12)
                tail_w = _TAIL_MASS.get(metric, 1.0)
                switched = (rel >= self.config.hysteresis and
                            gain * tail_w * unit * self.config.amortize_steps
                            >= self.config.switch_cost)
        if switched:
            self._policy = new
        if self._co_curve is not None:
            # placement rides the SAME commit: re-place the final policy
            # (switched or held) at its k through the placement gate.  A
            # held-but-re-placed policy still counts as a switch — the
            # placement masks changed, actuators must redeploy.
            self._policy, placed = self._place(self._policy)
            switched = switched or placed
        # actuators see EVERY committed model, not just k switches —
        # model-dependent actuation (e.g. hedged-serving replicas) must
        # track a family change even when k* happens to stay put
        rec = _obs_trace.active()
        for a in self.actuators:
            # actuators with an ``apply_plan`` hook additionally receive
            # the committed plan's raw-time tail curve (None when the
            # commit rode the closed form) — the hedged-serving delay
            # derives from the plan, not just the model
            plan_hook = getattr(a, "apply_plan", None)
            if rec is None:
                a.apply(self._policy, fitted)
                if plan_hook is not None:
                    plan_hook(self._policy, fitted, self._tail_curve, unit)
            else:
                ta = rec.now()
                a.apply(self._policy, fitted)
                if plan_hook is not None:
                    plan_hook(self._policy, fitted, self._tail_curve, unit)
                rec.event("actuate", name=type(a).__name__,
                          dur=rec.now() - ta, at=self._seen,
                          k=self._policy.k, switched=switched)
        self.model = fitted
        if kind not in ("load", "failure"):
            # a load/failure commit re-plans under an UNCHANGED service
            # model: rebasing the service detector would zero the
            # CUSUM/EWMA evidence a concurrent service drift has banked
            # (the mirror of keeping the committed arrival model across
            # service commits above)
            self.detector.rebase(fitted, at=self._seen)
        if kind == "drift" and window is not None:
            # restart the streaming estimators from the post-change window
            self.selector.reset(seed_samples=window)
        if kind not in ("load", "failure"):
            # the service-refresh clock ticks on SERVICE-model commits
            # only: a load commit reuses the stale committed service
            # model, so letting it reset the clock would starve the
            # periodic selector resync whenever load commits fire more
            # often than refresh_every samples (the third asymmetry,
            # mirroring the two detector-rebase rules above)
            self._last_commit = self._seen
        if self.sojourn_estimator.ready:
            # EVERY commit re-anchors the sojourn reference: the plan
            # (or its models) changed, so the expected end-to-end
            # latency changed with it — inflation is measured against
            # the regime the committed plan was derived in
            self.sojourn_detector.rebase(self.sojourn_estimator.mean(),
                                         at=self._jobs_seen)
        event = ControlEvent(
            kind=kind, at=self._seen, model=fitted, hedged=hedged,
            old_policy=old, new_policy=self._policy, switched=switched,
            replan_ms=replan_ms, drift=drift, arrival=self.arrival_model,
            cached=cached, warm=warm, loss=self.loss_model,
            quarantined=self.quarantined, fallback=self._fell_back,
            metric=metric)
        if (kind != "refresh" and not quiet) or switched:
            # refreshes (and quiet load resyncs) that change nothing are
            # silent bookkeeping
            self.events.append(event)
            if rec is not None:
                # emitted in the SAME branch that records the
                # ControlEvent, so a trace's commit log is bit-for-bit
                # the controller's decision log by construction
                # (benchmarks/control_loop.py gates the equality)
                a_new = self._policy.assignment
                rec.event(
                    "commit", name=kind, at=self._seen,
                    trigger=drift.kind if drift is not None else kind,
                    old_k=old.k, new_k=self._policy.k,
                    old_n=old.n, new_n=self._policy.n,
                    switched=switched, replan_ms=replan_ms,
                    family=fitted.family, hedged=hedged,
                    cached=cached, warm=warm, metric=metric,
                    fallback=self._fell_back,
                    quarantined=self.quarantined,
                    assignment=None if a_new is None else repr(a_new))
            return event
        return None

    def _load_aware_curve(self, scenario: Scenario, unit: float):
        """k -> queueing latency at the committed arrival model, via the
        sweep backend of the load objective (the surface cache by
        default), on the objective's device.

        The plan scenario may live in normalized time units (Bi-Modal's
        unit-low-mode convention, or the hedge's typical-time unit):
        ``unit`` raw seconds per curve unit.  The arrival RATE is
        measured in raw time, so it converts as rate_curve = rate_raw *
        unit — one job per 20 s is one job per 2 curve units when the
        unit is 10 s.

        Side effect: stashes ``self._tail_curve`` — k -> the surface's
        TAIL latency (the objective's own quantile, or p99 under a mean
        objective) in RAW time units — for plan-derived hedge actuation
        (``HedgedServeActuator.apply_plan``).  Under a quantile
        objective the returned planning curve IS the quantile row of the
        same surface; no extra kernel work either way, the cube holds
        every row.
        """
        from ..runtime.cluster import resolve_sweep_backend
        obj = self.load_objective
        am = self.arrival_model
        sc = dataclasses.replace(scenario, arrivals=am.process())
        self._co_curve = None
        tail_metric = obj.metric if obj.metric in ("p95", "p99") else "p99"
        # the objective's device rides every surface call AND its oracle
        # fallback: a call that lands elsewhere would raise into the
        # fallback and be answered there, hiding the device
        kwargs = dict(ks=sc.legal_ks(), num_jobs=obj.num_jobs,
                      reps=obj.reps, preempt=obj.preempt,
                      cancel_overhead=obj.cancel_overhead, seed=obj.seed,
                      warmup=obj.warmup, device=obj.device)
        if obj.chunk_size is not None or obj.stream:
            # fleet-scale objective: the chunked engine's knobs ride the
            # batched/cached surface call, but NOT the oracle fallback
            # (the discrete-event loop has no chunking), so they are
            # stripped before any degradation re-run
            kwargs.update(chunk_size=obj.chunk_size, stream=obj.stream)
        candidates = self._placement_candidates(sc)
        if candidates is not None:
            # (k, assignment) co-optimization: the whole grid in one
            # (cached) engine call; the returned curve is the ENVELOPE
            # (per k, the best placement), so the k hysteresis gate in
            # _commit judges k moves at their achievable best.  Measured
            # per-worker speeds enter the plan scenario itself — the
            # surface must SEE the heterogeneity for placements to
            # differentiate (speeds are data, not part of the structural
            # key: the key stays warm across drifting estimates)
            measured = self.measured_speeds()
            if measured is not None and sc.worker_speeds is None \
                    and len(measured) == sc.n:
                sc = dataclasses.replace(sc, worker_speeds=measured)
            from ..assign.surface import co_sweep
            try:
                surf = co_sweep(sc, [am.rate * unit], candidates,
                                backend=obj.backend, **kwargs)
            except Exception as exc:
                if obj.backend == "oracle":
                    raise
                _warn_surface_fallback(exc)
                self._fell_back = True
                fb = {k: v for k, v in kwargs.items()
                      if k not in ("chunk_size", "stream")}
                surf = co_sweep(sc, [am.rate * unit], candidates,
                                backend="oracle", **fb)
            cube = surf.metric(obj.metric)[:, 0, :]          # (A, K)
            self._co_curve = (surf.assignments, list(surf.ks), cube)
            # tail row at each k's OBJECTIVE-optimal assignment: the
            # hedge delay describes the placement the plan will commit
            tcube = surf.metric(tail_metric)[:, 0, :]
            ai = np.argmin(np.where(np.isfinite(cube), cube, np.inf),
                           axis=0)                            # (K,)
            self._tail_curve = {
                int(k): float(tcube[ai[j], j]) * unit
                for j, k in enumerate(surf.ks)}
            return {int(k): float(v)
                    for k, v in zip(surf.ks, cube.min(axis=0))}
        run = resolve_sweep_backend(obj.backend)
        kwargs["loads"] = [am.rate * unit]
        try:
            sw = run(sc, **kwargs)
        except Exception as exc:
            if obj.backend == "oracle":
                raise        # nothing left to degrade to
            # graceful degradation: a batched-engine error must not
            # crash a commit mid-run — the pure-python discrete-event
            # oracle always answers, just slower
            _warn_surface_fallback(exc)
            self._fell_back = True
            fb = {k: v for k, v in kwargs.items()
                  if k not in ("chunk_size", "stream")}
            sw = resolve_sweep_backend("oracle")(sc, **fb)
        self._tail_curve = {k: v * unit
                            for k, v in sw.curve(0, tail_metric).items()}
        return sw.curve(0, obj.metric)

    def _placement_candidates(self, sc: Scenario):
        """The legal, speed-resolved placement candidates for this plan
        scenario (None = co-optimization off, the plain k-curve path).

        ``SpeedAware`` entries without explicit speeds are re-resolved
        against the controller's measured per-worker estimates (when the
        fleet size still matches — a quarantine shrink invalidates the
        per-index alignment, and the entry then falls back to the
        scenario's speeds).  Candidates made illegal by a fleet shrink
        (their g no longer divides n or some k) are dropped.
        ``AllWorkers`` is always in the pool, first, so ties prefer the
        paper's dispatch and fan-out is never optimized away untested.
        """
        if not self.config.assignments or self.load_objective is None:
            return None
        from ..assign.strategies import (AllWorkers, SpeedAware,
                                         is_all_workers)
        measured = self.measured_speeds()
        ks = sc.legal_ks()
        out = []
        for a in self.config.assignments:
            if isinstance(a, SpeedAware) and a.speeds is None and \
                    measured is not None and len(measured) == sc.n:
                a = a.with_speeds(measured)
            try:
                for k in ks:
                    a.validate(sc.n, k)
            except ValueError:
                continue
            out.append(a)
        if not any(is_all_workers(a) for a in out):
            out.insert(0, AllWorkers())
        return out if len(out) > 1 else None

    def _place(self, policy: Policy):
        """The placement decision at the committed k, from the co-curve
        of the commit in progress: the best candidate wins only past the
        same hysteresis bar as a k switch (placement churn carries
        redeploy cost too).  Placements are compared STRUCTURALLY
        (``cache_signature``): a SpeedAware refresh with drifted measured
        speeds updates the attached masks without reading as a switch.

        Returns (re-placed policy, placement-moved flag).
        """
        from ..assign.strategies import is_all_workers
        cands, ks, cube = self._co_curve
        if policy.k not in ks:
            return policy, False

        def same(a, b) -> bool:
            if is_all_workers(a) and is_all_workers(b):
                return True
            if is_all_workers(a) or is_all_workers(b):
                return False
            return a.cache_signature(policy.n, tuple(ks)) == \
                b.cache_signature(policy.n, tuple(ks))

        col = cube[:, ks.index(policy.k)]
        ai = int(np.argmin(col))
        best, best_cost = cands[ai], float(col[ai])
        cur = policy.assignment
        cur_idx = next((i for i, c in enumerate(cands) if same(c, cur)),
                       None)
        if cur_idx is None:
            chosen = best       # current placement not even a candidate
        else:
            gain = float(col[cur_idx]) - best_cost
            rel = gain / max(best_cost, 1e-12)
            chosen = best if rel >= self.config.hysteresis \
                else cands[cur_idx]
        attach = None if is_all_workers(chosen) else chosen
        return policy.with_assignment(attach), not same(chosen, cur)

    def _hedged_plan_dist(self, fitted: FittedModel):
        """What to PLAN under (the committed model itself is always the
        fitted one — detection stays calibrated).  Returns
        ``(dist, delta, hedged, unit)`` where ``unit`` is the raw-time
        value of one plan-curve unit (the switching-cost gate needs the
        gain in raw time, and the hedge can change the curve's units).

        The fit lives in NOISE space (``observe`` subtracted any exogenous
        scenario delta): a ShiftedExp fit folds that delta back into its
        shift (a Scenario rejects an external delta alongside S-Exp); the
        other families re-inject it via the scenario, re-expressed in the
        fit's normalized units for Bi-Modal.

        Rule of three: with m effective samples and no straggler beyond
        2x the median observed, straggle rates up to ~3/m are statistically
        indistinguishable from zero.  If additionally the fitted k-curve
        is flat (spread < ``hedge_flat_tol``: the model expresses NO
        preference over k, so the argmin is a tie-break artifact), plan
        against a Bi-Modal straggler of that undetectable rate instead —
        the paper's Sec. VI failure-as-straggling hedge.  A fit whose
        curve does discriminate (heavy tail, real straggler mode) is
        trusted as-is.
        """
        cfg = self.config
        dist = fitted.dist
        delta = self.scenario.delta
        unit = fitted.scale       # Bi-Modal curves are in low-mode units
        if isinstance(dist, ShiftedExp):
            if delta is not None:
                dist = ShiftedExp(delta=dist.delta + delta, W=dist.W)
            delta = None                 # S-Exp carries its shift internally
        elif delta is not None:
            delta = delta / fitted.scale
        if not cfg.hedge:
            return dist, delta, False, unit
        m = max(fitted.num_samples, 1.0)
        bound = 3.0 / m
        if fitted.straggle_p0() >= bound:
            return dist, delta, False, unit
        if isinstance(dist, BiModal):
            # the fit itself says "straggler mode exists but is rarer than
            # the evidence can resolve" (e.g. the last straggler decayed
            # out of the forgetting window): plan with the straggle
            # probability FLOORED at the rule-of-three bound, keeping the
            # observed magnitude B — splitting must not look free on
            # 1/m-resolution evidence.  A well-resolved eps stays as-is
            # (a B <= 2 fit reaches here with any eps, since tail(2) = 0).
            eps = min(max(dist.eps, bound), 1.0)
            return BiModal(B=dist.B, eps=eps), delta, eps != dist.eps, unit
        probe = self.planner.curve(dataclasses.replace(
            self.scenario, dist=dist, delta=delta))
        lo, hi = min(probe.values()), max(probe.values())
        if hi - lo > cfg.hedge_flat_tol * max(lo, 1e-12):
            return dist, delta, False, unit
        # the hedge Bi-Modal's unit mode is the fitted TYPICAL service
        # time (incl. any folded shift); delta re-expressed on that axis
        typical = max(fitted.scale * model_median(dist), 1e-12)
        hedge_delta = float(dist.shift) if dist.shift > 0 \
            else self.scenario.delta
        if hedge_delta is not None:
            hedge_delta = hedge_delta / typical
        return (BiModal(B=cfg.hedge_B, eps=min(bound, 1.0)), hedge_delta,
                True, typical)
