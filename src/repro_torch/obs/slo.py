"""Streaming SLO monitor: online tail quantile vs a target with
multi-window burn-rate alarms.

The ROADMAP's SLO-grade-serving item needs exactly this primitive: an
online estimate of the observed completion-latency p99 against a target,
plus a *burn-rate* alarm — the fraction of requests violating the target
relative to the SLO's error budget, judged over two windows at once (the
multi-window multi-burn-rate rule of the SRE literature): a FAST window
so a flash crowd alarms in tens of jobs, gated by a SLOW window so one
unlucky straggler cannot page.  Alarms latch until the slow window
recovers below half the threshold, so a sustained breach raises once,
not once per job.

Determinism: the monitor is a pure function of the latency stream (the
quantile sketch's reservoir uniforms are the deterministic splitmix64
stream of ``obs.metrics.StreamHist``), so a controller fed the same
trace raises the same alarms at the same indices — the contract every
other controller channel already obeys, which is what lets the SLO
channel join ``control.detector`` as an alarm source
(``RedundancyController(slo=...)`` turns a burn alarm into a pending
drift the normal refit-commit path resolves).

The quantile estimate is EXACT while the observation count is at most
the sketch capacity (reservoir holds every sample); the control-loop
bench gates the streaming p99 within 2% of the exact-cube p99 on its
full trace.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from .metrics import StreamHist

__all__ = ["SLOAlarm", "SLOMonitor"]


@dataclasses.dataclass(frozen=True)
class SLOAlarm:
    """One multi-window burn crossing."""

    at: int             # observation index (0-based) of the crossing
    burn_fast: float    # fast-window violation rate / error budget
    burn_slow: float    # slow-window violation rate / error budget
    threshold: float    # the burn-rate level both windows crossed
    target: float       # the latency target being burned
    quantile_est: float  # streaming tail-quantile estimate at the alarm


class SLOMonitor:
    """Online ``quantile`` latency vs ``target`` with burn-rate state.

    ``observe(latency)`` folds one completion latency and returns an
    :class:`SLOAlarm` exactly when the multi-window burn rule crosses
    (both windows' burn >= ``burn_threshold``, at least ``min_count``
    observations seen, not currently latched).  ``quantile_estimate()``
    is the streaming tail estimate; ``burn_fast``/``burn_slow`` expose
    the live burn state for dashboards and the run report.
    """

    def __init__(self, target: float, quantile: float = 0.99,
                 fast_window: int = 64, slow_window: int = 512,
                 burn_threshold: float = 4.0, min_count: int = 32,
                 capacity: int = 4096):
        if not (target > 0):
            raise ValueError(f"target must be > 0, got {target}")
        if not (0.0 < quantile < 1.0):
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        if fast_window < 1 or slow_window < fast_window:
            raise ValueError(
                f"need 1 <= fast_window <= slow_window, got "
                f"{fast_window}/{slow_window}")
        if burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {burn_threshold}")
        self.target = float(target)
        self.quantile = float(quantile)
        self.budget = 1.0 - self.quantile       # allowed violation rate
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.burn_threshold = float(burn_threshold)
        self.min_count = int(min_count)
        self.hist = StreamHist(capacity=capacity, seed=97)
        self.count = 0
        self.violations = 0
        self._fast: deque = deque(maxlen=self.fast_window)
        self._slow: deque = deque(maxlen=self.slow_window)
        self._fast_sum = 0
        self._slow_sum = 0
        self._latched = False
        self.alarms = 0

    # -- read side ----------------------------------------------------------
    @property
    def burn_fast(self) -> float:
        if not self._fast:
            return 0.0
        return (self._fast_sum / len(self._fast)) / self.budget

    @property
    def burn_slow(self) -> float:
        if not self._slow:
            return 0.0
        return (self._slow_sum / len(self._slow)) / self.budget

    def quantile_estimate(self) -> float:
        """The streaming estimate of the monitored latency quantile
        (exact while count <= sketch capacity)."""
        return self.hist.quantile(self.quantile)

    def violation_rate(self) -> float:
        return self.violations / self.count if self.count else 0.0

    def margin(self) -> float:
        """Signed SLO headroom: (target - streaming quantile estimate) /
        target.  Positive means the observed tail sits inside the
        objective (0.25 = a quarter of the target to spare); negative
        means the SLO is being delivered blown even if the burn windows
        have not crossed yet.  0.0 before any observation."""
        if not self.count:
            return 0.0
        return (self.target - self.quantile_estimate()) / self.target

    @property
    def healthy(self) -> bool:
        """Whether the monitor is currently clear: not latched on a burn
        alarm AND the streaming tail estimate within target."""
        return not self._latched and self.margin() >= 0.0

    def state(self) -> dict:
        """JSON-able snapshot for run reports and bench artifacts."""
        out = {"target": self.target, "quantile": self.quantile,
               "count": self.count, "violations": self.violations,
               "violation_rate": self.violation_rate(),
               "burn_fast": self.burn_fast, "burn_slow": self.burn_slow,
               "burn_threshold": self.burn_threshold,
               "alarms": self.alarms, "latched": self._latched,
               "margin": self.margin(), "healthy": self.healthy}
        if self.count:
            out["quantile_estimate"] = self.quantile_estimate()
        return out

    # -- write side ---------------------------------------------------------
    def observe(self, latency: float) -> Optional[SLOAlarm]:
        """Fold one completion latency; maybe alarm."""
        x = float(latency)
        at = self.count
        self.count += 1
        self.hist.update(x)
        v = 1 if x > self.target else 0
        self.violations += v
        for ring, attr in ((self._fast, "_fast_sum"),
                           (self._slow, "_slow_sum")):
            if len(ring) == ring.maxlen:
                setattr(self, attr, getattr(self, attr) - ring[0])
            ring.append(v)
            setattr(self, attr, getattr(self, attr) + v)
        bf, bs = self.burn_fast, self.burn_slow
        if self._latched:
            # re-arm only after the slow window genuinely recovers —
            # half the threshold, the standard alarm-hysteresis band
            if bs < 0.5 * self.burn_threshold:
                self._latched = False
            return None
        if self.count >= self.min_count and \
                bf >= self.burn_threshold and bs >= self.burn_threshold:
            self._latched = True
            self.alarms += 1
            return SLOAlarm(at=at, burn_fast=bf, burn_slow=bs,
                            threshold=self.burn_threshold,
                            target=self.target,
                            quantile_est=self.quantile_estimate())
        return None
