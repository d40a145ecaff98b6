"""Drift detection on the service-time stream.

Two complementary channels, both model-referenced (they watch the stream
THROUGH the committed ``FittedModel``, so "drift" means "the world no
longer looks like the model the current plan was derived from"):

  * CUSUM on standardized log-survival residuals.  Under the committed
    model the mid-distribution survival U_i = pit_mid(x_i) is
    ~Uniform(0,1), so r_i = -log U_i is ~Exp(1) and z_i = r_i - 1 has
    mean 0.  Two one-sided CUSUMs accumulate (z - slack) and (-z - slack);
    either crossing ``threshold`` is an alarm.  Residuals are winsorized
    at ``cap`` so ONE freak sample can never alarm by itself (a committed
    heavy-tail model legitimately produces occasional huge residuals);
    at least two capped spikes in quick succession are required.  The
    index where the alarming side last sat at zero is the standard CUSUM
    change-point estimate, handed to the controller so the refit window
    can exclude pre-change samples.

  * A straggle-fraction EWMA: the fraction of samples beyond 2x the model
    median, compared against the model-implied fraction.  This is the
    slow-creep channel — a straggler probability drifting up over
    thousands of samples moves every residual only slightly (CUSUM's
    per-sample signal is weak) but walks the EWMA out of its band.

Both channels are plain numpy recursions: deterministic given the sample
stream, which is what makes controller decisions replayable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .estimators import ArrivalModel, FittedModel

__all__ = ["DriftDetector", "DriftEvent", "FailureDriftDetector",
           "LoadDriftDetector", "SojournDriftDetector"]


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """A detected change-point on the telemetry stream."""

    kind: str          # "cusum_up" | "cusum_down" | "straggle_ewma"
    at: int            # absolute sample index of the alarm
    start: int         # estimated change-point (refit from here on)
    stat: float        # the statistic that crossed
    threshold: float


@dataclasses.dataclass
class DriftDetector:
    threshold: float = 28.0   # CUSUM alarm level: ~4 capped spikes, or ~60
                              # samples of sustained one-sided drift; high
                              # enough that a few-percent fit error cannot
                              # random-walk across it within ~10k samples
    slack: float = 0.5        # CUSUM allowance (half the min shift to catch)
    cap: float = 8.0          # winsorized residual r = min(-log U, cap)
    ewma_alpha: float = 0.02
    ewma_band: float = 0.05   # minimum |ewma - p0| alarm band: one straggler
                              # spikes the EWMA by ~alpha, so 0.05 demands
                              # several near-simultaneous stragglers before a
                              # rare-straggler model (tiny p0, tiny sigma)
                              # can alarm, yet a creep to eps ~ 0.1 crosses;
                              # for mid-range p0 the sigma term below
                              # dominates anyway
    ewma_z: float = 10.0      # band widened to ewma_z stationary sigmas (the
                              # EWMA of a Bernoulli(p0) has std
                              # sqrt(alpha/(2-alpha) p0 (1-p0)))
    ewma_min: int = 500       # samples after rebase before EWMA may alarm

    def __post_init__(self):
        self.model: Optional[FittedModel] = None
        self._rebase(at=0)

    def _rebase(self, at: int) -> None:
        self.g_up = 0.0
        self.g_dn = 0.0
        self.up_start = at       # where the current + excursion began
        self.dn_start = at
        self.p0 = self.model.straggle_p0() if self.model is not None else 0.0
        a = self.ewma_alpha
        self.band = max(self.ewma_band,
                        self.ewma_z * math.sqrt(
                            a / (2.0 - a) * self.p0 * (1.0 - self.p0)))
        self.ewma = self.p0
        self.rebased_at = at

    def rebase(self, model: FittedModel, at: int) -> None:
        """Adopt a newly committed model; all statistics restart."""
        self.model = model
        self._rebase(at)

    def update(self, x: np.ndarray, at: int) -> Optional[DriftEvent]:
        """Feed a batch whose first sample has absolute index ``at``;
        returns the first alarm in the batch (statistics stop there — the
        controller rebases before feeding more)."""
        if self.model is None:
            return None
        x = np.asarray(x, dtype=np.float64).ravel()
        x = x[np.isfinite(x)]
        if x.size == 0:
            return None
        u = self.model.pit_mid(x)
        z = np.minimum(-np.log(u), self.cap) - 1.0
        thresh = self.model.straggle_threshold()
        a = self.ewma_alpha
        for i in range(x.size):
            idx = at + i
            self.g_up = max(0.0, self.g_up + z[i] - self.slack)
            if self.g_up == 0.0:
                self.up_start = idx + 1
            self.g_dn = max(0.0, self.g_dn - z[i] - self.slack)
            if self.g_dn == 0.0:
                self.dn_start = idx + 1
            if self.g_up > self.threshold:
                return DriftEvent("cusum_up", at=idx, start=self.up_start,
                                  stat=self.g_up, threshold=self.threshold)
            if self.g_dn > self.threshold:
                return DriftEvent("cusum_down", at=idx, start=self.dn_start,
                                  stat=self.g_dn, threshold=self.threshold)
            self.ewma += a * ((1.0 if x[i] > thresh else 0.0) - self.ewma)
            if idx - self.rebased_at >= self.ewma_min and \
                    abs(self.ewma - self.p0) > self.band:
                # change began roughly one EWMA time-constant ago
                start = max(self.rebased_at, idx - int(math.ceil(1.0 / a)))
                return DriftEvent("straggle_ewma", at=idx, start=start,
                                  stat=self.ewma, threshold=self.band)
        return None


@dataclasses.dataclass
class FailureDriftDetector:
    """CUSUM failure-drift channel on the task-outcome stream.

    Neither the service channel nor the load channel can see a crash
    storm that leaves completion TIMES and arrival TIMESTAMPS alone: a
    worker whose task is terminally lost contributes no finite time at
    all.  This detector watches the Bernoulli outcome stream (True =
    terminal loss) THROUGH the committed loss rate p0, as two one-sided
    likelihood-ratio CUSUMs against DESIGN alternatives:

      * "loss_up": p1 = max(2 p0, p0 + ``min_shift``) — the fleet is
        failing materially more than committed.  The per-outcome LLR
        increment is winsorized at ``cap``, so one unlucky loss under a
        near-zero commit (whose raw LLR log(p1/p0) is huge) can never
        alarm by itself — several must cluster faster than the clean-
        outcome decay between them drains the statistic.
      * "loss_down": p1 = p0 / 2 — the fleet healed, the controller may
        relax a storm-era quarantine/redundancy floor.  Armed only when
        p0 >= ``min_down``: below that there is nothing to relax and the
        down-LLR degenerates.

    The LLR form (rather than the raw z = x - p0 excess) is what keeps
    the null ARL usable across the whole p0 range: under a matched
    mid-range commit each increment has mean -KL(p0 || p1) < 0, so the
    statistic drains between coincidences instead of random-walking
    across the threshold on Bernoulli noise alone.  Same contract as the
    other detectors: plain deterministic recursions, ``rebase`` on every
    commit, ``at``/``start`` are absolute OUTCOME indices, and the index
    where the alarming side last sat at zero estimates the change-point.
    """

    threshold: float = 4.0    # in nats: >= 3 clustered capped-LLR losses
                              # under a near-zero commit, or ~threshold /
                              # KL(p0 || p0/2) clean outcomes of healing
    cap: float = 1.5          # winsorized |increment| (nats)
    min_shift: float = 0.05   # smallest up-shift designed against: drifts
                              # below it are left to the decayed
                              # estimator's periodic recommit
    min_down: float = 0.02    # committed rate below which the healing
                              # side stays disarmed
    min_outcomes: int = 8     # outcomes after rebase before alarms
    _P_FLOOR = 1e-4           # p0 clamp for the LLR (p0 = 0 exactly would
                              # make one loss's raw LLR infinite)

    def __post_init__(self):
        self.p0: Optional[float] = None
        self._rebase(at=0)

    def _rebase(self, at: int) -> None:
        self.g_up = self.g_dn = 0.0
        self.g_up_min = 0.0
        self.up_start = self.dn_start = at
        self.rebased_at = at
        if self.p0 is None:
            return
        p = min(max(self.p0, self._P_FLOOR), 1.0 - self._P_FLOOR)
        up = min(max(2.0 * p, p + self.min_shift), 1.0 - self._P_FLOOR)
        c = self.cap
        self._up_loss = min(math.log(up / p), c)
        self._up_ok = max(math.log((1.0 - up) / (1.0 - p)), -c)
        if self.p0 >= self.min_down:
            dn = max(0.5 * p, self._P_FLOOR)
            self._dn_loss = max(math.log(dn / p), -c)
            self._dn_ok = min(math.log((1.0 - dn) / (1.0 - p)), c)
        else:
            self._dn_loss = self._dn_ok = None

    def rebase(self, p0: float, at: int) -> None:
        """Adopt a newly committed loss rate; statistics restart."""
        if not (0.0 <= p0 <= 1.0):
            raise ValueError(f"loss rate must be in [0, 1], got {p0}")
        self.p0 = float(p0)
        self._rebase(at)

    @property
    def charge(self) -> float:
        """The hottest CUSUM side as a fraction of its alarm level (cf.
        ``LoadDriftDetector.charge``)."""
        return max(self.g_up, self.g_dn) / self.threshold

    @property
    def banked(self) -> float:
        """CROSS-batch up-side evidence as a fraction of the alarm level:
        the minimum the up statistic touched during the last ``update``
        batch.  One step's own losses arrive at fixed positions within
        the batch, so the END-of-batch ``g_up`` of a perfectly matched
        steady stream can sit permanently at (losses-per-step) x its
        per-loss increment while the statistic drains to zero in between
        — evidence that never survives a batch is not banked.  The
        controller's periodic loss resync gates on THIS, not on
        ``charge``."""
        return self.g_up_min / self.threshold

    def update(self, lost: np.ndarray, at: int) -> Optional[DriftEvent]:
        """Feed task outcomes (first outcome has absolute index ``at``);
        returns the first alarm (the controller rebases before feeding
        more)."""
        if self.p0 is None:
            return None
        x = np.asarray(lost, dtype=bool).ravel()
        mn = self.g_up
        for i in range(x.size):
            idx = at + i
            self.g_up = max(0.0, self.g_up + (
                self._up_loss if x[i] else self._up_ok))
            mn = min(mn, self.g_up)
            if self.g_up == 0.0:
                self.up_start = idx + 1
            if self._dn_loss is not None:
                self.g_dn = max(0.0, self.g_dn + (
                    self._dn_loss if x[i] else self._dn_ok))
                if self.g_dn == 0.0:
                    self.dn_start = idx + 1
            if idx - self.rebased_at + 1 < self.min_outcomes:
                continue
            if self.g_up > self.threshold:
                return DriftEvent("loss_up", at=idx, start=self.up_start,
                                  stat=self.g_up, threshold=self.threshold)
            if self.g_dn > self.threshold:
                self.g_up_min = mn
                return DriftEvent("loss_down", at=idx, start=self.dn_start,
                                  stat=self.g_dn, threshold=self.threshold)
        self.g_up_min = mn
        return None


@dataclasses.dataclass
class SojournDriftDetector:
    """Band detector on completion-ordered sojourn inflation.

    The service channel watches task TIMES and the load channel watches
    arrival TIMESTAMPS, but neither sees the queue itself: a plan whose
    modeled inputs all still fit can nonetheless be delivering inflated
    END-TO-END latency (queueing regime shifts faster than either
    marginal drifts, e.g. a flash crowd arriving exactly at the
    stability knee).  This detector watches the decayed sojourn mean
    (``control.estimators.SojournEstimator``) THROUGH the reference
    committed at the last re-plan: inflation = mean / reference, and
    crossing ``1 + band`` ("sojourn_up") or its reciprocal
    ("sojourn_down") pages the controller for a re-plan at the CURRENT
    arrival model.

    Same contract as the siblings: ``rebase`` on every commit (the plan
    changed, so the expected sojourn changed with it), ``at``/``start``
    are absolute JOB indices, plain deterministic arithmetic.
    ``min_jobs`` fresh jobs must flow after a rebase before an alarm —
    the decayed mean still carries pre-commit jobs right after a switch.
    """

    band: float = 0.75        # alarm at +-75% inflation: wide enough that
                              # per-phase MMPP burst noise on a decayed
                              # mean does not page, narrow enough that a
                              # queue heading for instability (unbounded
                              # inflation) pages within ~min_jobs
    min_jobs: int = 48

    def __post_init__(self):
        if self.band <= 0.0:
            raise ValueError(f"band must be > 0, got {self.band}")
        if self.min_jobs < 1:
            raise ValueError(f"min_jobs must be >= 1, got {self.min_jobs}")
        self.reference: Optional[float] = None
        self.rebased_at = 0

    def rebase(self, mean_sojourn: float, at: int) -> None:
        """Adopt the sojourn level at a commit as the new reference."""
        self.reference = max(float(mean_sojourn), 1e-12)
        self.rebased_at = at

    def update(self, mean_sojourn: float, at: int) -> Optional[DriftEvent]:
        """Compare the current decayed mean against the reference;
        returns the alarm (the controller rebases at its next commit)."""
        if self.reference is None or \
                at - self.rebased_at < self.min_jobs:
            return None
        infl = float(mean_sojourn) / self.reference
        hi = 1.0 + self.band
        if infl >= hi:
            return DriftEvent("sojourn_up", at=at, start=self.rebased_at,
                              stat=infl, threshold=hi)
        if infl <= 1.0 / hi:
            return DriftEvent("sojourn_down", at=at, start=self.rebased_at,
                              stat=infl, threshold=1.0 / hi)
        return None


@dataclasses.dataclass
class LoadDriftDetector:
    """CUSUM load-drift channel on the interarrival stream.

    The service channel (``DriftDetector``) cannot see a workload change
    that leaves task times alone — a traffic ramp or an arrival-process
    burstiness flip moves only the job TIMESTAMPS.  This detector
    watches the gap stream THROUGH the committed ``ArrivalModel``, in
    BLOCKS of ``block`` consecutive gaps: bursty arrivals (MMPP trains)
    are serially correlated, so a per-gap CUSUM random-walks across any
    usable threshold during a single dwell; a block mean spanning a few
    dwells is approximately independent of the next and near-Gaussian.

      * Rate channel.  Under the committed model the block sum S of
        ``model.block`` gaps satisfies E[rate * S / B] = 1 with variance
        ``model.block_dispersion / B`` — the EMPIRICAL block-scale
        dispersion the estimator measured, so serial correlation in
        bursty trains is calibrated in, not assumed away.  z is the
        standardized block residual; two one-sided CUSUMs accumulate
        (-z - slack) ("load_up": gaps shortened, the rate rose) and
        (z - slack) ("load_down").  z is winsorized at ``cap`` so one
        freak lull cannot alarm alone.
      * Dispersion channel.  A burstiness flip at CONSTANT mean rate
        leaves E[z] ~ 0 but scales E[z^2] by new/committed block
        dispersion; one-sided CUSUMs on (z^2 - mu - ``disp_slack``)
        ("burst_up") and (mu - z^2 - ``disp_slack_dn``) ("burst_down")
        catch it, with mu the model-implied E[z^2] — 1 in general, but
        bd / floor(bd) under a near-clockwork commit whose variance sits
        below the standardization floor (z^2 - 1 would otherwise read
        "smoother" forever and sure-fire the down side).

    Same contract as the service detector: plain deterministic
    recursions, ``rebase`` on every commit, the block index where the
    alarming side last sat at zero marks the change-point estimate (in
    gap units).  ``at``/``start`` are absolute GAP indices.

    The ``kind`` names the CHANNEL that crossed first, not the ground-
    truth change: a large rate shift also inflates z^2 (squared bias of
    the standardized residual), so it can cross the dispersion channel
    before the rate channel and report "burst_up".  The controller
    treats every kind identically (re-estimate + re-plan), so the label
    is diagnostic only.
    """

    threshold: float = 19.0   # rate-CUSUM level, in block units: a 2x
                              # rate flip is |E z| ~ 0.5 sqrt(block /
                              # block_dispersion) ~ 1.7 per block under a
                              # Poisson commit -> alarm in ~16 blocks;
                              # high enough that the residual CROSS-block
                              # correlation of long bursty dwells cannot
                              # random-walk across it within ~1k blocks
    slack: float = 0.5
    cap: float = 6.0          # winsorized |z| <= cap (rate channel)
    disp_threshold: float = 19.0  # Poisson->MMPP: E[z^2] ~ block-
                                  # dispersion ratio ~ 3-6 -> a few blocks
    disp_slack: float = 1.0   # block residuals of bursty gaps are heavy-
                              # tailed; spikes must cluster to alarm
    disp_slack_dn: float = 0.35   # z^2 - mu >= -mu: the down side is
                                  # variance-bounded and runs tighter
    disp_cap: float = 3.0     # |z| winsorization for the DISPERSION
                              # channel: one freak block contributes at
                              # most 8 - slack, so >= 2 spikes in quick
                              # succession are required to alarm
    disp_floor: float = 0.05  # standardization floor on block dispersion
    min_blocks: int = 2       # blocks after rebase before alarms

    def __post_init__(self):
        self.model: Optional[ArrivalModel] = None
        self._rebase(at=0)

    def _rebase(self, at: int) -> None:
        self.g_up = self.g_dn = 0.0    # rate rose / fell
        self.d_up = self.d_dn = 0.0    # burstier / smoother
        self.up_start = self.dn_start = at
        self.du_start = self.dd_start = at
        self._blk_sum = 0.0
        self._blk_n = 0
        self._blocks = 0
        self.rebased_at = at

    def rebase(self, model: ArrivalModel, at: int) -> None:
        """Adopt a newly committed arrival model; statistics restart
        (the partial block is dropped — it straddles the commit)."""
        self.model = model
        self._rebase(at)

    @property
    def charge(self) -> float:
        """The hottest CUSUM side as a fraction of its alarm level —
        ~0 when quiescent, 1.0 at the alarm.  The controller's periodic
        load resync consults it: re-committing (which rebases all four
        statistics) while a side is accumulating would erase the very
        evidence an in-progress change has banked."""
        return max(self.g_up / self.threshold, self.g_dn / self.threshold,
                   self.d_up / self.disp_threshold,
                   self.d_dn / self.disp_threshold)

    def update(self, gaps: np.ndarray, at: int) -> Optional[DriftEvent]:
        """Feed interarrival gaps (first gap has absolute index ``at``);
        returns the first alarm (the controller rebases before feeding
        more)."""
        if self.model is None:
            return None
        g = np.asarray(gaps, dtype=np.float64).ravel()
        g = g[np.isfinite(g)]
        if g.size == 0:
            return None
        block = self.model.block
        bd = max(self.model.block_dispersion, 0.0)
        sd = math.sqrt(max(bd, self.disp_floor) / block)
        mu = bd / max(bd, self.disp_floor)     # model-implied E[z^2] <= 1
        for i in range(g.size):
            idx = at + i
            self._blk_sum += g[i]
            self._blk_n += 1
            if self._blk_n < block:
                continue
            r = self.model.rate * self._blk_sum / block
            self._blk_sum = 0.0
            self._blk_n = 0
            self._blocks += 1
            z0 = (r - 1.0) / sd
            z = float(np.clip(z0, -self.cap, self.cap))
            zd = float(np.clip(z0, -self.disp_cap, self.disp_cap))
            e = zd * zd - mu
            self.g_up = max(0.0, self.g_up - z - self.slack)
            if self.g_up == 0.0:
                self.up_start = idx + 1
            self.g_dn = max(0.0, self.g_dn + z - self.slack)
            if self.g_dn == 0.0:
                self.dn_start = idx + 1
            self.d_up = max(0.0, self.d_up + e - self.disp_slack)
            if self.d_up == 0.0:
                self.du_start = idx + 1
            self.d_dn = max(0.0, self.d_dn - e - self.disp_slack_dn)
            if self.d_dn == 0.0:
                self.dd_start = idx + 1
            if self._blocks < self.min_blocks:
                continue
            for stat, level, kind, start in (
                    (self.g_up, self.threshold, "load_up", self.up_start),
                    (self.g_dn, self.threshold, "load_down", self.dn_start),
                    (self.d_up, self.disp_threshold, "burst_up",
                     self.du_start),
                    (self.d_dn, self.disp_threshold, "burst_down",
                     self.dd_start)):
                if stat > level:
                    return DriftEvent(kind, at=idx, start=start,
                                      stat=stat, threshold=level)
        return None
