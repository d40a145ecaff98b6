"""Streaming service-time estimation with exponential forgetting.

``runtime.telemetry.Telemetry`` fits a sliding window once on demand; the
control loop instead maintains DECAYED sufficient statistics per family —
every sample's weight decays by ``forget`` per subsequent sample, so the
estimate tracks a slowly wandering distribution without refitting from
scratch — and scores the families PREQUENTIALLY: each incoming batch is
scored under every family's current fit (exact per-family
``logpdf``/``logpmf`` via the same interval-likelihood convention as
``core.distributions.service_loglik``) before the fit absorbs it, and an
exponentially weighted per-sample log-likelihood decides the family.

Sufficient statistics per family:

  * ShiftedExp: decayed (weight, sum x) for W = mean - delta; the shift
    delta is the min over a ring of recent per-batch minima (a decayed
    minimum has no closed form; the ring forgets stale minima after drift).
  * Pareto: decayed (weight, sum log x) for the alpha MLE; lam from the
    same minima ring.
  * BiModal: decayed two-cluster moments, classified against 2x the
    current low-mode estimate (the ``bimodal_low_mode`` convention); the
    low-cluster mean is the time-scale normalizer, so the fitted dist is
    unit-low-mode exactly like ``fit_service_time``.

``FittedModel`` is the typed currency handed to the detector and the
controller: the fitted dist, its family, its time-scale normalizer, and
the effective evidence mass behind it.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, Optional

import numpy as np

from ..core.distributions import (ATOM_RTOL, BiModal, Pareto, ServiceTime,
                                  ShiftedExp, bimodal_low_mode,
                                  sample_resolution, select_service_time)
from ..core.scenario import (ArrivalProcess, DeterministicArrivals,
                             MMPPArrivals, PoissonArrivals, arrival_gap)

__all__ = ["ArrivalEstimator", "ArrivalModel", "FittedModel",
           "LossModel", "LossRateEstimator",
           "ShiftedExpEstimator", "ParetoEstimator", "BiModalEstimator",
           "OnlineSelector", "SojournEstimator", "SojournModel",
           "fit_window"]

#: Per-sample log-likelihood floor (matches the logpmf miss floor).
LL_FLOOR = -700.0
_TINY = 1e-12


def model_median(dist: ServiceTime) -> float:
    """Closed-form median of a single-CU service time (unit convention
    for BiModal)."""
    if isinstance(dist, ShiftedExp):
        return dist.delta + dist.W * math.log(2.0)
    if isinstance(dist, Pareto):
        return dist.lam * 2.0 ** (1.0 / dist.alpha)
    if isinstance(dist, BiModal):
        return 1.0 if dist.eps < 0.5 else dist.B
    raise TypeError(f"unknown service-time family {dist!r}")


@dataclasses.dataclass(frozen=True)
class FittedModel:
    """A fitted service-time model plus the context scoring needs.

    ``scale``        the time-scale normalizer: 1.0 for the continuous
                     families (their parameters live on the raw time
                     axis), the estimated low mode for BiModal (the dist
                     is in the paper's unit-low-mode convention).
    ``num_samples``  effective evidence mass (decayed weight for streaming
                     fits, window length for one-shot fits) — the
                     controller's rule-of-three hedge reads it.
    """

    dist: ServiceTime
    family: str
    scale: float = 1.0
    num_samples: float = 0.0

    # -- scoring ------------------------------------------------------------
    def loglik_per_sample(self, x: np.ndarray) -> float:
        """Mean exact log-likelihood of a raw-scale batch under this fit
        (interval convention of ``service_loglik``; the KNOWN scale is
        used for BiModal instead of re-estimating it per batch)."""
        x = np.asarray(x, dtype=np.float64)
        if isinstance(self.dist, BiModal):
            ll = self.dist.logpmf(x / self.scale)
        else:
            h = sample_resolution(x)
            ll = np.minimum(self.dist.logpdf(x) + math.log(h), 0.0)
        return float(np.maximum(ll, LL_FLOOR).mean())

    def pit_mid(self, x: np.ndarray) -> np.ndarray:
        """Mid-distribution survival U = Pr{X > x} + 0.5 Pr{X = x}.

        Under the fitted model U is ~Uniform(0,1) for continuous
        families; for atomic families the mid-point convention keeps
        E[-log U] ~ 1, which is what the detector's standardized
        log-survival residuals assume.  Atoms are matched with the same
        relative band as ``BiModal.logpmf``; a quasi-degenerate
        ShiftedExp (W ~ 0) is treated as an atom at delta so a
        deterministic fleet does not read as perpetual drift.
        """
        x = np.asarray(x, dtype=np.float64)
        d = self.dist
        if isinstance(d, BiModal):
            z = x / self.scale
            near_lo, near_hi = d.atom_match(z)   # logpmf's own band rule
            u = np.where(
                near_hi, 0.5 * d.eps,
                np.where(near_lo, d.eps + 0.5 * (1.0 - d.eps),
                         np.where(z < 1.0, 1.0,
                                  np.where(z < d.B, d.eps, 0.0))))
        elif isinstance(d, ShiftedExp) and \
                d.W <= 1e-9 * max(d.delta, 1.0):
            near = np.abs(x - d.delta) <= ATOM_RTOL * max(d.delta, 1e-9)
            u = np.where(near, 0.5, np.where(x < d.delta, 1.0, 0.0))
        else:
            u = d.tail(x)
        return np.clip(u, _TINY, 1.0)

    # -- straggle geometry (raw time axis) ----------------------------------
    def straggle_threshold(self) -> float:
        """The telemetry straggler cut: 2x the model median — except for
        Bi-Modal, where it is 2x the LOW mode (the fit's own z > 2
        classification): when straggling is the majority (eps > 1/2) the
        median sits on the HIGH mode and 2x median would declare
        stragglers impossible."""
        if isinstance(self.dist, BiModal):
            return 2.0 * self.scale
        return 2.0 * self.scale * model_median(self.dist)

    def straggle_p0(self) -> float:
        """Model-implied P(X > straggle_threshold)."""
        t = self.straggle_threshold() / self.scale
        return float(np.clip(self.dist.tail(np.asarray([t])), 0.0, 1.0)[0])


# --------------------------------------------------------------------------
# Decayed sufficient statistics
# --------------------------------------------------------------------------

def _decay_weights(forget: float, size: int):
    """Per-sample decay of one batch: ``dec[j]`` is sample j's weight once
    the whole batch has arrived (oldest decays most), and the second value
    is the carry factor applied to all pre-batch state — the ONE decay
    recurrence shared by every estimator's accumulators."""
    dec = forget ** np.arange(size - 1, -1, -1, dtype=np.float64)
    return dec, forget ** size


class _Decayed:
    """Exponentially forgotten (weight, sum x, sum log x) + a minima ring."""

    def __init__(self, forget: float, min_blocks: int):
        if not (0.0 < forget <= 1.0):
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        self.forget = forget
        self.w = 0.0
        self.sx = 0.0
        self.slogx = 0.0
        self.mins: Deque[float] = collections.deque(maxlen=min_blocks)

    def update(self, x: np.ndarray) -> None:
        if x.size == 0:
            return
        dec, fb = _decay_weights(self.forget, x.size)
        self.w = self.w * fb + float(dec.sum())
        self.sx = self.sx * fb + float((dec * x).sum())
        self.slogx = self.slogx * fb + float(
            (dec * np.log(np.maximum(x, _TINY))).sum())
        self.mins.append(float(x.min()))

    @property
    def mean(self) -> float:
        return self.sx / max(self.w, _TINY)

    @property
    def min(self) -> float:
        return min(self.mins)


class ShiftedExpEstimator:
    """Streaming S-Exp(delta, W): delta = recent-minima min, W = mean - delta."""

    family = "shifted_exp"
    scale = 1.0

    def __init__(self, forget: float = 0.999, min_blocks: int = 64):
        self._m = _Decayed(forget, min_blocks)

    def update(self, x: np.ndarray) -> None:
        self._m.update(x)

    @property
    def weight(self) -> float:
        return self._m.w

    @property
    def ready(self) -> bool:
        return self._m.w >= 2.0

    def dist(self) -> ShiftedExp:
        delta = self._m.min
        return ShiftedExp(delta=delta, W=max(self._m.mean - delta, _TINY))


class ParetoEstimator:
    """Streaming Pareto(lam, alpha): lam = recent-minima min, alpha by the
    decayed MLE  alpha = w / sum_w log(x / lam)."""

    family = "pareto"
    scale = 1.0

    def __init__(self, forget: float = 0.999, min_blocks: int = 64):
        self._m = _Decayed(forget, min_blocks)

    def update(self, x: np.ndarray) -> None:
        self._m.update(x)

    @property
    def weight(self) -> float:
        return self._m.w

    @property
    def ready(self) -> bool:
        return self._m.w >= 2.0

    def dist(self) -> Pareto:
        lam = max(self._m.min, _TINY)
        # sum_w log(x/lam) = slogx - w log lam; older samples may predate
        # the current lam (evicted minima), so clamp away negative mass
        denom = max(self._m.slogx - self._m.w * math.log(lam),
                    self._m.w * 1e-9)
        return Pareto(lam=lam, alpha=min(self._m.w / denom, 1e9))


class BiModalEstimator:
    """Streaming Bi-Modal in the unit-low-mode convention.

    Samples are classified against 2x the CURRENT low-mode estimate (the
    ``bimodal_low_mode`` threshold); both clusters keep decayed (weight,
    sum) moments.  ``scale`` is the low-cluster mean — the same
    normalizer ``fit_service_time("bimodal")`` applies, so streaming and
    one-shot fits agree on stationary data.
    """

    family = "bimodal"

    def __init__(self, forget: float = 0.999):
        if not (0.0 < forget <= 1.0):
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        self.forget = forget
        self._lo: Optional[float] = None
        self.w_lo = self.s_lo = 0.0
        self.w_hi = self.s_hi = 0.0

    def update(self, x: np.ndarray) -> None:
        if x.size == 0:
            return
        if self._lo is None:
            self._lo = bimodal_low_mode(x)
        dec, fb = _decay_weights(self.forget, x.size)
        hi = x > 2.0 * self._lo
        self.w_lo = self.w_lo * fb + float((dec * ~hi).sum())
        self.s_lo = self.s_lo * fb + float((dec * x * ~hi).sum())
        self.w_hi = self.w_hi * fb + float((dec * hi).sum())
        self.s_hi = self.s_hi * fb + float((dec * x * hi).sum())
        if self.w_lo > 0:
            self._lo = self.s_lo / self.w_lo

    @property
    def weight(self) -> float:
        return self.w_lo + self.w_hi

    @property
    def ready(self) -> bool:
        return self.weight >= 2.0 and self._lo is not None

    @property
    def scale(self) -> float:
        return max(self._lo if self._lo is not None else 1.0, _TINY)

    def dist(self) -> BiModal:
        eps = self.w_hi / max(self.weight, _TINY)
        b = (self.s_hi / max(self.w_hi, _TINY)) / self.scale \
            if self.w_hi > 0 else 1.0
        return BiModal(B=max(b, 1.0), eps=float(np.clip(eps, 0.0, 1.0)))


# --------------------------------------------------------------------------
# Prequential model selection
# --------------------------------------------------------------------------

class OnlineSelector:
    """Streams batches into the three family estimators and keeps an
    exponentially weighted per-sample log-likelihood per family.

    Scoring is prequential: the batch is scored under each family's
    PRE-update fit (one-step-ahead prediction), then the fits absorb it.
    ``best()`` returns the ``FittedModel`` of the highest-scoring ready
    family — with the same vacuous-bimodal guard as ``Telemetry.fit``
    (a zero-straggler two-atom fit explains any tight cluster for free
    and must not compete).
    """

    def __init__(self, forget: float = 0.999, ll_alpha: float = 0.05,
                 min_weight: float = 24.0):
        self.forget = forget
        self.ll_alpha = ll_alpha
        self.min_weight = min_weight
        self.reset()

    def reset(self, seed_samples: Optional[np.ndarray] = None) -> None:
        """Fresh estimators (e.g. after a committed change-point); the
        post-change window can be replayed in via ``seed_samples``."""
        self.estimators = {
            "shifted_exp": ShiftedExpEstimator(self.forget),
            "pareto": ParetoEstimator(self.forget),
            "bimodal": BiModalEstimator(self.forget),
        }
        self._ll: Dict[str, Optional[float]] = {
            f: None for f in self.estimators}
        if seed_samples is not None and np.size(seed_samples):
            self.update(np.asarray(seed_samples, dtype=np.float64))

    def update(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float64).ravel()
        x = x[np.isfinite(x)]
        if x.size == 0:
            return
        for fam, est in self.estimators.items():
            if not est.ready:
                continue
            try:
                model = self._model(fam)
            except ValueError:
                continue
            ll = model.loglik_per_sample(x)
            prev = self._ll[fam]
            self._ll[fam] = ll if prev is None else \
                (1.0 - self.ll_alpha) * prev + self.ll_alpha * ll
        for est in self.estimators.values():
            est.update(x)

    def _model(self, fam: str) -> FittedModel:
        est = self.estimators[fam]
        return FittedModel(dist=est.dist(), family=fam, scale=est.scale,
                           num_samples=est.weight)

    def scores(self) -> Dict[str, Optional[float]]:
        return dict(self._ll)

    def best(self) -> Optional[FittedModel]:
        cands = []
        for fam, est in self.estimators.items():
            ll = self._ll[fam]
            if ll is None or not est.ready or est.weight < self.min_weight:
                continue
            model = self._model(fam)
            if fam == "bimodal" and not (0.0 < model.dist.eps < 1.0):
                continue
            cands.append((ll, fam, model))
        if not cands:
            return None
        return max(cands, key=lambda t: t[0])[2]


# --------------------------------------------------------------------------
# Arrival-process estimation (the LOAD side of the control loop)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalModel:
    """A committed arrival-process model: mean rate plus burstiness.

    ``rate``        jobs per unit time (1 / mean interarrival gap).
    ``dispersion``  the index of dispersion of the gaps — Var[gap] /
                    E[gap]^2, the squared coefficient of variation: 1 for
                    Poisson, < 1 toward clockwork, > 1 for bursty trains.
    ``num_gaps``    effective evidence mass (decayed gap count), the same
                    rule-of-three currency as ``FittedModel.num_samples``.
    ``block`` /     the detector's residual calibration: the variance of
    ``block_dispersion``  a BLOCK-of-``block``-gaps sum, expressed as an
                    index of dispersion (Var[S_B] / (B mean_gap^2)).  For
                    renewal gaps it equals ``dispersion``; bursty trains
                    are serially correlated and inflate it — estimating
                    it empirically is what keeps the load CUSUM
                    calibrated without any independence assumption.
    """

    rate: float
    dispersion: float
    num_gaps: float = 0.0
    block: int = 12
    block_dispersion: Optional[float] = None

    def __post_init__(self):
        if self.block_dispersion is None:
            object.__setattr__(self, "block_dispersion", self.dispersion)

    #: dispersion below which the committed process is clockwork, and the
    #: band around 1 treated as Poisson (between them, Poisson still —
    #: there is no sub-Poisson renewal family in the substrate).
    DETERMINISTIC_BELOW = 0.25
    POISSON_BELOW = 1.5
    #: the symmetric two-state MMPP's marginal gap mixture caps CV^2 at 3
    MMPP_CAP = 2.9
    #: evidence mass at which an over-dispersion estimate keeps half its
    #: excess over Poisson in the committed process.  CV^2 from a short
    #: post-alarm refit window is heavy-tailed upward (one straggling lull
    #: inflates the square), and the MMPP mapping AMPLIFIES it — CV^2 of
    #: 2.3 already plans burst dwells at ~5x the mean rate, braced against
    #: which every quantile surface prefers maximal diversity.  Shrinking
    #: the excess by num_gaps / (num_gaps + mass) makes a committed burst
    #: model something the stream must EARN; a sustained bursty regime
    #: (hundreds of decayed gaps) keeps its dispersion essentially intact.
    DISPERSION_SHRINK_MASS = 128.0

    def effective_dispersion(self) -> float:
        """The dispersion the PLAN should brace for: the raw estimate
        with its excess over Poisson shrunk by evidence mass.  Sub-
        Poisson estimates pass through — mapping them to a milder
        process (clockwork) is the conservative direction already."""
        if self.dispersion <= 1.0 or self.num_gaps <= 0.0:
            return self.dispersion
        w = self.num_gaps / (self.num_gaps + self.DISPERSION_SHRINK_MASS)
        return 1.0 + (self.dispersion - 1.0) * w

    def process(self) -> ArrivalProcess:
        """The planning-substrate ``ArrivalProcess`` matching this model.

        Effective (evidence-shrunk) dispersion maps onto the closest
        shape the cluster engines sample: clockwork
        (``DeterministicArrivals``) below ``DETERMINISTIC_BELOW``,
        Poisson up to ``POISSON_BELOW``, else a symmetric two-state
        ``MMPPArrivals`` whose burst multiplier b solves the
        marginal-mixture identity CV^2 = 3 - 8/(b + 1/b)^2 (slow = 1/b,
        burst = b, so the long-run rate is exact).
        """
        d = self.effective_dispersion()
        if d < self.DETERMINISTIC_BELOW:
            return DeterministicArrivals(rate=self.rate)
        if d <= self.POISSON_BELOW:
            return PoissonArrivals(rate=self.rate)
        cv2 = min(d, self.MMPP_CAP)
        t = math.sqrt(8.0 / (3.0 - cv2))            # t = b + 1/b
        b = 0.5 * (t + math.sqrt(t * t - 4.0))
        return MMPPArrivals(rate=self.rate, slow=1.0 / b, burst=b)


class ArrivalEstimator:
    """Streaming interarrival-rate/burstiness estimation from job
    timestamps with exponential forgetting.

    Feed absolute arrival instants in order; only the GAPS enter the
    decayed (weight, sum, sum-of-squares) moments, so every committed
    statistic is invariant under timestamp translation by construction
    (pinned by the hypothesis suite).  ``reset`` drops the moments but
    keeps the last timestamp — the post-change gap stream starts
    accumulating immediately after a load-drift alarm.
    """

    def __init__(self, forget: float = 0.998, min_gaps: int = 16,
                 block: int = 12):
        if not (0.0 < forget <= 1.0):
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        if min_gaps < 2:
            raise ValueError(f"min_gaps must be >= 2, got {min_gaps}")
        if block < 2:
            raise ValueError(f"block must be >= 2, got {block}")
        self.forget = forget
        self.min_gaps = min_gaps
        self.block = block
        self._last_ts: Optional[float] = None
        self.last_gap: float = 0.0             # most recent gap observed
        self.w = self.sg = self.sg2 = 0.0
        self.bw = self.bs = self.bs2 = 0.0     # decayed block-sum moments
        self._blk_sum = 0.0
        self._blk_n = 0
        self._count = 0

    def observe(self, timestamp: float) -> None:
        """One job arrival instant (monotone non-decreasing)."""
        t = float(timestamp)
        if self._last_ts is not None:
            # shared clock-tolerance rule (ulp-backward ticks clamp,
            # larger decreases raise); floored to keep gaps positive
            gap = max(arrival_gap(self._last_ts, t), _TINY)
            self.last_gap = gap
            f = self.forget
            self.w = self.w * f + 1.0
            self.sg = self.sg * f + gap
            self.sg2 = self.sg2 * f + gap * gap
            self._count += 1
            self._blk_sum += gap
            self._blk_n += 1
            if self._blk_n == self.block:
                fb = f ** self.block           # one decay tick per block
                self.bw = self.bw * fb + 1.0
                self.bs = self.bs * fb + self._blk_sum
                self.bs2 = self.bs2 * fb + self._blk_sum * self._blk_sum
                self._blk_sum = 0.0
                self._blk_n = 0
        self._last_ts = t

    def reset(self) -> None:
        """Forget the moments (post-change restart); the last timestamp
        is kept so the very next arrival contributes a clean gap."""
        self.w = self.sg = self.sg2 = 0.0
        self.bw = self.bs = self.bs2 = 0.0
        self._blk_sum = 0.0
        self._blk_n = 0
        self._count = 0

    @property
    def primed(self) -> bool:
        """Whether a first timestamp exists (the next observe is a gap)."""
        return self._last_ts is not None

    @property
    def weight(self) -> float:
        return self.w

    @property
    def num_gaps(self) -> int:
        """Gaps observed since the last reset (undecayed count)."""
        return self._count

    @property
    def ready(self) -> bool:
        return self._count >= self.min_gaps

    def rate(self) -> float:
        """1 / decayed mean gap (jobs per unit time)."""
        return self.w / max(self.sg, _TINY)

    def dispersion(self) -> float:
        """Decayed index of dispersion Var[gap] / E[gap]^2 (CV^2)."""
        mean = self.sg / max(self.w, _TINY)
        var = max(self.sg2 / max(self.w, _TINY) - mean * mean, 0.0)
        return var / max(mean * mean, _TINY)

    def block_dispersion(self) -> float:
        """Var[block sum] / (block * mean_gap^2): the EMPIRICAL residual
        scale of a block mean under whatever serial correlation the
        stream carries (equals ``dispersion`` for renewal streams).
        Falls back to the per-gap dispersion until two blocks exist."""
        if self.bw < 2.0:
            return self.dispersion()
        mean = self.sg / max(self.w, _TINY)
        bmean = self.bs / max(self.bw, _TINY)
        bvar = max(self.bs2 / max(self.bw, _TINY) - bmean * bmean, 0.0)
        return bvar / max(self.block * mean * mean, _TINY)

    def model(self) -> ArrivalModel:
        if not self.ready:
            raise ValueError(
                f"need {self.min_gaps} gaps, have {self._count}")
        return ArrivalModel(rate=self.rate(), dispersion=self.dispersion(),
                            num_gaps=self.w, block=self.block,
                            block_dispersion=self.block_dispersion())


# --------------------------------------------------------------------------
# Task-loss estimation (the FAILURE side of the control loop)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LossModel:
    """A committed task-loss model: the Bernoulli loss probability plus
    its rule-of-three upper confidence rate.

    ``rate``          decayed fraction of task outcomes that were terminal
                      losses (relaunch budget exhausted).
    ``upper``         max(rate, 3 / evidence mass): with m outcomes and no
                      loss observed, loss rates up to ~3/m are
                      statistically indistinguishable from zero — the
                      controller floors its redundancy on THIS, never on
                      the point estimate, so a freshly booted fleet is
                      not planned as if it were provably loss-free.
    ``num_outcomes``  effective evidence mass (decayed outcome count),
                      the same currency as ``FittedModel.num_samples``.
    """

    rate: float
    upper: float
    num_outcomes: float = 0.0


class LossRateEstimator:
    """Streaming Bernoulli task-loss rate with exponential forgetting.

    Feed one boolean per RESOLVED task (True = terminally lost); the
    decayed (weight, losses) pair tracks a slowly wandering loss rate the
    same way ``ArrivalEstimator`` tracks the gap moments.  ``reset``
    drops the moments at a failure-drift alarm so the post-change stream
    accumulates clean evidence before the controller re-commits.
    """

    def __init__(self, forget: float = 0.998, min_outcomes: int = 32):
        if not (0.0 < forget <= 1.0):
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        if min_outcomes < 2:
            raise ValueError(
                f"min_outcomes must be >= 2, got {min_outcomes}")
        self.forget = forget
        self.min_outcomes = min_outcomes
        self.w = self.losses = 0.0
        self._count = 0

    def observe(self, lost) -> None:
        """One or more task outcomes (truthy = terminally lost)."""
        x = np.asarray(lost, dtype=bool).ravel()
        if x.size == 0:
            return
        dec, fb = _decay_weights(self.forget, x.size)
        self.w = self.w * fb + float(dec.sum())
        self.losses = self.losses * fb + float((dec * x).sum())
        self._count += x.size

    def reset(self) -> None:
        """Forget the moments (post-alarm restart)."""
        self.w = self.losses = 0.0
        self._count = 0

    @property
    def weight(self) -> float:
        return self.w

    @property
    def num_outcomes(self) -> int:
        """Outcomes observed since the last reset (undecayed count)."""
        return self._count

    @property
    def ready(self) -> bool:
        return self._count >= self.min_outcomes

    def rate(self) -> float:
        return self.losses / max(self.w, _TINY)

    def upper(self) -> float:
        """Rule-of-three upper confidence rate (see ``LossModel``)."""
        return float(min(max(self.rate(), 3.0 / max(self.w, _TINY)), 1.0))

    def model(self) -> LossModel:
        if not self.ready:
            raise ValueError(
                f"need {self.min_outcomes} outcomes, have {self._count}")
        return LossModel(rate=self.rate(), upper=self.upper(),
                         num_outcomes=self.w)


# --------------------------------------------------------------------------
# Completion-ordered sojourn estimation (the QUEUE side of the loop)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SojournModel:
    """A committed end-to-end sojourn summary: what a serving master sees.

    ``mean``        decayed mean of completion - arrival (service PLUS
                    queueing — the quantity an SLO is written against,
                    which the service-fit x arrival-model route only
                    predicts indirectly).
    ``dispersion``  decayed CV^2 of the sojourns.
    ``num_jobs``    effective evidence mass (decayed weight), the same
                    currency as ``FittedModel.num_samples``.
    """

    mean: float
    dispersion: float
    num_jobs: float = 0.0


class SojournEstimator:
    """Streaming sojourn moments from (arrival, completion) pairs.

    Feed each job's realized arrival and completion instants; the decayed
    (weight, sum, sum-of-squares) moments track the end-to-end latency
    the fleet is actually delivering.  Only the DIFFERENCE enters the
    moments, so the statistics are timestamp-translation invariant like
    ``ArrivalEstimator``'s gaps.  The controller pairs this with
    ``control.detector.SojournDriftDetector``: estimator owns the
    moments, detector owns the alarm rule — the same split as the
    arrival/load pair.
    """

    def __init__(self, forget: float = 0.995, min_jobs: int = 48):
        if not (0.0 < forget <= 1.0):
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        if min_jobs < 2:
            raise ValueError(f"min_jobs must be >= 2, got {min_jobs}")
        self.forget = forget
        self.min_jobs = min_jobs
        self.w = self.ss = self.ss2 = 0.0
        self._count = 0
        self.last_sojourn: float = 0.0

    def observe(self, arrival: float, completion: float) -> None:
        """One job's (arrival, completion) pair, in completion order."""
        a, c = float(arrival), float(completion)
        # shared clock-tolerance rule: ulp-backward completions clamp to
        # a zero-length sojourn, larger inversions raise
        s = max(arrival_gap(a, c), _TINY)
        self.last_sojourn = s
        f = self.forget
        self.w = self.w * f + 1.0
        self.ss = self.ss * f + s
        self.ss2 = self.ss2 * f + s * s
        self._count += 1

    def reset(self) -> None:
        """Forget the moments (post-commit restart)."""
        self.w = self.ss = self.ss2 = 0.0
        self._count = 0

    @property
    def weight(self) -> float:
        return self.w

    @property
    def num_jobs(self) -> int:
        """Jobs observed since the last reset (undecayed count)."""
        return self._count

    @property
    def ready(self) -> bool:
        return self._count >= self.min_jobs

    def mean(self) -> float:
        """Decayed mean sojourn."""
        return self.ss / max(self.w, _TINY)

    def dispersion(self) -> float:
        """Decayed CV^2 of the sojourns."""
        mean = self.mean()
        var = max(self.ss2 / max(self.w, _TINY) - mean * mean, 0.0)
        return var / max(mean * mean, _TINY)

    def model(self) -> SojournModel:
        if not self.ready:
            raise ValueError(
                f"need {self.min_jobs} jobs, have {self._count}")
        return SojournModel(mean=self.mean(), dispersion=self.dispersion(),
                            num_jobs=self.w)


def fit_window(samples: np.ndarray, task_size=None,
               scaling=None) -> FittedModel:
    """One-shot exact-likelihood fit of a telemetry window — the
    change-point refit path: the SAME selection policy as
    ``Telemetry.fit`` (``core.distributions.select_service_time``),
    returning the control loop's typed ``FittedModel``.  ``task_size`` /
    ``scaling`` rank candidates by the task-level predictive likelihood
    at the planned task size (additive scaling only)."""
    x = np.asarray(samples, dtype=np.float64).ravel()
    x = x[np.isfinite(x)]
    d, family = select_service_time(x, task_size=task_size, scaling=scaling)
    scale = bimodal_low_mode(x) if family == "bimodal" else 1.0
    return FittedModel(dist=d, family=family, scale=scale,
                       num_samples=float(x.size))
