"""Canonical computing-unit (CU) service-time models of the paper (Sec. II-C/D).

Three CU service-time PDFs:
  * ShiftedExp(delta, W):  Pr{X > x} = exp(-(x-delta)/W),  x >= delta
  * Pareto(lam, alpha):    Pr{X > x} = (lam/x)^alpha,      x >= lam
  * BiModal(B, eps):       X = 1 w.p. 1-eps,  X = B w.p. eps

Three task-size scaling models for a task of s CUs (Sec. II-D):
  * SERVER_DEPENDENT:  Y = Delta + s * X          (Model 1)
  * DATA_DEPENDENT:    Y = s * Delta + X          (Model 2)
  * ADDITIVE:          Y = sum_{i=1..s} X_i       (Model 3; + s*Delta shift
                        for S-Exp, matching Sec. IV-C where
                        Y = s*Delta + Erlang(s, W))

Samplers draw float32 tensors from an explicit ``torch.Generator``; the
tensor lands on ``device``, which defaults to the generator's own.  Scalar
helpers (mean, tail, pdf), the fits and model selection are plain numpy
for use in the planner and benchmarks.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, target as _target


#: Relative half-width of BiModal's atom bands — the single tolerance
#: shared by logpmf (model selection) and the control loop's PIT.
ATOM_RTOL = 0.25

#: Service-time families model selection scores, in tie-break order.
FAMILIES = ("shifted_exp", "pareto", "bimodal")


class Scaling(enum.Enum):
    """How a task's service time scales with its size s (number of CUs)."""

    SERVER_DEPENDENT = "server"
    DATA_DEPENDENT = "data"
    ADDITIVE = "additive"


class ServiceTime:
    """Base class for CU service-time distributions.

    Subclasses implement single-CU sampling and analytics; task-level
    (s-CU) sampling under each scaling model is provided here.
    """

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...],
               device=None) -> torch.Tensor:
        raise NotImplementedError

    def mean(self) -> float:
        raise NotImplementedError

    def tail(self, x: np.ndarray) -> np.ndarray:
        """Pr{X > x}."""
        raise NotImplementedError

    def logpdf(self, x: np.ndarray) -> np.ndarray:
        """Exact log density (or log mass for atomic families) at x.

        ``service_loglik`` is the dispatcher that also handles Bi-Modal's
        time-scale normalization.
        """
        raise NotImplementedError

    # -- shift/noise decomposition X = delta + Z used by scaling models -----
    @property
    def shift(self) -> float:
        """Deterministic minimum component Delta (0 if none)."""
        return 0.0

    def sample_noise(self, generator: torch.Generator, shape,
                     device=None) -> torch.Tensor:
        """Sample the random component Z = X - shift."""
        return self.sample(generator, shape, device) - self.shift

    # -- task-level sampling -------------------------------------------------
    def sample_task(
        self,
        generator: torch.Generator,
        shape: Tuple[int, ...],
        s: int,
        scaling: Scaling,
        delta: float | None = None,
        device=None,
    ) -> torch.Tensor:
        """Sample service times of tasks consisting of ``s`` CUs.

        Follows Sec. II-D exactly:
          Model 1 (server-dep): Y = Delta + s * Z   (Z = X - Delta the noise;
                   for distributions with no intrinsic shift, Y = s * X)
          Model 2 (data-dep):   Y = s * Delta + Z
          Model 3 (additive):   Y = sum of s i.i.d. X

        ``delta`` overrides the deterministic per-CU component.  For
        ShiftedExp it defaults to the distribution's own shift; for
        Pareto/Bi-Modal under data-dependent scaling the paper introduces an
        exogenous Delta (e.g. Fig. 7-8, 14-15), passed here explicitly, and
        the noise Z is the full X.
        """
        s = int(s)
        d = self.shift if delta is None else float(delta)
        if scaling is Scaling.SERVER_DEPENDENT:
            return d + s * self.sample_noise(generator, shape, device)
        if scaling is Scaling.DATA_DEPENDENT:
            return s * d + self.sample_noise(generator, shape, device)
        if scaling is Scaling.ADDITIVE:
            draws = self.sample(generator, tuple(shape) + (s,), device)
            return draws.sum(dim=-1)
        raise ValueError(f"unknown scaling {scaling}")


@dataclasses.dataclass(frozen=True)
class ShiftedExp(ServiceTime):
    """X ~ S-Exp(delta, W): minimum time delta plus Exp(W) noise.

    W is the *mean* of the exponential part (paper's W), so
    Pr{X > x} = exp(-(x - delta)/W).
    """

    delta: float
    W: float

    def __post_init__(self):
        if self.delta < 0 or self.W < 0:
            raise ValueError("delta and W must be non-negative")

    @property
    def shift(self) -> float:
        return self.delta

    def _exp(self, generator, shape, device) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=torch.float32,
                           device=_target(generator, device)
                           ).exponential_(generator=generator)

    def sample(self, generator, shape, device=None):
        if self.W == 0.0:
            return torch.full(tuple(shape), self.delta, dtype=torch.float32,
                              device=_target(generator, device))
        return self.delta + self.W * self._exp(generator, shape, device)

    def sample_noise(self, generator, shape, device=None):
        if self.W == 0.0:
            return torch.zeros(tuple(shape), dtype=torch.float32,
                               device=_target(generator, device))
        return self.W * self._exp(generator, shape, device)

    def mean(self) -> float:
        return self.delta + self.W

    def tail(self, x):
        x = np.asarray(x, dtype=np.float64)
        if self.W == 0.0:
            return (x < self.delta).astype(np.float64)
        return np.where(x < self.delta, 1.0, np.exp(-(x - self.delta) / max(self.W, 1e-300)))

    def logpdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        if self.W == 0.0:     # degenerate: unit mass at delta
            return np.where(x == self.delta, 0.0, -np.inf)
        return np.where(x < self.delta, -np.inf,
                        -math.log(self.W) - (x - self.delta) / self.W)


@dataclasses.dataclass(frozen=True)
class Pareto(ServiceTime):
    """X ~ Pareto(lam, alpha): Pr{X > x} = (lam/x)^alpha for x >= lam."""

    lam: float
    alpha: float

    def __post_init__(self):
        if self.lam <= 0 or self.alpha <= 0:
            raise ValueError("lam and alpha must be positive")

    def sample(self, generator, shape, device=None):
        # Inverse-CDF: X = lam * U^(-1/alpha).  U is clamped at the 2^-24
        # quantile: fp32 uniforms are quantized in 2^-24 steps and can return
        # exactly 0/minval, which would yield ~1e10 outliers.  The truncation
        # biases the mean by O(2^-24·(1-1/alpha)) relative -- negligible for
        # the alpha > 1 regimes the paper studies.
        u = torch.empty(tuple(shape), dtype=torch.float32,
                        device=_target(generator, device)
                        ).uniform_(2.0 ** -24, 1.0, generator=generator)
        return self.lam * u ** (-1.0 / self.alpha)

    def mean(self) -> float:
        if self.alpha <= 1:
            return math.inf
        return self.lam * self.alpha / (self.alpha - 1.0)

    def moment(self, p: float) -> float:
        if self.alpha <= p:
            return math.inf
        return self.alpha * self.lam**p / (self.alpha - p)

    def tail(self, x):
        x = np.asarray(x, dtype=np.float64)
        return np.where(x < self.lam, 1.0, (self.lam / np.maximum(x, self.lam)) ** self.alpha)

    def logpdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        return np.where(
            x < self.lam, -np.inf,
            math.log(self.alpha) + self.alpha * math.log(self.lam)
            - (self.alpha + 1.0) * np.log(np.maximum(x, self.lam)))


@dataclasses.dataclass(frozen=True)
class BiModal(ServiceTime):
    """X = 1 w.p. 1-eps ; X = B w.p. eps  (B > 1, eps = straggle prob)."""

    B: float
    eps: float

    def __post_init__(self):
        if not (0.0 <= self.eps <= 1.0):
            raise ValueError("eps must be in [0,1]")
        if self.B < 1.0:
            raise ValueError("B must be >= 1")

    def sample(self, generator, shape, device=None):
        dev = _target(generator, device)
        straggle = torch.rand(tuple(shape), generator=generator,
                              device=dev) < self.eps
        return torch.ones(tuple(shape), dtype=torch.float32,
                          device=dev).masked_fill_(straggle, self.B)

    def mean(self) -> float:
        return 1.0 * (1.0 - self.eps) + self.B * self.eps

    def tail(self, x):
        x = np.asarray(x, dtype=np.float64)
        return np.where(x < 1.0, 1.0, np.where(x < self.B, self.eps, 0.0))

    def atom_match(self, x, rtol: float = ATOM_RTOL):
        """Classify unit-convention samples against the two atoms.

        Returns ``(near_lo, near_hi)`` boolean masks: a sample within
        relative distance ``rtol`` of an atom matches it; when the bands
        overlap (B close to 1) the nearer atom claims the sample.  The
        SINGLE band rule shared by ``logpmf`` (model selection) and the
        control loop's mid-distribution PIT (drift detection).
        """
        x = np.asarray(x, dtype=np.float64)
        d_lo = np.abs(x - 1.0)
        d_hi = np.abs(x - self.B) / self.B
        lo_hit = d_lo <= rtol
        hi_hit = d_hi <= rtol
        near_hi = hi_hit & (~lo_hit | (d_hi < d_lo))
        return lo_hit & ~near_hi, near_hi

    def logpmf(self, x, rtol: float = ATOM_RTOL) -> np.ndarray:
        """Exact log mass under the two-atom law, with a tolerance band.

        A sample within relative distance ``rtol`` of an atom carries that
        atom's mass; a sample in neither band gets a floor mass of 1e-300
        (log ~ -690), which keeps a two-atom fit from free-riding on
        unimodal data.  Expects samples in the paper's unit-low-mode
        convention (see ``service_loglik`` for the normalization).
        """
        near_lo, near_hi = self.atom_match(x, rtol)
        p = np.where(near_hi, self.eps, np.where(near_lo, 1.0 - self.eps, 0.0))
        return np.log(np.maximum(p, 1e-300))

    def logpdf(self, x):
        """Alias for ``logpmf`` so the ``ServiceTime`` contract is uniform."""
        return self.logpmf(x)


def bimodal_low_mode(samples: np.ndarray) -> float:
    """Estimate of the fast-mode location of (possibly jittered) two-mode
    telemetry: the mean of the cluster at/below twice the median.

    When straggling dominates (eps > 1/2) the median sits ON the high mode;
    if that happens (no sample beyond 2x the estimate) a min/max midpoint
    split is tried instead, and adopted when it exposes a separated second
    mode.  The single normalization shared by ``fit_service_time("bimodal")``
    and ``service_loglik``.
    """
    x = np.asarray(samples, dtype=np.float64)
    med = float(np.median(x))
    low = x[x <= 2.0 * med]
    lo = float(low.mean()) if low.size else med
    if not np.any(x > 2.0 * lo):
        # majority-straggler telemetry: retry with a midpoint split
        mid = 0.5 * (float(x.min()) + float(x.max()))
        below, above = x[x <= mid], x[x > mid]
        if below.size and above.size and \
                float(above.mean()) > 2.0 * float(below.mean()):
            lo = float(below.mean())
    return max(lo, 1e-12)


def sample_resolution(samples: np.ndarray) -> float:
    """Measurement resolution of a telemetry window: the median gap of the
    sorted samples (duplicates count as zero gaps), floored at 1e-12 of the
    data scale.  ``service_loglik`` uses it as the interval width for
    interval likelihoods.
    """
    xs = np.sort(np.asarray(samples, dtype=np.float64))
    scale = max(float(abs(xs[-1])), float(xs[-1] - xs[0]), 1e-9)
    if xs.size < 2:
        return 1e-12 * scale
    return max(float(np.median(np.diff(xs))), 1e-12 * scale)


def service_loglik(dist: ServiceTime, samples: np.ndarray) -> float:
    """Exact log-likelihood of raw telemetry under a fitted model, as an
    INTERVAL likelihood at the data's measurement resolution.

    Continuous families score log(f(x) * h) with h = ``sample_resolution``;
    a ``BiModal`` fit is scored on samples normalized by
    ``bimodal_low_mode`` (the transform ``fit_service_time`` applied), its
    atoms carrying mass directly.
    """
    x = np.asarray(samples, dtype=np.float64)
    if isinstance(dist, BiModal):
        return float(dist.logpmf(x / bimodal_low_mode(x)).sum())
    h = sample_resolution(x)
    # an interval PROBABILITY cannot exceed 1: the clip stops a density
    # spike (e.g. Pareto alpha -> inf on near-constant data) from scoring
    # better than a point mass ever could
    return float(np.sum(np.minimum(dist.logpdf(x) + math.log(h), 0.0)))


def fit_service_time(samples: np.ndarray, family: str) -> ServiceTime:
    """Fit a service-time model from per-task telemetry (method of moments /
    MLE)."""
    x = np.asarray(samples, dtype=np.float64)
    x = x[np.isfinite(x)]
    if x.size < 2:
        raise ValueError("need at least 2 samples")
    if family == "shifted_exp":
        delta = float(x.min())
        w = float(max(x.mean() - delta, 1e-12))
        return ShiftedExp(delta=delta, W=w)
    if family == "pareto":
        lam = float(max(x.min(), 1e-12))
        # MLE for alpha given lam
        logs = np.log(x / lam)
        alpha = float(x.size / max(logs.sum(), 1e-12))
        return Pareto(lam=lam, alpha=alpha)
    if family == "bimodal":
        # Normalize by the estimated low mode BEFORE fitting, so the fit is
        # invariant to the telemetry time scale (fit(c*x) == fit(x)).
        z = x / bimodal_low_mode(x)
        stragglers = z > 2.0
        eps = float(stragglers.mean())
        b = float(z[stragglers].mean()) if stragglers.any() else 1.0
        return BiModal(B=max(b, 1.0), eps=eps)
    raise ValueError(f"unknown family {family!r}")


#: minimum number of non-overlapping s-blocks for the task-level score
#: to be statistically meaningful; below this the CU score is kept.
MIN_TASK_BLOCKS = 8


def task_loglik(dist: ServiceTime, samples: np.ndarray, task_size: int,
                device=DEFAULT_DEVICE) -> float:
    """Interval log-likelihood of s-block SUMS under the fitted model's
    additive task law — the task-level predictive score.

    The samples are cut into ``m = len(x) // s`` non-overlapping blocks,
    each block summed, and every block sum y scored by the model's exact
    s-fold task probability ``P{y - h/2 < Y <= y + h/2}`` via
    ``core.scenario.task_survival``.  The Pareto-additive law is a cached
    200k-draw Monte-Carlo tail drawn on ``device`` from a generator seeded
    12345, so scores are reproducible on one device.
    """
    from .scenario import task_survival  # late: scenario imports this module
    x = np.asarray(samples, dtype=np.float64).ravel()
    s = int(task_size)
    m = x.size // s
    if m < 2:
        raise ValueError(
            f"need at least 2 blocks of {s} samples, got {x.size}")
    y = np.sort(x[:m * s].reshape(m, s).sum(axis=1))
    if isinstance(dist, BiModal):
        y = y / bimodal_low_mode(x)
    h = sample_resolution(y)
    p = task_survival(dist, Scaling.ADDITIVE, s, y - 0.5 * h, device=device) \
        - task_survival(dist, Scaling.ADDITIVE, s, y + 0.5 * h, device=device)
    return float(np.log(np.maximum(p, 1e-300)).sum())


def select_service_time(samples: np.ndarray,
                        families: Tuple[str, ...] = FAMILIES,
                        task_size: Optional[int] = None,
                        scaling: Optional[Scaling] = None,
                        device=DEFAULT_DEVICE,
                        ) -> Tuple[ServiceTime, str]:
    """Fit every candidate family and pick the best by exact
    log-likelihood (``service_loglik``).

    A zero-straggler "bimodal" only competes when the window actually
    contains a second mode.  Ties resolve to the earlier family in
    ``families``.  With ``scaling=Scaling.ADDITIVE`` and a planned
    ``task_size`` s > 1 (and at least ``MIN_TASK_BLOCKS`` s-blocks of
    telemetry), candidates are ranked by ``task_loglik`` instead, whose
    Pareto-additive draws go to ``device``.
    """
    x = np.asarray(samples, dtype=np.float64).ravel()
    x = x[np.isfinite(x)]
    if x.size < 2:
        raise ValueError(f"need at least 2 samples, got {x.size}")
    s = 1 if task_size is None else int(task_size)
    task_level = (scaling is Scaling.ADDITIVE and s > 1
                  and x.size // s >= MIN_TASK_BLOCKS)
    best = None
    for family in families:
        try:
            d = fit_service_time(x, family)
        except ValueError:
            continue
        if isinstance(d, BiModal) and not (0.0 < d.eps < 1.0):
            continue
        ll = task_loglik(d, x, s, device) if task_level \
            else service_loglik(d, x)
        if best is None or ll > best[2]:
            best = (d, family, ll)
    if best is None:
        raise ValueError("no service-time family could be fitted")
    return best[0], best[1]
