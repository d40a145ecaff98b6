"""Expected job completion time E[Y_{k:n}] for every (service PDF x scaling
model) pair in the paper (Secs. IV, V, VI).

The job has n CUs on n workers; the [n,k] MDS-coded dispatch gives each
worker a task of s = n/k CUs, and the job finishes at the k-th order
statistic of the i.i.d. task times.

Entry point:  expected_completion_time(dist, scaling, k, n, delta=...)

Closed forms are used wherever the paper has them; Pareto-additive (the one
case the paper itself simulates, Fig. 9) falls back to a deterministic
Monte-Carlo estimate.  LLN approximations (Thms. 8 & 9) are exposed
separately for benchmarking against the exact expressions (Figs. 13, 16).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from .distributions import BiModal, Pareto, Scaling, ServiceTime, ShiftedExp
from . import batched
from . import order_stats as osl

__all__ = [
    "expected_completion_time",
    "completion_curve",
    "sexp_server_dependent",
    "sexp_data_dependent",
    "sexp_additive",
    "pareto_server_dependent",
    "pareto_data_dependent",
    "pareto_data_dependent_approx",
    "pareto_additive_mc",
    "pareto_splitting_additive",
    "bimodal_server_dependent",
    "bimodal_data_dependent",
    "bimodal_additive",
    "bimodal_server_dependent_lln",
    "bimodal_data_dependent_lln",
    "replication_additive_sexp",
]


def _s(k: int, n: int) -> int:
    if n % k != 0:
        raise ValueError(f"k={k} must divide n={n} (integer task size)")
    return n // k


# --------------------------------------------------------------------------
# Shifted-Exponential  (Sec. IV)
# --------------------------------------------------------------------------

def sexp_server_dependent(k: int, n: int, delta: float, W: float) -> float:
    """Eq. (2): E[Y_{k:n}] = Delta + s W (H_n - H_{n-k})."""
    s = _s(k, n)
    return delta + s * W * (osl.harmonic(n) - osl.harmonic(n - k))


def sexp_data_dependent(k: int, n: int, delta: float, W: float) -> float:
    """Eq. (3): E[Y_{k:n}] = s Delta + W (H_n - H_{n-k})."""
    s = _s(k, n)
    return s * delta + W * (osl.harmonic(n) - osl.harmonic(n - k))


def sexp_additive(k: int, n: int, delta: float, W: float, exact: bool = False) -> float:
    """Sec. IV-C: Y = s Delta + Erlang(s, W);  E[Y_{k:n}] = s Delta + E[Z_{k:n}].

    ``exact=True`` uses the rational-arithmetic eq. (18); default quadrature.
    """
    s = _s(k, n)
    if W == 0.0:
        return s * delta
    if exact:
        return s * delta + osl.erlang_order_stat_exact(k, n, s, W)
    return s * delta + osl.erlang_order_stat(k, n, s, W)


def replication_additive_sexp(n: int, delta: float, W: float) -> float:
    """Corollary of Thm. 3: E[Y_{1:n}] = n Delta + (W/n) E(n,n)  (birthday)."""
    return n * delta + (W / n) * osl.birthday_expectation(n, n)


# --------------------------------------------------------------------------
# Pareto  (Sec. V)
# --------------------------------------------------------------------------

def pareto_server_dependent(k: int, n: int, lam: float, alpha: float) -> float:
    """Sec. V-A: E[Y_{k:n}] = s E[X_{k:n}] with X ~ Pareto(lam, alpha)."""
    s = _s(k, n)
    return s * osl.pareto_order_stat(k, n, lam, alpha)


def pareto_data_dependent(
    k: int, n: int, lam: float, alpha: float, delta: float
) -> float:
    """Sec. V-B: E[Y_{k:n}] = s Delta + E[X_{k:n}]  (eq. (19))."""
    s = _s(k, n)
    return s * delta + osl.pareto_order_stat(k, n, lam, alpha)


def pareto_data_dependent_approx(
    k: int, n: int, lam: float, alpha: float, delta: float
) -> float:
    """Sec. V-B approximation: E ~ n Delta / k + lam (n/(n-k))^{1/alpha}."""
    if k == n:
        # limit of the Gautschi approximation at k=n: use exact term instead
        return delta + osl.pareto_order_stat(n, n, lam, alpha)
    return n * delta / k + lam * (n / (n - k)) ** (1.0 / alpha)


def pareto_additive_mc(
    k: int,
    n: int,
    lam: float,
    alpha: float,
    trials: int = 100_000,
    seed: int = 0,
) -> float:
    """Sec. V-C: no closed form; deterministic Monte-Carlo (paper's Fig. 9)."""
    s = _s(k, n)
    rng = np.random.default_rng(seed)
    u = rng.uniform(low=np.finfo(np.float64).tiny, size=(trials, n, s))
    y = (lam * u ** (-1.0 / alpha)).sum(axis=-1)
    y.sort(axis=1)
    return float(y[:, k - 1].mean())


def pareto_splitting_additive(n: int, lam: float, alpha: float) -> float:
    """Splitting under additive scaling: s=1, E[Y_{n:n}] = E[X_{n:n}]."""
    return osl.pareto_order_stat(n, n, lam, alpha)


def pareto_replication_lower_bound(
    n: int, lam: float, alpha: float, eta: float = 1.0
) -> float:
    """Thm. 7 proof bound: E[Y_{1:n}] >= n (m - eta) (1 - 21 xi / (n^2 eta^4))^n."""
    if alpha <= 4:
        raise ValueError("bound requires the 4th moment (alpha > 4)")
    m = lam * alpha / (alpha - 1.0)
    xi = alpha * lam**4 / (alpha - 4.0)  # E[X^4]
    rn = max(1.0 - 21.0 * xi / (n**2 * eta**4), 0.0) ** n
    return n * (m - eta) * rn


# --------------------------------------------------------------------------
# Bi-Modal  (Sec. VI)
# --------------------------------------------------------------------------

def bimodal_server_dependent(k: int, n: int, B: float, eps: float) -> float:
    """Eq. (12): E[Y_{k:n}] = s + s (B-1) Pr{X_{k:n} = B}."""
    s = _s(k, n)
    return s * osl.bimodal_order_stat(k, n, B, eps)


def bimodal_data_dependent(
    k: int, n: int, B: float, eps: float, delta: float
) -> float:
    """Eq. (14): E[Y_{k:n}] = s Delta + 1 + (B-1) Pr{X_{k:n} = B}."""
    s = _s(k, n)
    return s * delta + osl.bimodal_order_stat(k, n, B, eps)


def bimodal_additive(k: int, n: int, B: float, eps: float) -> float:
    """Lemma 1 / eq. (22): exact E[Y_{k:n}] for sums of Bi-Modal CUs."""
    s = _s(k, n)
    return osl.bimodal_sum_order_stat(k, n, s, B, eps)


def bimodal_server_dependent_lln(r: float, B: float, eps: float) -> float:
    """Thm. 8: E[Y_{k:n}] ~ p_r / r + B q_r / r,  r = k/n, as n -> inf."""
    p = 1.0 if (1.0 - eps) > r else 0.0
    return (p + B * (1.0 - p)) / r


def bimodal_data_dependent_lln(r: float, B: float, eps: float, delta: float) -> float:
    """Thm. 9: E[Y_{k:n}] ~ Delta / r + p_r + B q_r,  r = k/n, as n -> inf."""
    p = 1.0 if (1.0 - eps) > r else 0.0
    return delta / r + p + B * (1.0 - p)


# --------------------------------------------------------------------------
# Unified dispatchers: whole-curve (batched, the hot path) and single-point
# --------------------------------------------------------------------------

def completion_curve(
    dist: ServiceTime,
    scaling: Scaling,
    n: int,
    ks: Optional[Sequence[int]] = None,
    delta: Optional[float] = None,
    mc_trials: int = 100_000,
    mc_seed: int = 0,
) -> dict:
    """k -> E[Y_{k:n}] for every k in ``ks`` (default: divisors of n) in one
    batched pass over the shared order-statistic survival table.

    This is the planner's hot path: under server-/data-dependent scaling the
    task time is an affine map of a k-independent base variable, so ALL
    order statistics come from one cumulative-sum table (core.batched);
    under additive scaling the base distribution itself depends on s = n/k
    and each k runs a vectorized (not shared) pass.  Closed-form families
    reproduce the scalar reference functions bit-for-bit; quadrature curves
    agree to ~1e-9 relative; Pareto-additive keeps the paper's deterministic
    MC estimate (Fig. 9) with the same per-k seeds as the scalar path.
    """
    if ks is None:
        ks = batched.divisors(n)
    ks_arr = np.asarray(list(ks), dtype=np.int64)
    if ks_arr.size and ((n % ks_arr) != 0).any():
        bad = ks_arr[(n % ks_arr) != 0]
        raise ValueError(f"every k must divide n={n}; offending k={bad.tolist()}")
    s_arr = n // ks_arr

    if isinstance(dist, ShiftedExp):
        if scaling is Scaling.SERVER_DEPENDENT:
            vals = dist.delta + s_arr * dist.W * batched.exponential_order_stat_curve(
                ks_arr, n, 1.0)
        elif scaling is Scaling.DATA_DEPENDENT:
            vals = s_arr * dist.delta + dist.W * batched.exponential_order_stat_curve(
                ks_arr, n, 1.0)
        elif dist.W == 0.0:
            vals = (s_arr * dist.delta).astype(np.float64)
        else:
            vals = s_arr * dist.delta + batched.erlang_order_stat_curve(
                ks_arr, n, s_arr, dist.W)
    elif isinstance(dist, Pareto):
        if scaling is Scaling.SERVER_DEPENDENT:
            vals = s_arr * batched.pareto_order_stat_curve(ks_arr, n, dist.lam, dist.alpha)
        elif scaling is Scaling.DATA_DEPENDENT:
            vals = s_arr * (0.0 if delta is None else delta) + batched.pareto_order_stat_curve(
                ks_arr, n, dist.lam, dist.alpha)
        else:
            vals = np.array([
                pareto_additive_mc(int(k), n, dist.lam, dist.alpha, mc_trials, mc_seed)
                for k in ks_arr
            ])
    elif isinstance(dist, BiModal):
        xkn = 1.0 + (dist.B - 1.0) * batched.bimodal_straggle_curve(ks_arr, n, dist.eps)
        if scaling is Scaling.SERVER_DEPENDENT:
            vals = s_arr * xkn
        elif scaling is Scaling.DATA_DEPENDENT:
            vals = s_arr * (0.0 if delta is None else delta) + xkn
        else:
            vals = batched.bimodal_sum_order_stat_curve(
                ks_arr, n, s_arr, dist.B, dist.eps)
    else:
        raise TypeError(f"unsupported distribution {type(dist).__name__}")
    return {int(k): float(v) for k, v in zip(ks_arr, vals)}


def expected_completion_time(
    dist: ServiceTime,
    scaling: Scaling,
    k: int,
    n: int,
    delta: Optional[float] = None,
    mc_trials: int = 100_000,
    mc_seed: int = 0,
) -> float:
    """E[Y_{k:n}] for any supported (distribution, scaling) pair.

    ``delta`` is the exogenous per-CU deterministic time for Pareto/Bi-Modal
    under data-dependent scaling (Sec. V-B, VI-B); ShiftedExp carries its own.
    Scalar reference path; ``completion_curve`` computes the whole k-curve
    for barely more than one call of this.
    """
    if isinstance(dist, ShiftedExp):
        if scaling is Scaling.SERVER_DEPENDENT:
            return sexp_server_dependent(k, n, dist.delta, dist.W)
        if scaling is Scaling.DATA_DEPENDENT:
            return sexp_data_dependent(k, n, dist.delta, dist.W)
        return sexp_additive(k, n, dist.delta, dist.W)
    if isinstance(dist, Pareto):
        if scaling is Scaling.SERVER_DEPENDENT:
            return pareto_server_dependent(k, n, dist.lam, dist.alpha)
        if scaling is Scaling.DATA_DEPENDENT:
            return pareto_data_dependent(k, n, dist.lam, dist.alpha, 0.0 if delta is None else delta)
        return pareto_additive_mc(k, n, dist.lam, dist.alpha, mc_trials, mc_seed)
    if isinstance(dist, BiModal):
        if scaling is Scaling.SERVER_DEPENDENT:
            return bimodal_server_dependent(k, n, dist.B, dist.eps)
        if scaling is Scaling.DATA_DEPENDENT:
            return bimodal_data_dependent(k, n, dist.B, dist.eps, 0.0 if delta is None else delta)
        return bimodal_additive(k, n, dist.B, dist.eps)
    raise TypeError(f"unsupported distribution {type(dist).__name__}")
