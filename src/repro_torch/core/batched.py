"""Batched order-statistic engine: every E[Y_{k:n}] of a k-curve in one pass.

The paper's central object is the full trade-off curve k -> E[Y_{k:n}] over
the divisors of n -- the planner's arg-min over it selects replication,
coding, or splitting.  The seed computed each point independently, repeating
O(n) work per k.  This module exploits the *shared-survival-table identity*
to compute the whole curve for barely more than the cost of one point:

    Pr{Y_{k:n} > t} = Pr{fewer than k of n samples are <= t}
                    = Pr{Binom(n, F(t)) < k}
                    = sum_{i=0}^{k-1} C(n,i) F(t)^i S(t)^{n-i}

The summand ``exp(log C(n,i) + i log F(t) + (n-i) log S(t))`` depends on
(t, i) but NOT on k: one (t, i) log-term table serves every k, and the
order-statistic survival of *all* k at once is a single cumulative sum over
the i axis.  A k-curve by quadrature therefore costs one table build plus
one cumsum, instead of d(n) independent quadratures each rebuilding an
O(k)-term sum per node.

The same collapsing applies to the closed forms:

  * Exponential  E[X_{k:n}] = W (H_n - H_{n-k}): all k read from one cached
    cumulative harmonic-number array (``harmonic_numbers``), killing the
    O(n) summation per call / O(n d(n)) per curve of the scalar path.
  * Bi-Modal     Pr{X_{k:n} = B} = Pr{Binom(n, 1-eps) < k}: one log-stable
    term row + cumsum gives the straggle probability at every k.
  * Pareto       per-k log-gamma closed form (already O(1) per k).

Gauss-Legendre nodes are cached per node-count (``leggauss``), and the
quadrature bracketing/segmentation is done once per curve (for the largest
k, whose order statistic has the widest support) instead of once per point.

Everything here is plain NumPy (the planner's host-side hot path); the
Monte-Carlo counterpart with common random numbers and a single draw per
curve lives in ``core.simulator``.

Bit-exactness contract: for the closed-form families the batched curves
reproduce the scalar reference functions in ``order_stats.py`` bit-for-bit
(same log-term formulas, same left-to-right accumulation order); quadrature
curves agree to ~1e-9 relative (shared bracketing differs only where the
integrand is below the 1e-12 truncation tolerance).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "divisors",
    "leggauss",
    "harmonic_numbers",
    "binom_lt_curves",
    "batched_order_stat_survival",
    "expected_order_stats",
    "exponential_order_stat_curve",
    "pareto_order_stat_curve",
    "bimodal_straggle_curve",
    "bimodal_sum_order_stat_curve",
    "erlang_order_stat_curve",
]


def divisors(n: int) -> list:
    """All positive divisors of n, ascending (the legal k values).

    Single source of truth for every layer (planner, expectations,
    simulator) that enumerates a k-curve's support.
    """
    return [d for d in range(1, n + 1) if n % d == 0]


@functools.lru_cache(maxsize=32)
def leggauss(n_nodes: int):
    """Cached Gauss-Legendre (nodes, weights) on [-1, 1]."""
    return np.polynomial.legendre.leggauss(n_nodes)


# --------------------------------------------------------------------------
# Harmonic numbers: one growing cumulative array, O(1) amortized per query
# --------------------------------------------------------------------------

_HARMONIC_EXACT_MAX = 10_000          # beyond this the scalar path uses the
_EULER_GAMMA = 0.5772156649015328606  # log approximation (paper App. A-A1)

_harmonic_cache = np.zeros(1, dtype=np.float64)  # H_0 = 0


def harmonic_numbers(n: int) -> np.ndarray:
    """Cumulative harmonic array ``H`` with ``H[j] = H_j`` for j = 0..n.

    Grown once and cached; every divisor curve reads all its H_n / H_{n-k}
    values from the same buffer.  ``np.cumsum`` accumulates left-to-right,
    so entries are bit-identical to the scalar ``sum(1/j for j in 1..n)``.
    """
    global _harmonic_cache
    if n < 0:
        raise ValueError("n must be >= 0")
    if n > _HARMONIC_EXACT_MAX:
        raise ValueError(
            f"exact harmonic table capped at {_HARMONIC_EXACT_MAX}; "
            "use order_stats.harmonic for the asymptotic regime"
        )
    if n >= _harmonic_cache.size:
        m = max(n + 1, min(2 * _harmonic_cache.size, _HARMONIC_EXACT_MAX + 1))
        h = np.empty(m, dtype=np.float64)
        h[0] = 0.0
        np.cumsum(1.0 / np.arange(1, m, dtype=np.float64), out=h[1:])
        _harmonic_cache = h
    return _harmonic_cache[: n + 1]


# --------------------------------------------------------------------------
# The shared-table primitive: Pr{Binom(n, p) < k} for all k at once
# --------------------------------------------------------------------------

def _check_ks(ks: np.ndarray, n: int) -> np.ndarray:
    ks = np.asarray(ks, dtype=np.int64)
    if ks.size == 0 or ks.min() < 1 or ks.max() > n:
        raise ValueError(f"require 1 <= k <= n={n} for every k, got {ks}")
    return ks


def _log_binom_coeffs(n: int, kmax: int) -> np.ndarray:
    """log C(n, i) for i = 0..kmax-1 via the same lgamma expression as the
    scalar `_binom_lt_k` (term-level bit parity matters downstream)."""
    lg_n1 = math.lgamma(n + 1)
    return np.array(
        [lg_n1 - math.lgamma(i + 1) - math.lgamma(n - i + 1) for i in range(kmax)]
    )


def binom_lt_curves(
    n: int, ks: Sequence[int], p: np.ndarray, exact_terms: bool = False
) -> np.ndarray:
    """``out[j, m] = Pr{Binom(n, p[j]) < ks[m]}`` from one (p, i) term table.

    With ``exact_terms=True`` each table entry uses scalar ``math.exp``,
    making every partial sum bit-identical to the scalar ``_binom_lt_k``
    accumulation (used by the closed-form Bi-Modal curves); the default
    vectorized ``np.exp`` path serves large quadrature node tables where
    libm-vs-SIMD last-ulp parity does not matter.  The cumulative sum over
    i is the only k-dependence either way.
    """
    ks = _check_ks(np.asarray(ks), n)
    p = np.atleast_1d(np.asarray(p, dtype=np.float64))
    kmax = int(ks.max())
    logc = _log_binom_coeffs(n, kmax)
    i = np.arange(kmax, dtype=np.float64)

    interior = (p > 0.0) & (p < 1.0)
    terms = np.zeros((p.size, kmax), dtype=np.float64)
    if exact_terms:
        for row in np.nonzero(interior)[0]:
            lp, lq = math.log(p[row]), math.log(1.0 - p[row])
            terms[row] = [
                math.exp(logc[j] + j * lp + (n - j) * lq) for j in range(kmax)
            ]
    elif interior.any():
        pi = p[interior]
        lp = np.log(pi)[:, None]
        lq = np.log(1.0 - pi)[:, None]
        terms[interior] = np.exp(logc[None, :] + i[None, :] * lp + (n - i[None, :]) * lq)

    cum = np.minimum(np.cumsum(terms, axis=1), 1.0)
    out = cum[:, ks - 1]
    out[p >= 1.0] = 0.0   # every sample below threshold: Binom = n >= k
    out[p <= 0.0] = 1.0   # no sample below threshold: Binom = 0 < k
    return out


# --------------------------------------------------------------------------
# Batched order-statistic survival + one-pass quadrature
# --------------------------------------------------------------------------

def batched_order_stat_survival(
    survival: Callable[[np.ndarray], np.ndarray],
    ks: Sequence[int],
    n: int,
) -> Callable[[np.ndarray], np.ndarray]:
    """``surv(t)[j, m] = Pr{Y_{ks[m]:n} > t[j]}`` sharing one term table.

    Edge handling matches the scalar ``order_stat_survival``: F <= 0 gives
    survival 1, S <= 0 gives survival 0.
    """
    ks = _check_ks(np.asarray(ks), n)

    def surv(t: np.ndarray) -> np.ndarray:
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        S = np.clip(np.asarray(survival(t), dtype=np.float64), 0.0, 1.0)
        return binom_lt_curves(n, ks, 1.0 - S)

    return surv


def expected_order_stats(
    survival: Callable[[np.ndarray], np.ndarray],
    ks: Sequence[int],
    n: int,
    lower: float = 0.0,
    scale: float = 1.0,
    n_nodes: int = 600,
    tol: float = 1e-12,
) -> np.ndarray:
    """E[Y_{k:n}] for every k in ``ks`` by ONE quadrature pass.

    Mirrors the scalar ``expected_order_stat`` (bracketing by doubling,
    geometric segmentation, Gauss-Legendre per segment) but brackets once
    using the largest k -- Y_{k:n} is stochastically increasing in k, so the
    widest support dominates -- and evaluates the shared (t, i) table once
    per segment for all k simultaneously.
    """
    ks = _check_ks(np.asarray(ks), n)
    surv = batched_order_stat_survival(survival, ks, n)
    kmax_col = int(np.argmax(ks))

    upper = max(lower + scale, lower * 2 + 1.0)
    for _ in range(200):
        if surv(np.array([upper]))[0, kmax_col] < tol:
            break
        upper *= 1.6

    nodes, weights = leggauss(max(n_nodes // 8, 32))
    total = np.full(ks.shape, lower, dtype=np.float64)
    width0 = max(scale * 1e-3, (upper - lower) * 1e-6, 1e-12)
    edges = [lower]
    w = width0
    while edges[-1] < upper:
        edges.append(min(edges[-1] + w, upper))
        w *= 1.7
    for a, b in zip(edges[:-1], edges[1:]):
        t = 0.5 * (b - a) * nodes + 0.5 * (a + b)
        total += 0.5 * (b - a) * (surv(t) * weights[:, None]).sum(axis=0)
    return total


# --------------------------------------------------------------------------
# Closed-form curves (batched counterparts of order_stats.py scalars)
# --------------------------------------------------------------------------

def exponential_order_stat_curve(ks: Sequence[int], n: int, W: float = 1.0) -> np.ndarray:
    """E[X_{k:n}] = W (H_n - H_{n-k}) for all k, from the cached H array.

    Beyond the exact-table cap the scalar ``harmonic`` (log approximation,
    paper App. A-A1) takes over, matching the scalar path's behavior.
    """
    ks = _check_ks(np.asarray(ks), n)
    if n > _HARMONIC_EXACT_MAX:
        from .order_stats import harmonic
        return W * np.array([harmonic(n) - harmonic(n - int(k)) for k in ks])
    H = harmonic_numbers(n)
    return W * (H[n] - H[n - ks])


def pareto_order_stat_curve(
    ks: Sequence[int], n: int, lam: float = 1.0, alpha: float = 2.0
) -> np.ndarray:
    """Eq. (19) at every k (log-gamma form, identical ops to the scalar)."""
    ks = _check_ks(np.asarray(ks), n)
    inv = 1.0 / alpha
    out = np.empty(ks.size, dtype=np.float64)
    lg_n1 = math.lgamma(n + 1)
    lg_tail = math.lgamma(n + 1 - inv)
    for m, k in enumerate(ks):
        if alpha <= 1.0 and k == n:
            out[m] = math.inf
            continue
        logv = lg_n1 - math.lgamma(n - k + 1) + math.lgamma(n - k + 1 - inv) - lg_tail
        out[m] = lam * math.exp(logv)
    return out


def bimodal_straggle_curve(ks: Sequence[int], n: int, eps: float) -> np.ndarray:
    """Pr{X_{k:n} = B} = Pr{Binom(n, 1-eps) < k} for all k: one cumsum."""
    return binom_lt_curves(n, ks, np.array([1.0 - eps]), exact_terms=True)[0]


def bimodal_sum_order_stat_curve(
    ks: Sequence[int], n: int, s_of_k: Sequence[int], B: float, eps: float
) -> np.ndarray:
    """Lemma 1 / eq. (22) curve: E[Y_{k:n}] for Y = sum of s(k) Bi-Modal CUs.

    Additive scaling makes the task distribution itself k-dependent
    (s = n/k), so the table cannot be shared *across* k; instead each k
    shares its (w, i) table across the s+1 support atoms -- one
    ``binom_lt_curves`` call per k replaces the scalar's s nested Python
    loops of length k.
    """
    ks = _check_ks(np.asarray(ks), n)
    from .order_stats import bimodal_sum_pmf  # local: avoid import cycle

    out = np.empty(ks.size, dtype=np.float64)
    for m, (k, s) in enumerate(zip(ks, np.asarray(s_of_k, dtype=np.int64))):
        vals, probs = bimodal_sum_pmf(int(s), B, eps)
        cdf = np.minimum(np.maximum(np.cumsum(probs), 0.0), 1.0)
        tails = binom_lt_curves(n, [int(k)], cdf[:-1], exact_terms=True)[:, 0]
        e = vals[0]
        for w in range(1, int(s) + 1):
            e += (vals[w] - vals[w - 1]) * tails[w - 1]
        out[m] = e
    return out


def erlang_order_stat_curve(
    ks: Sequence[int], n: int, s_of_k: Sequence[int], W: float = 1.0
) -> np.ndarray:
    """E[Z_{k:n}], Z ~ Erlang(s(k), W), batched over the i axis per k.

    Like the Bi-Modal additive case the base distribution varies with k
    (s = n/k), so each k runs its own quadrature -- but with the (t, i)
    table vectorized and the GL nodes cached, instead of the scalar path's
    per-node Python loop over i.
    """
    ks = _check_ks(np.asarray(ks), n)
    from .order_stats import erlang_survival  # local: avoid import cycle

    out = np.empty(ks.size, dtype=np.float64)
    for m, (k, s) in enumerate(zip(ks, np.asarray(s_of_k, dtype=np.int64))):
        surv = lambda t, _s=int(s): erlang_survival(t, _s, W)
        out[m] = expected_order_stats(
            surv, [int(k)], n, lower=0.0, scale=int(s) * W + 1.0
        )[0]
    return out
