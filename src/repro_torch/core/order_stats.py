"""Order-statistic expectations used throughout the paper (Appendix A).

Closed forms implemented:
  * exponential_order_stat   -- eq. (17): E[X_{k:n}] = W (H_n - H_{n-k})
  * erlang_order_stat_exact  -- eq. (18) (Gupta 1960), exact rational arithmetic
  * pareto_order_stat        -- eq. (19) via log-gamma
  * gamma_ratio_approx       -- eq. (20): Gamma(x+b)/Gamma(x+a) ~ x^{b-a}
  * bimodal_order_stat       -- eq. (12) building block
  * bimodal_sum_order_stat   -- Lemma 1 / eq. (22), exact for additive Bi-Modal
  * birthday_expectation     -- eq. (23): generalized birthday problem
  * birthday_asymptotic      -- eq. (24)

Plus a generic engine:
  * expected_order_stat(survival, k, n) -- E[Y_{k:n}] by quadrature of the
    order-statistic survival function, for any task-time distribution.  Used
    for Erlang (validated against eq. (18)) and anywhere the paper resorts to
    numerics.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Callable, Sequence

import numpy as np

from .batched import harmonic_numbers

__all__ = [
    "harmonic",
    "exponential_order_stat",
    "erlang_order_stat_exact",
    "erlang_order_stat",
    "erlang_survival",
    "pareto_order_stat",
    "gamma_ratio_approx",
    "bimodal_straggle_prob",
    "bimodal_order_stat",
    "bimodal_sum_order_stat",
    "birthday_expectation",
    "birthday_asymptotic",
    "order_stat_survival",
    "expected_order_stat",
]

EULER_GAMMA = 0.5772156649015328606


def harmonic(n: int) -> float:
    """H_n = sum_{j=1..n} 1/j, read from the cached cumulative array.

    The cumulative table (core.batched) makes this O(1) amortized instead
    of an O(n) summation per call; values are bit-identical to the previous
    left-to-right scalar sum.
    """
    if n < 0:
        raise ValueError("n must be >= 0")
    if n <= 10_000:
        return float(harmonic_numbers(n)[n])
    # log approximation (paper, App. A-A1) for very large n
    return math.log(n) + EULER_GAMMA + 1.0 / (2 * n)


# --------------------------------------------------------------------------
# Exponential -- eq. (17)
# --------------------------------------------------------------------------

def exponential_order_stat(k: int, n: int, W: float = 1.0) -> float:
    """E[X_{k:n}] for X ~ Exp(mean W):  W (H_n - H_{n-k})."""
    _check_kn(k, n)
    return W * (harmonic(n) - harmonic(n - k))


# --------------------------------------------------------------------------
# Erlang -- eq. (18), exact (Gupta 1960) and by quadrature
# --------------------------------------------------------------------------

def _poly_pow_expseries(x: int, y: int) -> Sequence[Fraction]:
    """Coefficients of (sum_{l=0}^{x-1} t^l / l!)^y as exact rationals."""
    base = [Fraction(1, math.factorial(l)) for l in range(x)]
    out = [Fraction(1)]
    for _ in range(y):
        new = [Fraction(0)] * (len(out) + len(base) - 1)
        for i, a in enumerate(out):
            if a == 0:
                continue
            for j, b in enumerate(base):
                new[i + j] += a * b
        out = new
    return out


def erlang_order_stat_exact(k: int, n: int, s: int, W: float = 1.0) -> float:
    """E[X_{k:n}] for X ~ Erlang(s, W) via eq. (18), exact rational arithmetic.

    Practical for paper-scale n (n <= ~20); use erlang_order_stat() for the
    general case.
    """
    _check_kn(k, n)
    total = Fraction(0)
    c_nk = math.comb(n, k)
    for i in range(k):
        y = n - k + i
        alphas = _poly_pow_expseries(s, y)
        inner = Fraction(0)
        base = y + 1
        for j, aj in enumerate(alphas):
            if aj == 0:
                continue
            inner += aj * Fraction(math.factorial(s + j), base ** (s + j + 1))
        total += (-1) ** i * math.comb(k - 1, i) * inner
    total *= Fraction(k * c_nk, math.factorial(s - 1))
    return W * float(total)


def erlang_survival(t: np.ndarray, s: int, W: float = 1.0) -> np.ndarray:
    """Pr{Erlang(s, W) > t} = e^{-t/W} sum_{l<s} (t/W)^l / l!, stable in logs."""
    t = np.asarray(t, dtype=np.float64)
    x = np.maximum(t / W, 0.0)
    # log terms: l*log(x) - lgamma(l+1); logsumexp over l then subtract x
    ls = np.arange(s, dtype=np.float64)
    # x <= 0 rows are overwritten to survival 1.0 below; use logx = 0
    # there instead of -inf so the l = 0 term is not 0 * -inf = nan
    with np.errstate(divide="ignore"):
        logx = np.where(x > 0, np.log(np.maximum(x, 1e-300)), 0.0)
    logterms = ls[None, :] * logx.reshape(-1, 1) - np.array(
        [math.lgamma(l + 1.0) for l in range(s)]
    )
    m = logterms.max(axis=1, keepdims=True)
    lse = (m[:, 0] + np.log(np.exp(logterms - m).sum(axis=1)))
    out = np.exp(np.minimum(lse - x.reshape(-1), 0.0))
    out = np.where(x.reshape(-1) <= 0, 1.0, out)
    return out.reshape(t.shape)


def erlang_order_stat(k: int, n: int, s: int, W: float = 1.0) -> float:
    """E[X_{k:n}] for X ~ Erlang(s, W) by survival-function quadrature."""
    _check_kn(k, n)
    surv = lambda t: erlang_survival(t, s, W)
    return expected_order_stat(surv, k, n, lower=0.0, scale=s * W + 1.0)


# --------------------------------------------------------------------------
# Pareto -- eq. (19) and eq. (20)
# --------------------------------------------------------------------------

def pareto_order_stat(k: int, n: int, lam: float = 1.0, alpha: float = 2.0) -> float:
    """E[X_{k:n}] = lam * n!/(n-k)! * Gamma(n-k+1-1/a)/Gamma(n+1-1/a)  (a>1).

    Computed in log space; exact (not the eq. (20) approximation).
    """
    _check_kn(k, n)
    if alpha <= 1.0 and k == n:
        return math.inf
    inv = 1.0 / alpha
    # Requires n-k+1-1/alpha > 0, true for alpha > 1.
    logv = (
        math.lgamma(n + 1)
        - math.lgamma(n - k + 1)
        + math.lgamma(n - k + 1 - inv)
        - math.lgamma(n + 1 - inv)
    )
    return lam * math.exp(logv)


def gamma_ratio_approx(x: float, beta: float, alpha: float) -> float:
    """Gamma(x+beta)/Gamma(x+alpha) ~ x^{beta-alpha}   (eq. (20))."""
    return x ** (beta - alpha)


# --------------------------------------------------------------------------
# Bi-Modal -- eq. (12) and Lemma 1 / eq. (22)
# --------------------------------------------------------------------------

def bimodal_straggle_prob(k: int, n: int, eps: float) -> float:
    """Pr{X_{k:n} = B} = sum_{i=0}^{k-1} C(n,i) (1-eps)^i eps^(n-i).

    The probability that fewer than k of the n workers are fast.  Routed
    through the log-stable ``_binom_lt_k``: the direct form multiplies huge
    ``math.comb(n, i)`` integers by vanishing powers, which overflows float
    conversion for large n (math.comb(1024, 512) ~ 1e307 alone).
    """
    _check_kn(k, n)
    return _binom_lt_k(n, k, 1.0 - eps)


def bimodal_order_stat(k: int, n: int, B: float, eps: float) -> float:
    """E[X_{k:n}] for X ~ Bi-Modal(B, eps): 1 + (B-1) Pr{X_{k:n}=B}."""
    return 1.0 + (B - 1.0) * bimodal_straggle_prob(k, n, eps)


def bimodal_sum_pmf(s: int, B: float, eps: float):
    """PMF of Y = sum of s i.i.d. Bi-Modal(B,eps):  (value, prob) per eq. (21).

    Log-stable terms (same defect class as ``bimodal_straggle_prob``: a raw
    ``math.comb(s, w)`` big-int overflows float conversion once s ~ 1030).
    """
    vals = np.array([s - w + w * B for w in range(s + 1)], dtype=np.float64)
    if eps <= 0.0 or eps >= 1.0:
        probs = np.zeros(s + 1, dtype=np.float64)
        probs[s if eps >= 1.0 else 0] = 1.0
        return vals, probs
    lp, lq = math.log(eps), math.log(1.0 - eps)
    lg_s1 = math.lgamma(s + 1)
    probs = np.array(
        [
            math.exp(lg_s1 - math.lgamma(w + 1) - math.lgamma(s - w + 1)
                     + (s - w) * lq + w * lp)
            for w in range(s + 1)
        ],
        dtype=np.float64,
    )
    return vals, probs


def bimodal_sum_order_stat(k: int, n: int, s: int, B: float, eps: float) -> float:
    """E[Y_{k:n}] for Y = sum of s i.i.d. Bi-Modal(B, eps)  (Lemma 1, eq. (22)).

    Implemented from the underlying discrete order-statistic identity
    E[Y_{k:n}] = sum over support of Pr{Y_{k:n} > y} jumps, which is
    algebraically identical to eq. (22) but numerically simpler and exact
    for a discrete distribution on s+1 atoms.
    """
    _check_kn(k, n)
    vals, probs = bimodal_sum_pmf(s, B, eps)
    cdf = np.cumsum(probs)
    # E[Y_{k:n}] = v_0 + sum_{w>=1} (v_w - v_{w-1}) * Pr{Y_{k:n} > v_{w-1}}
    # Pr{Y_{k:n} > v} = Pr{fewer than k of n samples <= v}
    e = vals[0]
    for w in range(1, s + 1):
        Fv = min(max(cdf[w - 1], 0.0), 1.0)
        tail = _binom_lt_k(n, k, Fv)
        e += (vals[w] - vals[w - 1]) * tail
    return float(e)


def _binom_lt_k(n: int, k: int, p: float) -> float:
    """Pr{Binomial(n, p) < k} computed directly (n modest)."""
    if p >= 1.0:
        return 0.0 if k <= n else 1.0
    if p <= 0.0:
        return 1.0
    q = 1.0 - p
    # sum_{i=0}^{k-1} C(n,i) p^i q^(n-i), log-stable per term
    tot = 0.0
    for i in range(k):
        logt = (
            math.lgamma(n + 1)
            - math.lgamma(i + 1)
            - math.lgamma(n - i + 1)
            + i * math.log(p)
            + (n - i) * math.log(q)
        )
        tot += math.exp(logt)
    return min(tot, 1.0)


# --------------------------------------------------------------------------
# Generalized birthday problem -- eqs. (23), (24)
# --------------------------------------------------------------------------

def birthday_expectation(n: int, d: int) -> float:
    """E(n,d) = int_0^inf e^{-t} [S_d(t/n)]^n dt  (eq. (23)).

    S_d(x) = sum_{l<d} x^l/l!.  Evaluated in log space by quadrature; the
    integrand e^{-t} S_d(t/n)^n <= 1 decays once t >> n*d.
    """
    if n < 1 or d < 1:
        raise ValueError("n, d >= 1")

    def log_integrand(t: np.ndarray) -> np.ndarray:
        x = t / n
        ls = np.arange(d, dtype=np.float64)
        with np.errstate(divide="ignore"):
            logx = np.where(x > 0, np.log(np.maximum(x, 1e-300)), -np.inf)
        logterms = ls[None, :] * logx.reshape(-1, 1) - np.array(
            [math.lgamma(l + 1.0) for l in range(d)]
        )
        m = logterms.max(axis=1, keepdims=True)
        logS = m[:, 0] + np.log(np.exp(logterms - m).sum(axis=1))
        return n * logS - t.reshape(-1)

    # integrand support: peak near t ~ n*d; integrate to where it is negligible
    upper = max(8.0 * n * d, 200.0)
    nodes, weights = np.polynomial.legendre.leggauss(400)
    # piecewise over 8 geometric segments for resolution near 0 and the peak
    total = 0.0
    edges = np.linspace(0.0, upper, 9)
    for a, b in zip(edges[:-1], edges[1:]):
        t = 0.5 * (b - a) * nodes + 0.5 * (a + b)
        total += 0.5 * (b - a) * float((np.exp(log_integrand(t)) * weights).sum())
    return total


def birthday_asymptotic(n: int, d: int) -> float:
    """E(n,d) ~ (d!)^{1/d} Gamma(1+1/d) n^{1-1/d}  as n -> inf  (eq. (24))."""
    return (
        math.exp(math.lgamma(d + 1.0) / d)
        * math.gamma(1.0 + 1.0 / d)
        * n ** (1.0 - 1.0 / d)
    )


# --------------------------------------------------------------------------
# Generic order-statistic expectation by quadrature
# --------------------------------------------------------------------------

def order_stat_survival(survival: Callable[[np.ndarray], np.ndarray], k: int, n: int):
    """Survival of the k-th order statistic from the sample survival fn.

    Pr{Y_{k:n} > t} = Pr{fewer than k of n samples <= t}
                    = sum_{i<k} C(n,i) F(t)^i S(t)^{n-i}
    """
    _check_kn(k, n)

    def surv_k(t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        S = np.clip(survival(t), 0.0, 1.0)
        F = 1.0 - S
        out = np.zeros_like(S)
        # log-stable accumulation
        with np.errstate(divide="ignore"):
            logF = np.log(np.maximum(F, 1e-300))
            logS = np.log(np.maximum(S, 1e-300))
        for i in range(k):
            logc = (
                math.lgamma(n + 1) - math.lgamma(i + 1) - math.lgamma(n - i + 1)
            )
            term = np.exp(logc + i * logF + (n - i) * logS)
            term = np.where(F <= 0.0, 1.0 if i == 0 else 0.0, term)
            term = np.where(S <= 0.0, 0.0, term)
            out = out + term
        return np.clip(out, 0.0, 1.0)

    return surv_k


def expected_order_stat(
    survival: Callable[[np.ndarray], np.ndarray],
    k: int,
    n: int,
    lower: float = 0.0,
    scale: float = 1.0,
    n_nodes: int = 600,
    tol: float = 1e-12,
) -> float:
    """E[Y_{k:n}] = lower + int_lower^inf Pr{Y_{k:n} > t} dt by quadrature.

    ``survival`` is the *sample* survival function Pr{Y > t}.  ``scale`` sets
    the initial bracketing guess for the effective upper limit, which is then
    grown by doubling until the order-statistic survival is below ``tol``.
    """
    surv_k = order_stat_survival(survival, k, n)
    # bracket the effective support
    upper = max(lower + scale, lower * 2 + 1.0)
    for _ in range(200):
        if surv_k(np.array([upper]))[0] < tol:
            break
        upper *= 1.6
    nodes, weights = np.polynomial.legendre.leggauss(max(n_nodes // 8, 32))
    # geometric segmentation: heavy-tailed survival functions span many
    # orders of magnitude; uniform two-segment quadrature misses the knee
    total = lower
    width0 = max(scale * 1e-3, (upper - lower) * 1e-6, 1e-12)
    edges = [lower]
    w = width0
    while edges[-1] < upper:
        edges.append(min(edges[-1] + w, upper))
        w *= 1.7
    for a, b in zip(edges[:-1], edges[1:]):
        t = 0.5 * (b - a) * nodes + 0.5 * (a + b)
        total += 0.5 * (b - a) * float((surv_k(t) * weights).sum())
    return total


def _check_kn(k: int, n: int) -> None:
    if not (1 <= k <= n):
        raise ValueError(f"require 1 <= k <= n, got k={k}, n={n}")
