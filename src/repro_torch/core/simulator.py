"""Vectorized Monte-Carlo simulation of coded job completion (paper Figs.).

Simulates the paper's system end to end: n workers, task size s CUs under a
scaling model, job completes at the k-th order statistic.  Draws are
float32 tensors on the requested device; used to

  * validate every closed form in expectations.py,
  * produce the Pareto-additive curve (paper's own Fig. 9 methodology),
  * drive the runtime's straggler mask sampling.

Whole-curve estimation is BATCHED: ``completion_curve_mc`` draws one
(trials, n) common-random-number sample, sorts it once, and reads every
order statistic from the sorted matrix, instead of one sample per k.
``completion_curves_grid_mc`` shares one base sample across a whole
parameter grid as well.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, generator, target
from .batched import divisors
from .distributions import BiModal, Pareto, Scaling, ServiceTime, ShiftedExp

__all__ = [
    "sample_task_times",
    "job_completion_times",
    "expected_completion_mc",
    "completion_curve_mc",
    "completion_curves_grid_mc",
    "curve_compile_count",
    "straggler_mask",
    "empirical_survival",
]


def sample_task_times(
    dist: ServiceTime,
    generator: torch.Generator,
    trials: int,
    n: int,
    s: int,
    scaling: Scaling,
    delta: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    """(trials, n) i.i.d. task service times for tasks of s CUs, on
    ``device`` (default: the generator's)."""
    return dist.sample_task(generator, (trials, n), s, scaling, delta=delta,
                            device=device)


def job_completion_times(task_times: torch.Tensor, k: int) -> torch.Tensor:
    """Y_{k:n} per trial: k-th smallest of each row."""
    return torch.kthvalue(task_times, k, dim=-1).values


def expected_completion_mc(
    dist: ServiceTime,
    scaling: Scaling,
    k: int,
    n: int,
    trials: int = 100_000,
    seed: int = 0,
    delta: Optional[float] = None,
    device=DEFAULT_DEVICE,
) -> float:
    """Monte-Carlo E[Y_{k:n}] with the paper's geometry s = n/k."""
    if n % k:
        raise ValueError(f"k={k} must divide n={n}")
    s = n // k
    t = sample_task_times(dist, generator(seed, device), trials, n, s,
                          scaling, delta=delta)
    return float(job_completion_times(t, k).mean())


# --------------------------------------------------------------------------
# Batched whole-curve MC: one CRN sample, one sort per curve
# --------------------------------------------------------------------------

_CURVE_EVALS = 0


def curve_compile_count() -> int:
    """How many batched curves (or curve grids) have been evaluated.

    The name is kept from the traced implementation, where it counted
    compilations; this package runs eagerly and compiles nothing, so it
    ticks once per ``completion_curve_mc`` / ``completion_curves_grid_mc``
    call.
    """
    return _CURVE_EVALS


def _curve(generator, dist, scaling, n, ks, trials, delta, device):
    """All E[Y_{k:n}] for k in ``ks`` from one common-random-number draw.

    Server-/data-dependent scaling: the task time is an affine map of one
    k-independent noise matrix, so a single sort yields every order
    statistic and E[Y_{k:n}] = a_k + b_k * mean(Z_{(k)}).  Additive
    scaling: one (trials, n, s_max) draw prefix-summed over the CU axis
    gives the task times of EVERY task size s = n/k from the same CUs.
    """
    d = dist.shift if delta is None else float(delta)
    s_of_k = [n // k for k in ks]
    if scaling is Scaling.ADDITIVE:
        draws = dist.sample(generator, (trials, n, max(s_of_k)), device)
        csum = torch.cumsum(draws, dim=-1)
        outs = []
        for k, s in zip(ks, s_of_k):
            task_sorted = torch.sort(csum[..., s - 1], dim=1).values
            outs.append(task_sorted[:, k - 1].mean())
        return torch.stack(outs)
    zs = torch.sort(dist.sample_noise(generator, (trials, n), device),
                    dim=1).values
    col_means = zs[:, [k - 1 for k in ks]].mean(dim=0)
    s_arr = torch.tensor(s_of_k, dtype=col_means.dtype,
                         device=col_means.device)
    if scaling is Scaling.SERVER_DEPENDENT:
        return d + s_arr * col_means
    return s_arr * d + col_means


def _check_ks(n: int, ks) -> tuple:
    if ks is None:
        ks = divisors(n)
    ks = tuple(int(k) for k in ks)
    for k in ks:
        if n % k:
            raise ValueError(f"k={k} must divide n={n}")
    return ks


def completion_curve_mc(
    dist: ServiceTime,
    scaling: Scaling,
    n: int,
    ks: Optional[Sequence[int]] = None,
    trials: int = 100_000,
    seed: int = 0,
    delta: Optional[float] = None,
    device=DEFAULT_DEVICE,
) -> dict:
    """k -> MC E[Y_{k:n}] over the divisors of n (one figure curve).

    One common-random-number sample for the whole curve; CRN makes the
    curve smooth in k and the run reproducible for a fixed seed on one
    device.
    """
    global _CURVE_EVALS
    ks = _check_ks(n, ks)
    gen = generator(seed, device)
    vals = _curve(gen, dist, scaling, n, ks, int(trials),
                  None if delta is None else float(delta), gen.device)
    _CURVE_EVALS += 1
    return {k: float(v) for k, v in zip(ks, vals.cpu().numpy())}


# --------------------------------------------------------------------------
# Parameter-grid curves: Table-I sweeps from one shared base sample
# --------------------------------------------------------------------------

_FAMILY_OF = {ShiftedExp: "shifted_exp", Pareto: "pareto", BiModal: "bimodal"}


def _grid(gen, params, family, scaling, n, ks, trials, delta):
    """(num_scenarios, len(ks)) curve matrix.

    One base sample (standard exponential / uniform) is shared by every
    scenario -- common random numbers across the grid as well as across
    k -- and each scenario's inverse-CDF transform, sort, and
    order-statistic reads run in turn on it.
    """
    s_of_k = [n // k for k in ks]
    kidx = [k - 1 for k in ks]
    dev = gen.device
    s_arr = torch.tensor(s_of_k, dtype=torch.float32, device=dev)
    additive = scaling is Scaling.ADDITIVE
    shape = (trials, n, max(s_of_k)) if additive else (trials, n)
    base = torch.empty(shape, dtype=torch.float32, device=dev)
    if family == "shifted_exp":
        base.exponential_(generator=gen)
    else:
        # clamp at the 2^-24 quantile, matching Pareto.sample
        base.uniform_(2.0 ** -24, 1.0, generator=gen)

    rows = []
    for p0, p1 in params.tolist():       # float32 values, as Python floats
        if family == "shifted_exp":
            shift, noise = p0, p1 * base                  # (delta, W)
        elif family == "pareto":
            shift, noise = 0.0, p0 * base ** (-1.0 / p1)  # (lam, alpha)
        else:
            shift = 0.0                                    # (B, eps)
            noise = torch.where(base < p1, p0, 1.0).to(torch.float32)
        d = shift if delta is None else delta
        if additive:
            csum = torch.cumsum(shift + noise, dim=-1)
            rows.append(torch.stack([
                torch.sort(csum[..., s - 1], dim=1).values[:, k - 1].mean()
                for k, s in zip(ks, s_of_k)]))
            continue
        col_means = torch.sort(noise, dim=1).values[:, kidx].mean(dim=0)
        if scaling is Scaling.SERVER_DEPENDENT:
            rows.append(d + s_arr * col_means)
        else:
            rows.append(s_arr * d + col_means)
    return torch.stack(rows)


def completion_curves_grid_mc(
    dists: Sequence[ServiceTime],
    scaling: Scaling,
    n: int,
    ks: Optional[Sequence[int]] = None,
    trials: int = 20_000,
    seed: int = 0,
    delta: Optional[float] = None,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """MC curves for a whole scenario grid from one shared base sample.

    ``dists`` must share one family (ShiftedExp | Pareto | BiModal); their
    parameters are stacked into a (num_scenarios, 2) float32 matrix.
    Returns (num_scenarios, len(ks)).
    """
    global _CURVE_EVALS
    fams = {type(d) for d in dists}
    if len(fams) != 1 or next(iter(fams)) not in _FAMILY_OF:
        raise ValueError(f"dists must share one supported family, got {fams}")
    family = _FAMILY_OF[next(iter(fams))]
    ks = _check_ks(n, ks)
    if family == "shifted_exp":
        params = np.array([[d.delta, d.W] for d in dists], dtype=np.float32)
    elif family == "pareto":
        params = np.array([[d.lam, d.alpha] for d in dists], dtype=np.float32)
    else:
        params = np.array([[d.B, d.eps] for d in dists], dtype=np.float32)
    out = _grid(generator(seed, device), params, family, scaling, n, ks,
                int(trials), None if delta is None else float(delta))
    _CURVE_EVALS += 1
    return out.cpu().numpy()


def straggler_mask(generator: torch.Generator, n: int, eps: float,
                   device=None) -> torch.Tensor:
    """Bool (n,) worker-finish mask: True = finished in time (Bi-Modal view).

    The runtime's coded step consumes this to zero out straggler decode
    coefficients; on a real cluster it comes from gather timeouts instead.
    """
    return ~(torch.rand((n,), generator=generator,
                        device=target(generator, device)) < eps)


def empirical_survival(samples: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Empirical Pr{Y > x} -- used to check stochastic dominance (Thm. 5)."""
    samples = np.sort(np.asarray(samples))
    idx = np.searchsorted(samples, xs, side="right")
    return 1.0 - idx / samples.size
