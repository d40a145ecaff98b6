"""Shared failure dynamics: one crash-restart/relaunch rule, three users.

``core.scenario.FailureModel`` samples an exogenous per-worker schedule
of (crash, recovery) instants; this module defines what that schedule
DOES to a dispatched task.  ``effective_finish`` maps a task's dispatch
instant and nominal service time through the schedule and the
``RetryPolicy`` — advance past downtime, attempt, die on crash or
timeout, back off, relaunch, give up after ``max_attempts`` — returning
the instant the worker is released, whether the task completed, and how
many attempts were spent.

It is written once over an array-namespace parameter ``xp`` and consumed
with the SAME arithmetic:

  * ``runtime.cluster_batched`` calls it with :func:`torch_namespace`
    inside the job loop (the "downtime-inflated effective service time
    plus a bounded relaunch pass": ``max_attempts`` is a Python int, so
    the retry loop unrolls), every lane at once;
  * numpy callers pass ``numpy`` itself (float64, the clairvoyant-oracle
    twin);
  * ``runtime.cluster_oracle`` plays the same schedule event by event —
    an INDEPENDENT implementation whose agreement with this closed form
    is what the failure parity tests validate.

Every function works along the LAST axis (the n workers); any leading
axes are lanes and broadcast.  ``crash``/``recover`` are (..., n, M).  A
completion rank (``k``, ``r``) is an int or an integer array over the
lanes.

``job_resolution`` is the any-k completion rule under task loss: a job
completes at the k-th surviving finish, or FAILS at the (n-k+1)-th
terminal task loss — whichever bound becomes reachable first (exactly
one of the two instants is finite).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.policy import RetryPolicy

__all__ = ["as_failure_arrays", "effective_finish", "group_resolution",
           "job_resolution", "resolve_retry", "torch_namespace"]


class torch_namespace:
    """The dozen numpy calls this module makes, on torch tensors of one
    device (``xp = torch_namespace(device)``)."""

    inf = math.inf
    int32 = torch.int32

    def __init__(self, device):
        self.device = torch.device(device)

    @staticmethod
    def _dtype(dtype):
        return torch.bool if dtype is bool else dtype

    def full(self, shape, fill, dtype):
        return torch.full(tuple(shape), fill, dtype=self._dtype(dtype),
                          device=self.device)

    def zeros(self, shape, dtype):
        return torch.zeros(tuple(shape), dtype=self._dtype(dtype),
                           device=self.device)

    @staticmethod
    def concatenate(xs, axis=0):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def take_along_axis(a, idx, axis):
        return torch.take_along_dim(a, idx, dim=axis)

    @staticmethod
    def sort(a, axis=-1):
        return torch.sort(a, dim=axis).values

    broadcast_to = staticmethod(torch.broadcast_to)
    clip = staticmethod(torch.clamp)
    where = staticmethod(torch.where)
    minimum = staticmethod(torch.minimum)
    maximum = staticmethod(torch.maximum)
    isfinite = staticmethod(torch.isfinite)
    amax = staticmethod(torch.amax)
    amin = staticmethod(torch.amin)


def resolve_retry(retry: Optional[RetryPolicy]) -> RetryPolicy:
    """The relaunch schedule in effect: an explicit policy, or the
    default ``RetryPolicy()`` when failures are modeled but no policy was
    attached (a fleet that crashes but never retries must be asked for —
    ``RetryPolicy(max_attempts=1)`` — not stumbled into)."""
    return RetryPolicy() if retry is None else retry


def _kth(xp, v, idx):
    """``v`` (sorted along its last axis) read at index ``idx`` — an int,
    or an integer array over the leading axes."""
    if isinstance(idx, (int, np.integer)):
        return v[..., idx]
    idx = xp.broadcast_to(idx, v.shape[:-1])
    return xp.take_along_axis(v, idx[..., None], axis=-1)[..., 0]


def _first_after(xp, crash, t):
    """Per-worker index of the first crash instant strictly after ``t``.

    ``crash`` is (..., n, M) ascending per row, ``t`` is (..., n).
    Equivalent to a per-row ``searchsorted(side="right")`` but written as
    a masked sum so it is identical (and cheap, M is small) under every
    namespace.
    """
    return (crash <= t[..., None]).sum(-1)


def _advance_up(xp, t, crash, recover):
    """``t`` pushed out of any down interval [crash_m, recover_m) it
    falls in — the "queue pauses until recovery" rule at dispatch."""
    if crash.shape[-1] == 0:
        return t
    m = _first_after(xp, crash, t) - 1          # last crash <= t
    mc = xp.clip(m, 0, crash.shape[-1] - 1)
    r_m = xp.take_along_axis(recover, mc[..., None], axis=-1)[..., 0]
    down = (m >= 0) & (t < r_m)
    return xp.where(down, r_m, t)


def effective_finish(xp, start, svc, crash, recover, retry: RetryPolicy,
                     jitter_u=None):
    """(release, ok, attempts) of one task row under the failure schedule.

    ``start`` (..., n) is the dispatch instant (``max(arrival, F_w)`` —
    may fall inside downtime), ``svc`` (..., n) the nominal service
    times, ``crash``/``recover`` (..., n, M) the per-worker schedule (M
    may be 0: no crashes, e.g. a timeout-only policy).  ``jitter_u`` is
    the (..., n, max_attempts-1) table of uniform backoff-jitter draws
    (None → the deterministic midpoint schedule).

    Returns the worker-release instant ``release`` (the completion
    instant when ``ok``, else the recovery/timeout instant of the final
    failed attempt), the completion mask ``ok``, and the number of
    attempts spent.  The attempt loop is unrolled ``max_attempts`` times.
    """
    pad = xp.full(crash.shape[:-1] + (1,), xp.inf, crash.dtype)
    cpad = xp.concatenate([crash, pad], axis=-1)
    rpad = xp.concatenate([recover, pad], axis=-1)
    timeout = retry.timeout if retry.kills_on_timeout else None

    t = _advance_up(xp, start, crash, recover)
    finish = xp.full(t.shape, xp.inf, svc.dtype)
    ok = xp.zeros(t.shape, bool)
    release = t
    attempts = xp.zeros(t.shape, xp.int32)
    for a in range(retry.max_attempts):
        idx = _first_after(xp, crash, t)[..., None]
        c = xp.take_along_axis(cpad, idx, axis=-1)[..., 0]
        done = t + svc <= (c if timeout is None else
                           xp.minimum(c, t + timeout))
        live = ~ok
        attempts = attempts + live
        finish = xp.where(live & done, t + svc, finish)
        ok = ok | done
        # the failed attempt dies at min(crash, timeout); after a crash
        # the worker is unavailable until recovery, after a timeout kill
        # it stays up
        r = xp.take_along_axis(rpad, idx, axis=-1)[..., 0]
        if timeout is None:
            fail_at, resume = c, r
        else:
            to = t + timeout
            fail_at = xp.minimum(c, to)
            resume = xp.where(c <= to, r, to)
        release = xp.where(ok, release, resume)
        if a < retry.max_attempts - 1:
            u = 0.5 if jitter_u is None else jitter_u[..., a]
            relaunch = xp.maximum(resume, fail_at + retry.delay(a, u))
            t = xp.where(ok, t, _advance_up(xp, relaunch, crash, recover))
    release = xp.where(ok, finish, release)
    # a fully idle schedule cell (M == 0, no timeout) can never fail:
    # release is then finite by construction; keep inf out of the carry
    return xp.where(xp.isfinite(release), release, xp.inf), ok, attempts


def job_resolution(xp, nat, ok, k, n):
    """(D, success): when and how a job resolves under task loss.

    ``nat`` (..., n) are the per-task release instants, ``ok`` their
    completion masks.  The job completes at the k-th smallest completed
    release, or fails at the (n-k+1)-th smallest terminal-loss release —
    at most one of the two order statistics exists (>=k completions
    leave <=n-k losses and vice versa), so the finite one is the
    resolution instant.
    """
    natq = xp.where(ok, nat, xp.inf)
    failq = xp.where(ok, xp.inf, nat)
    d_ok = _kth(xp, xp.sort(natq, axis=-1), k - 1)
    d_fail = _kth(xp, xp.sort(failq, axis=-1), n - k)
    success = d_ok <= d_fail
    return xp.where(success, d_ok, d_fail), success


def group_resolution(xp, nat, ok, maskg, r):
    """Group-aware job resolution: per-group any-r, max over groups.

    ``maskg`` (..., G, n) is the worker->group membership mask (padded
    rows may be all-False), ``r`` the within-group completion rank k/g.
    Group i completes at its r-th smallest surviving release ``d_ok_i``,
    or FAILS at its (c_i - r + 1)-th smallest terminal loss ``d_fail_i``
    (c_i group size) — per group exactly :func:`job_resolution` with
    (k, n) -> (r, c_i).  The JOB then succeeds iff every group succeeds,
    completing at the max of the group instants; it fails the instant
    the FIRST group exhausts its replicas.

    Returns ``(Dg, group_ok, D, success)``: per-group resolution
    instants (+inf on padded empty rows), per-group success, the job
    resolution instant, and job success.  With one all-True group row
    and r = k this reduces bit-for-bit to :func:`job_resolution`.
    """
    n = maskg.shape[-1]
    gsize = maskg.sum(-1)
    okg = ok[..., None, :]
    natg = nat[..., None, :]
    natq = xp.where(maskg & okg, natg, xp.inf)
    failq = xp.where(maskg & ~okg, natg, xp.inf)
    rg = r if isinstance(r, (int, np.integer)) else r[..., None]
    d_ok = _kth(xp, xp.sort(natq, axis=-1), rg - 1)
    # loss rank c - r + 1 -> sorted index c - r, clipped at 0 so padded
    # (c = 0) rows read a junk-but-unused +inf entry
    fidx = xp.clip(gsize - rg, 0, n - 1)
    d_fail = _kth(xp, xp.sort(failq, axis=-1), fidx)
    nonempty = gsize > 0
    group_ok = ~nonempty | (d_ok <= d_fail)
    Dg = xp.where(group_ok, d_ok, d_fail)
    success = group_ok.all(-1)
    d_done = xp.amax(xp.where(nonempty, Dg, -xp.inf), -1)
    failg = xp.where(group_ok, xp.inf, Dg)
    return Dg, group_ok, xp.where(success, d_done, xp.amin(failg, -1)), \
        success


def as_failure_arrays(crash_times: np.ndarray, recovery_times: np.ndarray,
                      n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Validate an injected deterministic schedule: (n, M) each, rows
    ascending, recovery no earlier than its crash, consecutive up
    intervals non-overlapping.  The exact-parity tests inject these
    directly instead of sampling a ``FailureModel``."""
    c = np.asarray(crash_times, dtype=np.float64)
    r = np.asarray(recovery_times, dtype=np.float64)
    if c.ndim != 2 or c.shape[0] != n or r.shape != c.shape:
        raise ValueError(
            f"crash/recovery schedules must both be (n={n}, M), got "
            f"{c.shape} and {r.shape}")
    if np.any(r < c):
        raise ValueError("each recovery must be >= its crash instant")
    if c.shape[1] > 1 and np.any(c[:, 1:] < r[:, :-1]):
        raise ValueError(
            "crash intervals must be disjoint and ascending per worker")
    return c, r
