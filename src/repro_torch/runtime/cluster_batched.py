"""Batched cluster engine: a whole (replications x loads x k) grid of
queueing simulations in ONE loop over jobs — the production backend the
discrete-event oracle (``runtime.cluster_oracle``) validates.

Why this is exact, not an approximation: in this system every arriving
job enqueues one task on EVERY worker and each worker is an exclusive
FCFS server, so all workers process jobs in arrival order.  Conditioned
on the task-time matrix S (num_jobs, n) and the arrival instants A, the
entire discrete-event dynamics collapse to a per-job recurrence over the
worker free-times F:

    start_w = max(A_j, F_w)                  (FCFS: job j waits for j-1)
    nat_w   = start_w + S_{j,w}              (natural finish)
    D_j     = k-th smallest nat_w            (any-k completion; cancelled
                                              tasks are all LATER, so they
                                              cannot move the k-th)
    rank_w < k        -> completed:  F_w = nat_w            (busy)
    start_w >= D_j    -> purged:     F_w unchanged          (free)
    otherwise         -> in service at D_j:
        preempt:    F_w = D_j + cancel_overhead   (busy+wasted, incl. the
                                                   purge window)
        no preempt: F_w = nat_w                   (remnant runs out;
                                                   busy+wasted)

Ties at D are broken by stable sort order (worker index), matching the
oracle's event order for the common idle-arrival case.

How it maps onto the card: the worker free-times of every lane are one
(reps, loads, ks, n) tensor F, and the recurrence is ONE Python loop over
jobs in which each operation broadcasts over all lanes — job j's task
times enter as a (reps, 1, ks, n) slice, its arrivals as (reps, loads,
1, 1).  The loop only enqueues work: nothing in it reads a value back to
the host, so the card runs ahead of the Python loop and the host sets
the pace by the number of operations a step launches.  Absolute times
are float32, as in the JAX package (whose float32 clock drift under tiny
loads the port therefore shares).

Common random numbers, as in ``core.simulator``: k lanes share one base
noise draw (one ``sample_noise`` / additive-cumsum table transformed per
task size s = n/k), load lanes share one arrival draw with only the rate
swept, and replication lanes are a leading axis of every draw — all from
one ``torch.Generator`` seeded ``seed``, in the order service, arrivals,
failure schedule, backoff jitter.

``simulate_one`` is the single-cell path: it draws from the SAME
substrate as the oracle (``core.scenario.sample_task_matrix`` + the
legacy arrival stream), so for a given config both backends walk the
same sample path up to float32 accumulation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, generator, resolve
from ..assign.strategies import (Assignment, GroupLanes, build_lanes,
                                 group_ids_matrix, is_all_workers)
from ..core.distributions import Scaling
from ..core.policy import RetryPolicy
from ..core.scenario import FailureModel, PoissonArrivals, Scenario
from ..obs import recorder as _trace
from .cluster import ClusterConfig, ClusterResult, default_warmup
from .failures import (effective_finish, group_resolution, job_resolution,
                       resolve_retry, torch_namespace)

__all__ = ["ClusterSweep", "Infeasible", "InfeasibleSurfaceError",
           "resolve_failure_args", "simulate_one", "summarize_sweep",
           "sweep", "sweep_compile_count", "validate_sweep_args"]

_SWEEP_CALLS = 0


def sweep_compile_count() -> int:
    """How many surfaces the sweep core has run.

    The JAX package counts jit compilations here (one per surface shape);
    the port compiles nothing, so the count ticks once per ``_sweep_core``
    call — the way ``core.simulator.curve_compile_count`` counts curve
    evaluations.
    """
    return _SWEEP_CALLS


# --------------------------------------------------------------------------
# The lane steps: one job of every (rep, load, k) lane at once
# --------------------------------------------------------------------------
#
# Shapes inside a step: F, start, nat (R, L, K, n); the job's arrivals a
# (R, L, 1, 1); its task times srow (R, 1, K, n); per-lane ranks carry a
# trailing axis of 1.  A step returns the new carry and the job's
# (R, L, K) latencies (plus its success mask on the failure lanes).

def _kth_sort(nat, kidx):
    """k-th smallest per lane: a stable sort along the workers, read at
    ``kidx`` = k - 1 (int64, the lanes' shape with a trailing 1).
    ``torch.kthvalue`` takes one k for all lanes; this takes one per
    lane."""
    return torch.sort(nat, dim=-1, stable=True).values.gather(-1, kidx)


def _first_k(lt, eq, take_eq):
    """The completed set: every strictly-earlier finisher, plus the first
    ``take_eq`` of the ties in worker-index order (the oracle's event
    order for simultaneous finishes).  Bool cumsum is int64 in torch, so
    ``take_eq`` is int64."""
    return lt | (eq & (torch.cumsum(eq, dim=-1) * eq <= take_eq))


def make_plain_step(kidx, cancel_overhead: float, preempt: bool):
    """The per-job step of the fault-free ungrouped lane.  ``kidx`` is
    the (R, L, K, 1) int64 tensor of k - 1."""
    k = kidx + 1

    def step(carry, inp):
        F, busy, wasted = carry
        a, srow = inp
        start = torch.maximum(a, F)
        nat = start + srow
        D = _kth_sort(nat, kidx)
        lt = nat < D
        eq = nat == D
        completed = _first_k(lt, eq, k - lt.sum(-1, keepdim=True))
        inservice = (~completed) & (start < D)
        if preempt:
            cut = D - start + cancel_overhead
            run = torch.where(completed, srow,
                              torch.where(inservice, cut, 0.0))
            waste = torch.where(inservice, cut, 0.0)
            F_next = torch.where(completed, nat,
                                 torch.where(inservice,
                                             D + cancel_overhead, F))
        else:
            run = torch.where(completed | inservice, srow, 0.0)
            waste = torch.where(inservice, srow, 0.0)
            F_next = torch.where(completed | inservice, nat, F)
        return (F_next, busy + run.sum(-1), wasted + waste.sum(-1)), \
            (D - a)[..., 0]

    return step


def make_failure_step(k, n: int, cancel_overhead: float, preempt: bool,
                      crash, recover, retry: RetryPolicy, xp):
    """Per-job step of the failure-mode ungrouped lane.

    Each task's natural finish becomes its ``effective_finish`` under the
    crash schedule — downtime-inflated service plus a bounded relaunch
    pass.  The job resolves at the k-th surviving completion or, when
    more than n-k tasks exhaust their retry budgets, FAILS at the
    (n-k+1)-th terminal loss (``failures.job_resolution``).  Tasks that
    resolved at or before D release their worker at their release
    instant; tasks still in flight at D are cut like the fault-free
    engine's in-service remnants (preempt: D + overhead; no preempt:
    they run out their FULL effective finish, retries included).
    Accounting is occupancy-based: a worker counts busy from dispatch to
    release, downtime and backoff waits included.

    ``k`` is the (R, L, K) int64 rank tensor; ``crash``/``recover`` are
    (R, 1, 1, n, M), one schedule per replication shared by its lanes.
    """
    def step(carry, inp):
        F, busy, wasted = carry
        a, srow, urow = inp
        start = torch.maximum(a, F)
        nat, ok, _ = effective_finish(xp, start, srow, crash, recover,
                                      retry, urow)
        D, success = job_resolution(xp, nat, ok, k, n)
        Dc = D[..., None]
        natq = torch.where(ok, nat, torch.inf)
        lt = natq < Dc
        eq = natq == Dc
        # success: first k survivors, ties at D by worker index (the
        # fault-free rule); failure: every survivor that finished by D
        take_eq = torch.where(success, k - lt.sum(-1), eq.sum(-1))
        completed = _first_k(lt, eq, take_eq[..., None])
        resolved_fail = (~ok) & (nat <= Dc)
        engaged = (~completed) & (~resolved_fail) & (start < Dc)
        occ = nat - start
        if preempt:
            cut = Dc - start + cancel_overhead
            run = torch.where(completed | resolved_fail, occ,
                              torch.where(engaged, cut, 0.0))
            waste = torch.where(resolved_fail, occ,
                                torch.where(engaged, cut, 0.0))
            F_next = torch.where(completed | resolved_fail, nat,
                                 torch.where(engaged,
                                             Dc + cancel_overhead, F))
        else:
            started = completed | resolved_fail | engaged
            run = torch.where(started, occ, 0.0)
            waste = torch.where(resolved_fail | engaged, occ, 0.0)
            F_next = torch.where(started, nat, F)
        return (F_next, busy + run.sum(-1), wasted + waste.sum(-1)), \
            (D - a[..., 0], success)

    return step


def _group_masks(grow, garange):
    """(…, G, n) worker->group membership from the (…, n) group ids."""
    return grow[..., None, :] == garange[:, None]


def make_grouped_step(cancel_overhead: float, preempt: bool, r, ridx,
                      groups: int, device):
    """Per-job step of the fault-free grouped lane (per-group any-r).

    ``grow`` (K, n), the job's worker->group ids, rides the step
    inputs.  Group i resolves at its r-th smallest finish D_i and cancels
    its OWN remnants at D_i; the job completes at D = max_i D_i.  ``r`` is
    the (K, 1) int64 within-group rank k/g and ``ridx`` the
    (R, L, K, G, 1) int64 tensor of r - 1.

    The r-th smallest per group is a sort of the group-masked finishes
    along the workers, read at r - 1.  The JAX package counts
    comparisons instead (a (G, n, n) intermediate per lane, chosen
    because XLA's CPU sort is slow); on the card that intermediate would
    be (R·L·K, G, n, n), ~83 M elements a step at n = 120, G = 60 and 96
    lanes, where the sort's is (R·L·K, G, n).  Same value, ties
    included: the r-th element of the sorted row is the least v with
    #(<= v) >= r, so g = 1 stays bit-equal to the ungrouped lane, and
    padded empty rows (all +inf) read +inf.
    """
    garange = torch.arange(groups, device=device)

    def step(carry, inp):
        F, busy, wasted = carry
        a, srow, grow = inp
        start = torch.maximum(a, F)
        nat = start + srow
        maskg = _group_masks(grow, garange)                # (1,1,K,G,n)
        natm = torch.where(maskg, nat[..., None, :], torch.inf)
        Dg = _kth_sort(natm, ridx)[..., 0]                 # (R,L,K,G)
        D = torch.where(maskg.any(-1), Dg, -torch.inf).amax(-1)
        Dw = Dg.gather(-1, grow.expand(F.shape))           # per-worker cutoff
        # per group: first r finishers, ties at D_i by worker index
        # (membership-masked: a padded empty group has D_i = +inf, and
        # inf == inf must not mark anybody)
        ltg = maskg & (natm < Dg[..., None])
        eqg = maskg & (natm == Dg[..., None])
        compg = _first_k(ltg, eqg, r[..., None] - ltg.sum(-1, keepdim=True))
        completed = compg.any(-2)
        inservice = (~completed) & (start < Dw)
        if preempt:
            cut = Dw - start + cancel_overhead
            run = torch.where(completed, srow,
                              torch.where(inservice, cut, 0.0))
            waste = torch.where(inservice, cut, 0.0)
            F_next = torch.where(completed, nat,
                                 torch.where(inservice,
                                             Dw + cancel_overhead, F))
        else:
            run = torch.where(completed | inservice, srow, 0.0)
            waste = torch.where(inservice, srow, 0.0)
            F_next = torch.where(completed | inservice, nat, F)
        return (F_next, busy + run.sum(-1), wasted + waste.sum(-1)), \
            D - a[..., 0]

    return step


def make_grouped_failure_step(cancel_overhead: float, preempt: bool, crash,
                              recover, retry: RetryPolicy, r, groups: int,
                              xp):
    """Per-job step of the failure-mode grouped lane.

    The clairvoyant recurrence of ``make_failure_step`` with
    ``failures.group_resolution`` in place of ``job_resolution``: group i
    completes at its r-th surviving finish or fails at its (c-r+1)-th
    terminal loss, the job succeeds iff every group does (completing at
    max_i D_i) and FAILS the instant the first group exhausts its
    replicas.  Per-worker cutoffs are C_w = min(D_{g(w)}, D): a group
    cancels its own remnants at its own resolution, and a job failure
    cuts every still-unresolved group at the failure instant.  The
    first-r tie cap applies only to groups that resolved successfully at
    or before D; survivors in any other group complete whenever they
    finish by the cutoff.  ``r`` is the (K,) int64 rank tensor.
    """
    garange = torch.arange(groups, device=xp.device)
    rg = r[..., None]

    def step(carry, inp):
        F, busy, wasted = carry
        a, srow, grow, urow = inp
        start = torch.maximum(a, F)
        nat, ok, _ = effective_finish(xp, start, srow, crash, recover,
                                      retry, urow)
        maskg = _group_masks(grow, garange)
        Dg, gok, D, success = group_resolution(xp, nat, ok, maskg, r)
        Cg = torch.minimum(Dg, D[..., None])
        Cw = Cg.gather(-1, grow.expand(F.shape))
        natqm = torch.where(maskg & ok[..., None, :], nat[..., None, :],
                            torch.inf)
        ltg = natqm < Cg[..., None]
        eqg = natqm == Cg[..., None]
        res_ok = gok & (Dg <= D[..., None])
        take_eq = torch.where(res_ok, rg - ltg.sum(-1), eqg.sum(-1))
        completed = _first_k(ltg, eqg, take_eq[..., None]).any(-2)
        resolved_fail = (~ok) & (nat <= Cw)
        engaged = (~completed) & (~resolved_fail) & (start < Cw)
        occ = nat - start
        if preempt:
            cut = Cw - start + cancel_overhead
            run = torch.where(completed | resolved_fail, occ,
                              torch.where(engaged, cut, 0.0))
            waste = torch.where(resolved_fail, occ,
                                torch.where(engaged, cut, 0.0))
            F_next = torch.where(completed | resolved_fail, nat,
                                 torch.where(engaged,
                                             Cw + cancel_overhead, F))
        else:
            started = completed | resolved_fail | engaged
            run = torch.where(started, occ, 0.0)
            waste = torch.where(resolved_fail | engaged, occ, 0.0)
            F_next = torch.where(started, nat, F)
        return (F_next, busy + run.sum(-1), wasted + waste.sum(-1)), \
            (D - a[..., 0], success)

    return step


# --------------------------------------------------------------------------
# The lane grid: one loop over jobs, every lane in each operation
# --------------------------------------------------------------------------

def _run_lanes(A, S, ks, cancel_overhead: float, preempt: bool,
               crash=None, recover=None, jitter_u=None,
               retry: Optional[RetryPolicy] = None, groups=None,
               group_r=None, group_ids=None):
    """The exact FCFS/any-k/cancel dynamics of every lane.

    A (R, L, J) arrivals and S (R, K, J, n) task times, float32 on one
    device; ``ks`` the K lane ranks.  ``retry`` (not None) selects the
    failure recurrence over the (R, n, M) ``crash``/``recover`` schedule
    and the optional (R, J, n, max_attempts-1) ``jitter_u``.  ``groups``
    (not None) selects the grouped recurrence: ``group_r`` (K,) int64
    within-group ranks, ``group_ids`` (K, J, n) int64 worker->group ids.

    Returns (latencies (R, L, K, J), busy (R, L, K), wasted (R, L, K),
    success (R, L, K, J) or None).
    """
    R, L, J = A.shape
    K, n = S.shape[1], S.shape[3]
    dev = S.device
    lanes = (R, L, K)
    a_steps = A.permute(2, 0, 1).contiguous()[..., None, None]  # (J,R,L,1,1)
    s_steps = S.permute(2, 0, 1, 3).contiguous()[:, :, None]   # (J,R,1,K,n)
    k_lane = torch.as_tensor(ks, dtype=torch.int64, device=dev)
    xp = torch_namespace(dev)
    faulty = retry is not None
    if faulty:
        crash = crash[:, None, None]                          # (R,1,1,n,M)
        recover = recover[:, None, None]
        u_steps = None if jitter_u is None else \
            jitter_u.permute(1, 0, 2, 3).contiguous()[:, :, None, None]
    if groups is not None:
        g_steps = group_ids.permute(1, 0, 2).contiguous()     # (J,K,n)
        r_lane = group_r.to(device=dev, dtype=torch.int64)
    if groups is None and not faulty:
        kidx = (k_lane - 1)[:, None].expand(lanes + (1,))
        step = make_plain_step(kidx, cancel_overhead, preempt)
        inputs = lambda j: (a_steps[j], s_steps[j])          # noqa: E731
    elif groups is None:
        step = make_failure_step(k_lane.expand(lanes), n, cancel_overhead,
                                 preempt, crash, recover, retry, xp)
        inputs = lambda j: (a_steps[j], s_steps[j],          # noqa: E731
                            None if u_steps is None else u_steps[j])
    elif not faulty:
        ridx = (r_lane - 1)[:, None, None].expand(lanes + (groups, 1))
        step = make_grouped_step(cancel_overhead, preempt,
                                 r_lane[:, None], ridx, groups, dev)
        inputs = lambda j: (a_steps[j], s_steps[j], g_steps[j])  # noqa: E731
    else:
        step = make_grouped_failure_step(cancel_overhead, preempt, crash,
                                         recover, retry, r_lane, groups, xp)
        inputs = lambda j: (a_steps[j], s_steps[j], g_steps[j],  # noqa: E731
                            None if u_steps is None else u_steps[j])

    zero = torch.zeros(lanes, dtype=S.dtype, device=dev)
    carry = (torch.zeros(lanes + (n,), dtype=S.dtype, device=dev), zero,
             zero)
    lat = torch.empty((J,) + lanes, dtype=S.dtype, device=dev)
    okj = torch.empty((J,) + lanes, dtype=torch.bool, device=dev) \
        if faulty else None
    for j in range(J):
        carry, out = step(carry, inputs(j))
        if faulty:
            lat[j], okj[j] = out
        else:
            lat[j] = out
    _, busy, wasted = carry
    return (lat.permute(1, 2, 3, 0), busy, wasted,
            None if okj is None else okj.permute(1, 2, 3, 0))


# --------------------------------------------------------------------------
# One lane: A (num_jobs,) arrivals and S (num_jobs, n) task times
# --------------------------------------------------------------------------

def _one(out, faulty: bool):
    lat, busy, wasted, okj = (None if x is None else x[0, 0, 0]
                              for x in out)
    return (lat, okj, busy, wasted) if faulty else (lat, busy, wasted)


def _scan_lane(A, S, k: int, cancel_overhead: float, preempt: bool):
    """Exact FCFS/any-k/cancel dynamics for one lane.  Returns
    (latencies (num_jobs,), busy, wasted)."""
    return _one(_run_lanes(A[None, None], S[None, None], [k],
                           cancel_overhead, preempt), False)


def _scan_lane_failures(A, S, k: int, cancel_overhead: float, preempt: bool,
                        crash, recover, jitter_u, retry: RetryPolicy):
    """The failure-mode lane over the (n, M) ``crash``/``recover``
    schedule and the optional (num_jobs, n, max_attempts-1) jitter
    draws.  Returns (latencies, success mask, busy, wasted)."""
    return _one(_run_lanes(
        A[None, None], S[None, None], [k], cancel_overhead, preempt,
        crash=crash[None], recover=recover[None],
        jitter_u=None if jitter_u is None else jitter_u[None],
        retry=retry), True)


def _scan_lane_grouped(A, S, k: int, cancel_overhead: float, preempt: bool,
                       r: int, gid, groups: int):
    """The fault-free lane under a grouped assignment: ``gid``
    (num_jobs, n) maps worker -> replication group per job and ``r`` is
    the within-group completion rank k/g.  Returns (latencies, busy,
    wasted)."""
    return _one(_run_lanes(
        A[None, None], S[None, None], [k], cancel_overhead, preempt,
        groups=groups, group_r=torch.tensor([r]), group_ids=gid[None]),
        False)


def _scan_lane_grouped_failures(A, S, k: int, cancel_overhead: float,
                                preempt: bool, crash, recover, jitter_u,
                                retry: RetryPolicy, r: int, gid,
                                groups: int):
    """The failure lane under a grouped assignment.  Returns (latencies,
    success mask, busy, wasted)."""
    return _one(_run_lanes(
        A[None, None], S[None, None], [k], cancel_overhead, preempt,
        crash=crash[None], recover=recover[None],
        jitter_u=None if jitter_u is None else jitter_u[None], retry=retry,
        groups=groups, group_r=torch.tensor([r]), group_ids=gid[None]),
        True)


def simulate_one(cfg: ClusterConfig, dist, scaling: Scaling,
                 delta: Optional[float] = None,
                 service_times: Optional[np.ndarray] = None,
                 arrival_times: Optional[np.ndarray] = None,
                 crash_times: Optional[np.ndarray] = None,
                 recovery_times: Optional[np.ndarray] = None,
                 device=DEFAULT_DEVICE) -> ClusterResult:
    """One cell on the batched engine, sample-path-matched to the oracle.

    Inputs are drawn by the oracle's own ``_draw_inputs`` (shared
    substrate, same generator seeds), so this is the same trajectory the
    discrete-event loop walks — the single-cell parity anchor.  Failure
    cells (a ``cfg.failures`` model, an injected ``crash_times``/
    ``recovery_times`` schedule, or a killing ``cfg.retry`` timeout)
    route through the failure lane and share the oracle's
    ``_draw_failures`` substrate the same way.  The lane runs on
    ``device`` in float32.
    """
    from .cluster_oracle import _draw_failures, _draw_inputs
    dev = resolve(device)
    svc, arrivals = _draw_inputs(cfg, dist, scaling, delta,
                                 service_times, arrival_times, dev)
    fail = _draw_failures(cfg, crash_times, recovery_times, dev)

    def f32(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float64), device=dev).to(torch.float32)

    lane = (f32(arrivals), f32(svc), cfg.k, float(cfg.cancel_overhead),
            bool(cfg.preempt))
    grouped = ()
    if not is_all_workers(getattr(cfg, "assignment", None)):
        g, r, gid = group_ids_matrix(cfg.assignment, cfg.n_workers, cfg.k,
                                     cfg.num_jobs, cfg.worker_speeds)
        grouped = (r, torch.as_tensor(gid, device=dev).to(torch.int64), g)
    okj = None
    if fail is None:
        run = _scan_lane_grouped if grouped else _scan_lane
        lat, busy, wasted = run(*lane, *grouped)
    else:
        crash, recover, jitter_u, retry = fail
        run = _scan_lane_grouped_failures if grouped else \
            _scan_lane_failures
        lat, okj, busy, wasted = run(*lane, f32(crash), f32(recover),
                                     f32(jitter_u), retry, *grouped)
        okj = okj.cpu().numpy()
    lat = lat.cpu().numpy().astype(np.float64)
    busy = float(busy)
    horizon = float(np.max(arrivals + lat))
    completions = lat.size if okj is None else int(okj.sum())
    return ClusterResult(
        latencies=lat,
        utilization=busy / (cfg.n_workers * horizon),
        wasted_frac=float(wasted) / max(busy, 1e-12),
        throughput=completions / horizon,
        warmup=cfg.warmup,
        job_failed=None if okj is None else ~okj,
    )


# --------------------------------------------------------------------------
# The surface: (replications x loads x k) lanes, one engine call
# --------------------------------------------------------------------------

def _sweep_core(gen: torch.Generator, loads, speeds, cancel_overhead: float,
                dist, scaling, n: int, ks, num_jobs: int, reps: int,
                preempt: bool, arrivals, delta, failures=None, retry=None,
                groups=None, group_r=None, group_ids=None):
    """The (reps x loads x ks) lane grid on ``gen``'s device.

    ``loads`` (L,) and ``speeds`` (n,) are float32 arrays.  With a
    ``failures`` model (and resolved ``retry`` policy) the lanes run the
    failure recurrence: ONE crash-restart schedule per replication,
    shared across the k and load lanes — machines crash identically
    whatever policy serves them, the CRN discipline that pairs the
    failure surface.  Returns an extra (reps, L, K, num_jobs) success
    mask and per-lane horizon.

    A grouped assignment arrives as (``groups`` max group count,
    ``group_r`` (K,) within-group ranks, ``group_ids`` (K, num_jobs, n)
    worker->group masks).  Task size s = n/k is independent of the
    grouping, so the CRN service tables are shared unchanged across
    assignment lanes: placement comparisons are exactly paired.
    """
    global _SWEEP_CALLS
    _SWEEP_CALLS += 1
    dev = gen.device
    s_of_k = [n // k for k in ks]
    # -- service: one CRN base draw transformed per k lane -----------------
    if scaling is Scaling.ADDITIVE:
        draws = dist.sample(gen, (reps, num_jobs, n, max(s_of_k)))
        csum = torch.cumsum(draws, dim=-1)
        S_all = torch.stack([csum[..., s - 1] for s in s_of_k], dim=1)
        del draws, csum
    else:
        d = dist.shift if delta is None else delta
        z = dist.sample_noise(gen, (reps, num_jobs, n))[:, None]
        s_col = torch.as_tensor(s_of_k, dtype=z.dtype,
                                device=dev)[:, None, None]
        S_all = (d + s_col * z) if scaling is Scaling.SERVER_DEPENDENT \
            else (s_col * d + z)                          # (R, K, jobs, n)
    S_all = S_all * torch.as_tensor(speeds, device=dev)
    # -- arrivals: one draw across load lanes, only the rate sweeps -------
    rates = torch.as_tensor(loads, dtype=torch.float32, device=dev)[:, None]
    A_all = arrivals.times(gen, num_jobs, rates, batch=(reps, 1))
    A_all = A_all.expand(reps, len(loads), num_jobs)
    kwargs = {}
    if groups is not None:
        kwargs = dict(groups=groups,
                      group_r=torch.as_tensor(group_r, device=dev),
                      group_ids=torch.as_tensor(group_ids, device=dev
                                                ).to(torch.int64))
    if retry is None:
        lat, busy, wasted, _ = _run_lanes(A_all, S_all, ks, cancel_overhead,
                                          preempt, **kwargs)
        return lat, busy, wasted, A_all[..., -1]

    # -- failures: one fleet schedule per rep, shared across lanes --------
    if failures is None:                    # timeout-only retry policy
        crash = torch.zeros((reps, n, 0), dtype=torch.float32, device=dev)
        recover = crash
    else:
        crash, recover = failures.schedule(gen, n, batch=(reps,))
    jitter_u = None
    if retry.max_attempts > 1 and retry.jitter > 0:
        jitter_u = torch.rand((reps, num_jobs, n, retry.max_attempts - 1),
                              generator=gen, device=dev)
    lat, busy, wasted, okj = _run_lanes(
        A_all, S_all, ks, cancel_overhead, preempt, crash=crash,
        recover=recover, jitter_u=jitter_u, retry=retry, **kwargs)
    # failure resolutions need not be monotone in j, so the horizon is
    # the max resolution instant, not the last job's
    horizon = (A_all[:, :, None, :] + lat).amax(-1)
    return lat, busy, wasted, A_all[..., -1], okj, horizon


@dataclasses.dataclass(frozen=True)
class Infeasible:
    """Typed marker for a surface row with NO feasible candidate.

    Failure lanes report an all-failed cell as ``np.inf``; a row where
    EVERY candidate carries the sentinel has no optimum, and a silent
    ``argmin`` would return the first candidate as if it had won.
    ``kstar``-style selections return this marker instead so callers can
    branch on it (``isinstance(v, Infeasible)``); planner entry points
    that must produce a single policy raise ``InfeasibleSurfaceError``.
    """

    load: float
    metric: str

    def __bool__(self) -> bool:
        return False


class InfeasibleSurfaceError(RuntimeError):
    """Raised when a planning curve has no finite cell to select from
    (every candidate hit the all-failed ``np.inf`` sentinel)."""


@dataclasses.dataclass
class ClusterSweep:
    """The (loads x ks) result surface, replication-averaged.

    Latency stats pool replications and post-warmup jobs; utilization,
    wasted-work fraction, and throughput are per-lane then averaged over
    replications.  All arrays are (len(loads), len(ks)).
    """

    loads: Tuple[float, ...]
    ks: Tuple[int, ...]
    warmup: int
    reps: int
    mean: np.ndarray
    p50: np.ndarray
    p95: np.ndarray
    p99: np.ndarray
    utilization: np.ndarray
    wasted_frac: np.ndarray
    throughput: np.ndarray
    #: post-warmup fraction of FAILED jobs per cell; None on a fault-free
    #: sweep (kept out of ``_METRICS`` so fault-free summaries are
    #: unchanged; latency stats always pool COMPLETED jobs only)
    failure_rate: Optional[np.ndarray] = None

    _METRICS = ("mean", "p50", "p95", "p99", "utilization", "wasted_frac",
                "throughput")

    def metric(self, name: str) -> np.ndarray:
        if name == "failure_rate":
            if self.failure_rate is None:
                raise ValueError(
                    "failure_rate is only available on a sweep with a "
                    "failure model (Scenario.failures)")
            return self.failure_rate
        if name not in self._METRICS:
            raise ValueError(f"unknown metric {name!r} "
                             f"(one of {self._METRICS + ('failure_rate',)})")
        return getattr(self, name)

    def summary(self, load_idx: int, k_idx: int) -> dict:
        """One cell in ``ClusterResult.summary()``'s dialect."""
        return {m: float(self.metric(m)[load_idx, k_idx])
                for m in self._METRICS}

    def curve(self, load_idx: int = 0, metric: str = "mean"
              ) -> Dict[int, float]:
        """k -> metric at one load (the planner's objective row)."""
        vals = self.metric(metric)[load_idx]
        return {int(k): float(v) for k, v in zip(self.ks, vals)}

    def kstar(self, metric: str = "mean") -> Dict[float, object]:
        """load -> arg-min k (ties to the smaller k; ks are ascending).

        A row where no candidate is finite (every cell carries the
        all-failed ``np.inf`` sentinel) maps to an ``Infeasible`` marker
        instead of a meaningless first-k argmin.
        """
        vals = self.metric(metric)
        out: Dict[float, object] = {}
        for i, lam in enumerate(self.loads):
            if not np.any(np.isfinite(vals[i])):
                out[float(lam)] = Infeasible(load=float(lam), metric=metric)
            else:
                out[float(lam)] = int(self.ks[int(np.argmin(vals[i]))])
        return out


def resolve_failure_args(scenario: Scenario,
                         retry: Optional[RetryPolicy]
                         ) -> Tuple[Optional[FailureModel],
                                    Optional[RetryPolicy]]:
    """Whether a sweep runs the failure lanes, and under what relaunch
    schedule.  (None, None) means fault-free (the historical fast path);
    otherwise the resolved ``retry`` is never None — a timeout-only
    policy (``retry.kills_on_timeout`` without a ``FailureModel``)
    activates the lanes with an empty crash schedule."""
    if scenario.failures is None and (retry is None
                                      or not retry.kills_on_timeout):
        return None, None
    return scenario.failures, resolve_retry(retry)


def validate_sweep_args(scenario: Scenario, loads, ks, num_jobs, reps,
                        warmup):
    """The shared argument contract of every sweep surface: resolved
    (ks, loads, warmup, arrivals, speeds), speeds a float32 (n,) array."""
    n = scenario.n
    ks = tuple(scenario.legal_ks()) if ks is None \
        else tuple(int(k) for k in ks)
    for k in ks:
        if k < 1 or n % k:
            raise ValueError(f"k={k} must divide n={n}")
    loads = [float(v) for v in loads]
    if not loads or any(v <= 0 for v in loads):
        raise ValueError("loads must be positive arrival rates")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if warmup is None:
        warmup = default_warmup(num_jobs)
    if not (0 <= warmup < num_jobs):
        raise ValueError(f"warmup must be in [0, num_jobs), got {warmup}")
    arrivals = scenario.arrivals if scenario.arrivals is not None \
        else PoissonArrivals(rate=1.0)           # rate overridden per lane
    speeds = np.ones((n,), np.float32) if scenario.worker_speeds is None \
        else np.asarray(scenario.worker_speeds, np.float32)
    return ks, loads, int(warmup), arrivals, speeds


def summarize_sweep(lat, busy, wasted, a_last, loads, ks, warmup, reps,
                    num_jobs, n, ok=None, horizon=None) -> ClusterSweep:
    """Engine outputs (host arrays) -> ``ClusterSweep``; the single
    aggregation every batched surface runs.

    ``ok`` ((reps, L, K, num_jobs) success mask) and ``horizon``
    ((reps, L, K) max resolution instants) arrive from the failure
    lanes: latency statistics then pool COMPLETED post-warmup jobs only
    (a cell where every job failed reports inf), and ``failure_rate``
    is the failed fraction per cell.
    """
    lat = np.asarray(lat, np.float64)            # (reps, L, K, num_jobs)
    busy = np.asarray(busy, np.float64)          # (reps, L, K)
    wasted = np.asarray(wasted, np.float64)
    a_last = np.asarray(a_last, np.float64)      # (reps, L)
    if horizon is None:
        horizon = a_last[:, :, None] + lat[..., -1]  # D_last (monotone in j)
    else:
        horizon = np.asarray(horizon, np.float64)
    steady = lat[..., warmup:]
    L, K = len(loads), len(ks)
    pooled = np.moveaxis(steady, 0, -2).reshape(L, K, -1)
    if ok is None:
        mean = pooled.mean(axis=-1)
        p50 = np.quantile(pooled, 0.50, axis=-1)
        p95 = np.quantile(pooled, 0.95, axis=-1)
        p99 = np.quantile(pooled, 0.99, axis=-1)
        fail_rate = None
        completions = float(num_jobs)
    else:
        ok = np.asarray(ok, bool)
        ok_pooled = np.moveaxis(ok[..., warmup:], 0, -2).reshape(L, K, -1)
        mean = np.full((L, K), np.inf)
        p50, p95, p99 = (np.full((L, K), np.inf) for _ in range(3))
        for i in range(L):
            for j in range(K):
                good = pooled[i, j][ok_pooled[i, j]]
                if good.size:
                    mean[i, j] = good.mean()
                    p50[i, j] = np.quantile(good, 0.50)
                    p95[i, j] = np.quantile(good, 0.95)
                    p99[i, j] = np.quantile(good, 0.99)
        fail_rate = 1.0 - ok_pooled.mean(axis=-1)
        completions = np.asarray(ok, bool).sum(axis=-1)  # (reps, L, K)
    return ClusterSweep(
        loads=tuple(loads), ks=tuple(ks), warmup=int(warmup),
        reps=int(reps),
        mean=mean, p50=p50, p95=p95, p99=p99,
        utilization=(busy / (n * horizon)).mean(axis=0),
        wasted_frac=(wasted / np.maximum(busy, 1e-12)).mean(axis=0),
        throughput=(completions / horizon).mean(axis=0),
        failure_rate=fail_rate,
    )


def _host(out) -> tuple:
    """Engine outputs as host numpy arrays (one device sync)."""
    return tuple(None if x is None else x.cpu().numpy() for x in out)


def sweep(scenario: Scenario, loads: Sequence[float],
          ks: Optional[Sequence[int]] = None, num_jobs: int = 1000,
          reps: int = 1, preempt: bool = True, cancel_overhead: float = 0.0,
          seed: int = 0, warmup: Optional[int] = None,
          retry: Optional[RetryPolicy] = None,
          assignment: Optional[Assignment] = None,
          chunk_size: Optional[int] = None, stream: bool = False,
          reservoir: int = 4096,
          shard: Optional[int] = None,
          device=DEFAULT_DEVICE) -> ClusterSweep:
    """Every (load, k) queueing cell of a scenario in one engine call on
    ``device`` (default ``"cuda"``; pass ``device="cpu"`` to run on the
    host).

    ``loads`` are mean arrival rates; the scenario's ``arrivals`` process
    (default Poisson) supplies the SHAPE and is rescaled per load lane.
    ``warmup=None`` discards min(num_jobs // 10, 200) transient jobs from
    the latency statistics.  Heterogeneous ``scenario.worker_speeds``
    multiply every lane's task times.  Additive scaling materializes a
    (reps, num_jobs, n, s_max) CU table — prefer moderate n there;
    server-/data-dependent scaling needs only (reps, num_jobs, n).

    ``scenario.failures`` switches every lane to the crash-restart
    recurrence (relaunches under ``retry``, default ``RetryPolicy()``);
    the resulting surface carries ``failure_rate`` and its latency stats
    cover completed jobs only.

    ``assignment`` switches every lane to the grouped per-group-any-r
    recurrence (see ``assign.strategies``); ``None``/``AllWorkers`` run
    the ungrouped path bit-for-bit.

    Any of ``chunk_size`` / ``stream`` / ``shard`` (with ``reservoir``)
    routes the surface through the chunked fleet engine
    (``runtime.fleet.fleet_sweep``): bounded memory at any num_jobs,
    per-chunk clock rebasing, optional streaming statistics; its own
    row-keyed draws, so equal in law to this engine's, not bit for bit.
    """
    if chunk_size is not None or stream or shard is not None:
        from .fleet import fleet_sweep
        return fleet_sweep(scenario, loads, ks=ks, num_jobs=num_jobs,
                           reps=reps, preempt=preempt,
                           cancel_overhead=cancel_overhead, seed=seed,
                           warmup=warmup, retry=retry, assignment=assignment,
                           chunk_size=chunk_size, stream=stream,
                           reservoir=reservoir, shard=shard, device=device)
    dev = resolve(device)
    n = scenario.n
    ks, loads, warmup, arrivals, speeds = validate_sweep_args(
        scenario, loads, ks, num_jobs, reps, warmup)
    failures, retry = resolve_failure_args(scenario, retry)
    lanes = build_lanes(assignment, n, ks, int(num_jobs),
                        scenario.worker_speeds)

    rec = _trace.active()
    t0 = rec.now() if rec is not None else 0.0
    out = _host(_sweep_core(
        generator(seed, dev), np.asarray(loads, np.float32), speeds,
        float(cancel_overhead), scenario.dist, scenario.scaling, n, ks,
        int(num_jobs), int(reps), bool(preempt), arrivals,
        None if scenario.delta is None else float(scenario.delta),
        failures, retry, *_lane_args(lanes)))
    if rec is not None:
        rec.event("sweep", name="batched", dur=rec.now() - t0,
                  n=n, num_jobs=int(num_jobs), reps=int(reps),
                  lanes=len(loads) * len(ks), device=str(dev))

    if retry is None:
        lat, busy, wasted, a_last = out
        ok = horizon = None
    else:
        lat, busy, wasted, a_last, ok, horizon = out
    return summarize_sweep(lat, busy, wasted, a_last, loads, ks, warmup,
                           reps, num_jobs, n, ok=ok, horizon=horizon)


def _lane_args(lanes: Optional[GroupLanes]):
    """GroupLanes -> the engine's (groups, group_r, group_ids) triple."""
    if lanes is None:
        return None, None, None
    return lanes.groups, lanes.r.astype(np.int64), lanes.gid
