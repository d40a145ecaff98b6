"""The reference discrete-event cluster simulator (the ORACLE).

This is the trusted, slow ground truth the batched lane engine
(``runtime.cluster_batched``) is validated against: a single heapq event
loop over arrivals / task finishes / purge-window releases, one
(scenario, load, k) cell per call.  Semantics:

  * n workers, each an exclusive FCFS server (``collections.deque``
    queues — O(1) pops, not the O(queue) ``list.pop(0)`` this started
    with);
  * every arriving job enqueues one task of s = n/k CUs on every worker,
    so each worker serves jobs in arrival order;
  * a job completes when any k tasks finish; its queued tasks are purged
    for free and (if ``preempt``) in-service remnants are cut at the
    completion instant, each paying ``cancel_overhead`` of server time
    that is accounted BUSY and WASTED and that blocks the server — new
    arrivals cannot seize a worker inside its purge window (a sentinel
    occupies the server until a ``free`` event releases it);
  * without ``preempt`` remnants run to completion and their full
    service time is wasted work.

Accounting notes: utilization is busy time over n x horizon with horizon
the last job completion; remnants still running past the horizon at the
end of a non-preempt trace are dropped (their finish events are never
processed), an O(n / num_jobs) truncation the parity tests absorb in
tolerance.
"""
from __future__ import annotations

import collections
import heapq
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, generator, resolve
from ..assign.strategies import group_ids_matrix, is_all_workers
from ..core.distributions import Scaling, ServiceTime
from ..core.policy import RetryPolicy
from ..core.scenario import Scenario, sample_task_matrix
from .cluster import ClusterConfig, ClusterResult, JobStats, default_warmup
from .failures import as_failure_arrays, resolve_retry

__all__ = ["simulate_oracle", "sweep_oracle"]

_SENTINEL = -1   # pseudo job id occupying a server during its purge window


class _Worker:
    """One exclusive server: FCFS queue of (job_id, service_time)."""

    __slots__ = ("queue", "busy_until", "current", "busy_time",
                 "wasted_time")

    def __init__(self):
        self.queue: Deque[Tuple[int, float]] = collections.deque()
        self.busy_until = 0.0
        self.current: Optional[Tuple[int, float, float]] = None  # job,t0,svc
        self.busy_time = 0.0
        self.wasted_time = 0.0


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.float64)


def _draw_inputs(cfg: ClusterConfig, dist: ServiceTime, scaling: Scaling,
                 delta: Optional[float],
                 service_times: Optional[np.ndarray],
                 arrival_times: Optional[np.ndarray],
                 device=DEFAULT_DEVICE):
    """(num_jobs, n) task times + (num_jobs,) arrivals, shared substrate,
    as host float64 arrays.

    Task times come from ``core.scenario.sample_task_matrix`` drawn on
    ``device`` from a generator seeded ``seed`` — the batched engine's
    single-cell path draws the identical matrix, which is what makes
    exact sample-path parity hold.  Arrivals: the legacy numpy Poisson
    stream when ``cfg.arrivals`` is None (the same stream as the JAX
    package's), else the pluggable ``ArrivalProcess`` from a generator
    seeded ``seed + 1``, rescaled to ``cfg.arrival_rate``.
    """
    n = cfg.n_workers
    if service_times is None:
        svc = _host(sample_task_matrix(
            dist, scaling, n, n // cfg.k, cfg.num_jobs,
            generator(cfg.seed, device), delta=delta,
            worker_speeds=cfg.worker_speeds))
    else:
        svc = np.asarray(service_times, dtype=np.float64)
        if svc.shape != (cfg.num_jobs, n):
            raise ValueError(f"service_times must be {(cfg.num_jobs, n)}, "
                             f"got {svc.shape}")
    if arrival_times is None:
        if cfg.arrivals is None:
            rng = np.random.default_rng(cfg.seed)
            inter = rng.exponential(1.0 / cfg.arrival_rate,
                                    size=cfg.num_jobs)
            arrivals = np.cumsum(inter)
        else:
            arrivals = _host(cfg.arrivals.times(
                generator(cfg.seed + 1, device), cfg.num_jobs,
                cfg.arrival_rate))
    else:
        arrivals = np.asarray(arrival_times, dtype=np.float64)
        if arrivals.shape != (cfg.num_jobs,):
            raise ValueError(f"arrival_times must be {(cfg.num_jobs,)}, "
                             f"got {arrivals.shape}")
    return svc, arrivals


def _draw_failures(cfg: ClusterConfig,
                   crash_times: Optional[np.ndarray] = None,
                   recovery_times: Optional[np.ndarray] = None,
                   device=DEFAULT_DEVICE):
    """The failure-mode inputs both backends share, or None when the cell
    is fault-free (no ``cfg.failures``, no injected schedule, no killing
    timeout on ``cfg.retry``).

    Returns (crash, recover, jitter_u, retry): the (n, M) schedule — an
    injected deterministic one (the exact-parity path), a stochastic one
    sampled from ``cfg.failures`` on a generator seeded ``seed + 2``, or
    an empty (n, 0) one for a timeout-only policy — plus the
    backoff-jitter uniforms from a generator seeded ``seed + 3`` (None
    when the policy is deterministic) and the resolved ``RetryPolicy``.
    Seeds are disjoint from the service (seed) and arrival (seed + 1)
    draws, so attaching a failure model never perturbs the fault-free
    sample path.  Draws land on ``device``, then on the host in float64.
    """
    injected = crash_times is not None or recovery_times is not None
    if not injected and cfg.failures is None and (
            cfg.retry is None or not cfg.retry.kills_on_timeout):
        return None
    n = cfg.n_workers
    if injected:
        if crash_times is None or recovery_times is None:
            raise ValueError(
                "crash_times and recovery_times must be injected together")
        crash, recover = as_failure_arrays(crash_times, recovery_times, n)
    elif cfg.failures is not None:
        crash, recover = map(_host, cfg.failures.schedule(
            generator(cfg.seed + 2, device), n))
    else:                                   # timeout-only retry policy
        crash = np.zeros((n, 0))
        recover = np.zeros((n, 0))
    retry = resolve_retry(cfg.retry)
    jitter_u = None
    if retry.max_attempts > 1 and retry.jitter > 0:
        dev = resolve(device)
        jitter_u = _host(torch.rand(
            (cfg.num_jobs, n, retry.max_attempts - 1),
            generator=generator(cfg.seed + 3, dev), device=dev))
    return crash, recover, jitter_u, retry


def simulate_oracle(cfg: ClusterConfig, dist: ServiceTime, scaling: Scaling,
                    delta: Optional[float] = None,
                    service_times: Optional[np.ndarray] = None,
                    arrival_times: Optional[np.ndarray] = None,
                    crash_times: Optional[np.ndarray] = None,
                    recovery_times: Optional[np.ndarray] = None,
                    device=DEFAULT_DEVICE) -> ClusterResult:
    """Run the discrete-event simulation; returns latency/utilization stats.

    Inputs not injected are drawn on ``device``; the event loop itself is
    host Python in float64.

    A failure model (``cfg.failures``), an injected ``crash_times`` /
    ``recovery_times`` schedule, or a killing ``cfg.retry`` timeout
    routes to the crash-restart event loop; otherwise this is the
    historical fault-free loop, bit-stable with the original simulator.
    """
    n, k = cfg.n_workers, cfg.k
    svc, arrivals = _draw_inputs(cfg, dist, scaling, delta,
                                 service_times, arrival_times, device)
    fail = _draw_failures(cfg, crash_times, recovery_times, device)
    if fail is not None:
        return _simulate_oracle_failures(cfg, svc, arrivals, *fail)

    # grouped assignment: per-group any-r completion with GROUP-LOCAL
    # remnant cancellation at each group's own resolution instant — the
    # event-loop mirror of ``_scan_lane_grouped`` (see assign.strategies)
    grouped = not is_all_workers(getattr(cfg, "assignment", None))
    if grouped:
        g, gneed, gid = group_ids_matrix(cfg.assignment, n, k,
                                         cfg.num_jobs, cfg.worker_speeds)
        done_groups: set = set()              # resolved (job, group) pairs
        fin_g: Dict[int, List[int]] = {}
        groups_done: Dict[int, int] = {}

    workers = [_Worker() for _ in range(n)]
    jobs: Dict[int, JobStats] = {}
    finished_tasks: Dict[int, int] = {}
    done_jobs: set = set()

    # event heap: (time, seq, kind, payload)
    events: List[Tuple[float, int, str, tuple]] = []
    seq = 0
    for j, t in enumerate(arrivals):
        heapq.heappush(events, (float(t), seq, "arrive", (j,)))
        seq += 1

    def purged(job: int, widx: int) -> bool:
        """Queued task no longer needed: its job — or, under a grouped
        assignment, its (job, group) — already resolved."""
        return job in done_jobs or (
            grouped and (job, gid[job, widx]) in done_groups)

    def start_next(w: _Worker, widx: int, now: float):
        nonlocal seq
        while w.queue:
            job, st = w.queue.popleft()
            if purged(job, widx):
                continue                      # purged from queue (free)
            w.current = (job, now, st)
            w.busy_until = now + st
            heapq.heappush(events, (w.busy_until, seq, "finish",
                                    (widx, job)))
            seq += 1
            return
        w.current = None

    def cancel_inflight(job: int, now: float, widxs, skip: _Worker):
        """Cancel a resolved (job|group)'s running remnants: purge
        queues lazily; preempt in-service tasks at ``now`` with the
        cancel-overhead window occupying the server."""
        nonlocal seq
        for widx2 in widxs:
            w2 = workers[widx2]
            if w2 is skip:
                continue
            if w2.current is not None and w2.current[0] == job:
                if cfg.preempt:
                    _, t02, _ = w2.current
                    oh = cfg.cancel_overhead
                    w2.busy_time += (now - t02) + oh
                    w2.wasted_time += (now - t02) + oh
                    w2.busy_until = now + oh
                    if oh > 0.0:
                        w2.current = (_SENTINEL, now, oh)
                        heapq.heappush(
                            events, (now + oh, seq, "free", (widx2,)))
                        seq += 1
                    else:
                        start_next(w2, widx2, now)

    completed = 0
    while events and completed < cfg.num_jobs:
        now, _, kind, payload = heapq.heappop(events)
        if kind == "arrive":
            (j,) = payload
            jobs[j] = JobStats(arrival=now)
            finished_tasks[j] = 0
            if grouped:
                fin_g[j] = [0] * g
                groups_done[j] = 0
            for widx, w in enumerate(workers):
                w.queue.append((j, svc[j, widx]))
                if w.current is None:
                    start_next(w, widx, now)
        elif kind == "free":
            (widx,) = payload
            w = workers[widx]
            if w.current is not None and w.current[0] == _SENTINEL:
                w.current = None
                start_next(w, widx, now)
        else:  # finish
            widx, job = payload
            w = workers[widx]
            if w.current is None or w.current[0] != job:
                continue                      # stale event (cancelled)
            _, t0, st = w.current
            w.busy_time += now - t0
            if purged(job, widx):
                w.wasted_time += now - t0     # remnant ran to completion
            elif not grouped:
                finished_tasks[job] += 1
                if finished_tasks[job] == k:
                    done_jobs.add(job)
                    jobs[job].done = now
                    completed += 1
                    # cancel: purge queues; preempt in-service remnants.
                    # cancel_overhead is accounted busy AND wasted, and
                    # occupies the server until the purge window ends.
                    cancel_inflight(job, now, range(n), w)
            else:
                gi = gid[job, widx]
                fin_g[job][gi] += 1
                if fin_g[job][gi] == gneed:
                    # group resolved: cancel ITS remnants here and now —
                    # group-local, the job may still be racing elsewhere
                    done_groups.add((job, int(gi)))
                    groups_done[job] += 1
                    cancel_inflight(
                        job, now,
                        [i for i in range(n) if gid[job, i] == gi], w)
                    if groups_done[job] == g:
                        done_jobs.add(job)
                        jobs[job].done = now
                        completed += 1
            start_next(w, widx, now)

    horizon = max((j.done for j in jobs.values() if j.done > 0),
                  default=1.0)
    lat = np.array([j.latency for j in jobs.values() if j.done > 0])
    busy = sum(w.busy_time for w in workers)
    waste = sum(w.wasted_time for w in workers)
    return ClusterResult(
        latencies=lat,
        utilization=busy / (n * horizon),
        wasted_frac=waste / max(busy, 1e-12),
        throughput=len(lat) / horizon,
        warmup=cfg.warmup,
    )


class _FWorker:
    """One exclusive server of the failure-mode loop.

    ``queue`` holds first-attempt entries (job, service_time); retries
    never re-enter the queue — a relaunching task keeps the worker
    reserved through its ``current`` record.  ``current`` is a tagged
    tuple with the occupancy start t0 = max(arrival, F) always at
    index 2:

        ("task",  job, t0, ta, st, a)      attempt a (1-based) running
                                           since ta
        ("wait",  job, t0, st, a, ready)   backing off after failed
                                           attempt a; relaunch at ready
        ("dying", job, t0, r)              final attempt crashed; the
                                           loss registers at recovery r
        ("purge", until)                   cancel-overhead window

    ``F`` is the worker's LOGICAL free time — the batched recurrence's
    carry: the release instant of the last task that engaged the worker
    (purged tasks leave it untouched).  Accounting is occupancy-based
    and applied as one lump at task resolution: busy += release - t0,
    downtime and backoff waits included, exactly the batched engine's
    ``occ`` classification.
    """

    __slots__ = ("queue", "current", "up", "F", "busy_time", "wasted_time")

    def __init__(self):
        self.queue: Deque[Tuple[int, float]] = collections.deque()
        self.current: Optional[tuple] = None
        self.up = True
        self.F = 0.0
        self.busy_time = 0.0
        self.wasted_time = 0.0


def _simulate_oracle_failures(cfg: ClusterConfig, svc: np.ndarray,
                              arrivals: np.ndarray, crash: np.ndarray,
                              recover: np.ndarray,
                              jitter_u: Optional[np.ndarray],
                              retry: RetryPolicy) -> ClusterResult:
    """The crash-restart discrete-event loop — the independent
    implementation of ``runtime.failures``' closed-form semantics that
    the failure parity cells validate.

    Event vocabulary on top of the fault-free loop: per-worker "crash" /
    "recover" instants (pushed up front, so at equal times the fleet
    state changes before any dispatch decision), "abort" (timeout kill),
    "redispatch" (backoff expiry), "taskfail" (a terminal crash loss
    registers at the RECOVERY of its final attempt), and the existing
    "arrive" / "finish" / "free".  Stale events are skipped by identity:
    finish/abort carry their attempt's start instant, redispatch its
    attempt count, taskfail its occupancy start — any of which a
    cancellation or kill invalidates.

    A job resolves at its k-th surviving task completion (success) or at
    its (n-k+1)-th terminal task loss (failure); either way remnants are
    cancelled exactly like the fault-free engine (queue purges free;
    in-flight tasks — running, backing off, or dying — are cut at
    D + cancel_overhead when ``preempt``, and otherwise run out their
    full relaunch schedule as wasted work).
    """
    n, k = cfg.n_workers, cfg.k
    kills = retry.kills_on_timeout
    losses_to_fail = n - k + 1

    # grouped assignment: each group of c = n/g workers must deliver
    # r = k/g survivors; a group FAILS at its (c-r+1)-th terminal loss
    # and the job fails the instant the FIRST group does (see
    # failures.group_resolution for the closed-form twin)
    grouped = not is_all_workers(getattr(cfg, "assignment", None))
    if grouped:
        g, gneed, gid = group_ids_matrix(cfg.assignment, n, k,
                                         cfg.num_jobs, cfg.worker_speeds)
        group_losses_to_fail = n // g - gneed + 1
        done_groups: set = set()              # resolved (job, group) pairs
        fin_g: Dict[int, List[int]] = {}
        lost_g: Dict[int, List[int]] = {}
        groups_done: Dict[int, int] = {}

    workers = [_FWorker() for _ in range(n)]
    jobs: Dict[int, JobStats] = {}
    finished_tasks: Dict[int, int] = {}
    lost_tasks: Dict[int, int] = {}
    job_ok: Dict[int, bool] = {}
    done_jobs: set = set()
    resolved = 0

    events: List[Tuple[float, int, str, tuple]] = []
    seq = 0

    def push(t: float, kind: str, payload: tuple):
        nonlocal seq
        heapq.heappush(events, (float(t), seq, kind, payload))
        seq += 1

    # fleet schedule first: at equal instants a crash/recovery reorders
    # the fleet BEFORE any same-time dispatch or loss event sees it
    for widx in range(n):
        for m in range(crash.shape[1]):
            push(crash[widx, m], "crash", (widx, float(recover[widx, m])))
            push(recover[widx, m], "recover", (widx,))
    for j, t in enumerate(arrivals):
        push(t, "arrive", (j,))

    def dispatch(w: _FWorker, widx: int, job: int, t0: float, st: float,
                 a: int, now: float):
        """Start attempt ``a`` (1-based) of a task at ``now``."""
        w.current = ("task", job, t0, now, st, a)
        if kills and st > retry.timeout:
            push(now + retry.timeout, "abort", (widx, job, now))
        else:
            push(now + st, "finish", (widx, job, now))

    def purged(job: int, widx: int) -> bool:
        """Task no longer needed: its job — or, under a grouped
        assignment, its (job, group) — already resolved."""
        return job in done_jobs or (
            grouped and (job, gid[job, widx]) in done_groups)

    def start_next(w: _FWorker, widx: int, now: float):
        if not w.up or w.current is not None:
            return
        while w.queue:
            job, st = w.queue.popleft()
            if purged(job, widx):
                continue                  # purged from queue (free)
            dispatch(w, widx, job, max(jobs[job].arrival, w.F), st, 1, now)
            return

    def resolve_task_loss(w: _FWorker, widx: int, job: int, t0: float,
                          release: float):
        """A task exhausted its attempts: occupancy is wasted, the
        worker's logical free time is the release instant, and (for a
        live job/group) the loss counts toward failure."""
        w.busy_time += release - t0
        w.wasted_time += release - t0
        w.F = release
        w.current = None
        if not purged(job, widx):
            if not grouped:
                lost_tasks[job] += 1
                if lost_tasks[job] == losses_to_fail:
                    resolve_job(job, release, success=False)
            else:
                gi = gid[job, widx]
                lost_g[job][gi] += 1
                # one exhausted group sinks the whole job, instantly
                if lost_g[job][gi] == group_losses_to_fail:
                    resolve_job(job, release, success=False)
        start_next(w, widx, release)

    def fail_attempt(w: _FWorker, widx: int, job: int, t0: float, st: float,
                     a: int, fail_at: float, resume: float, crashed: bool):
        """Attempt ``a`` died at ``fail_at``; the worker frees (crash:
        recovers) at ``resume``.  Back off and relaunch, or give up."""
        if a < retry.max_attempts:
            u = 0.5 if jitter_u is None else jitter_u[job, widx, a - 1]
            ready = max(resume, fail_at + retry.delay(a - 1, u))
            w.current = ("wait", job, t0, st, a, ready)
            push(ready, "redispatch", (widx, job, a))
        elif crashed:
            # the loss is only final once the worker is back: defer it
            w.current = ("dying", job, t0, resume)
            push(resume, "taskfail", (widx, job, t0))
        else:                             # timeout exhaust: final here
            resolve_task_loss(w, widx, job, t0, resume)

    def cancel_tasks(job: int, now: float, widxs):
        """Cancel ``job``'s remnants on ``widxs`` at resolution instant
        ``now`` — shared by group-local resolution (a group's members at
        its own instant) and job resolution (every not-yet-resolved
        group at D)."""
        oh = cfg.cancel_overhead

        def cut(w2: _FWorker, widx2: int, t0: float):
            """Engaged remnant under preempt: cut at D + overhead."""
            w2.busy_time += (now - t0) + oh
            w2.wasted_time += (now - t0) + oh
            w2.F = now + oh
            if oh > 0.0:
                w2.current = ("purge", now + oh)
                push(now + oh, "free", (widx2, now + oh))
            else:
                w2.current = None
                start_next(w2, widx2, now)

        for widx2 in widxs:
            w2 = workers[widx2]
            cur = w2.current
            if cur is not None and cur[0] != "purge" and cur[1] == job:
                # in flight — running, backing off, or dying.  Preempt:
                # cut, invalidating its pending finish/abort/redispatch/
                # taskfail by identity.  No preempt: it relaunches and
                # runs out as wasted work.
                if cfg.preempt:
                    cut(w2, widx2, cur[2])
                continue
            if cur is not None and cur[0] != "purge":
                continue                  # busy with another job's task
            # the task may still be QUEUED solely because the worker is
            # down (or stuck in a purge window that downtime outlived).
            # Its LOGICAL start max(arrival, F) is what the batched
            # recurrence classifies on: engaged if that precedes D, even
            # though no attempt ever ran — so cut it (or, without
            # preempt, launch it as a remnant at recovery).
            while w2.queue and w2.queue[0][0] != job \
                    and purged(w2.queue[0][0], widx2):
                w2.queue.popleft()        # earlier resolved work: free
            if not w2.queue or w2.queue[0][0] != job:
                continue
            t0 = max(jobs[job].arrival, w2.F)
            if t0 >= now:
                continue                  # purged: start >= D, stays free
            _, st = w2.queue.popleft()
            if cfg.preempt:
                cut(w2, widx2, t0)
            else:
                w2.current = ("wait", job, t0, st, 0, t0)
                push(now, "redispatch", (widx2, job, 0))

    def resolve_job(job: int, now: float, success: bool):
        nonlocal resolved
        done_jobs.add(job)
        jobs[job].done = now
        job_ok[job] = success
        resolved += 1
        if grouped:
            # groups that already resolved cancelled their own remnants
            # at their own instants; only unresolved groups remain
            widxs = [i for i in range(n)
                     if (job, gid[job, i]) not in done_groups]
        else:
            widxs = range(n)
        cancel_tasks(job, now, widxs)

    while events and resolved < cfg.num_jobs:
        now, _, kind, payload = heapq.heappop(events)
        if kind == "arrive":
            (j,) = payload
            jobs[j] = JobStats(arrival=now)
            finished_tasks[j] = 0
            lost_tasks[j] = 0
            if grouped:
                fin_g[j] = [0] * g
                lost_g[j] = [0] * g
                groups_done[j] = 0
            for widx, w in enumerate(workers):
                w.queue.append((j, svc[j, widx]))
                start_next(w, widx, now)
        elif kind == "crash":
            widx, r = payload
            w = workers[widx]
            w.up = False
            cur = w.current
            if cur is not None and cur[0] == "task":
                _, job, t0, ta, st, a = cur
                if ta + st <= now:
                    pass    # finished exactly at the crash: the pending
                    #         finish event (same instant) completes it
                else:
                    fail_attempt(w, widx, job, t0, st, a,
                                 fail_at=now, resume=r, crashed=True)
        elif kind == "recover":
            (widx,) = payload
            w = workers[widx]
            w.up = True
            cur = w.current
            if cur is None:
                start_next(w, widx, now)
            elif cur[0] == "wait" and cur[5] <= now:
                _, job, t0, st, a, _ready = cur
                dispatch(w, widx, job, t0, st, a + 1, now)
            elif cur[0] == "purge" and cur[1] <= now:
                w.current = None
                start_next(w, widx, now)
        elif kind == "redispatch":
            widx, job, a = payload
            w = workers[widx]
            cur = w.current
            if (w.up and cur is not None and cur[0] == "wait"
                    and cur[1] == job and cur[4] == a and cur[5] <= now):
                _, _, t0, st, _, _ = cur
                dispatch(w, widx, job, t0, st, a + 1, now)
            # worker down: the recovery event relaunches instead
        elif kind == "free":
            widx, until = payload
            w = workers[widx]
            if w.up and w.current == ("purge", until):
                w.current = None
                start_next(w, widx, now)
        elif kind == "taskfail":
            widx, job, t0m = payload
            w = workers[widx]
            cur = w.current
            if cur is not None and cur[0] == "dying" and cur[1] == job \
                    and cur[2] == t0m:
                resolve_task_loss(w, widx, job, t0m, cur[3])
        elif kind == "abort":
            widx, job, ta = payload
            w = workers[widx]
            cur = w.current
            if cur is not None and cur[0] == "task" and cur[1] == job \
                    and cur[3] == ta:
                _, _, t0, _, st, a = cur
                fail_attempt(w, widx, job, t0, st, a,
                             fail_at=now, resume=now, crashed=False)
        else:  # finish
            widx, job, ta = payload
            w = workers[widx]
            cur = w.current
            if cur is None or cur[0] != "task" or cur[1] != job \
                    or cur[3] != ta:
                continue                  # stale (killed or cancelled)
            _, _, t0, _, st, a = cur
            w.busy_time += now - t0
            w.F = now
            w.current = None
            if purged(job, widx):
                w.wasted_time += now - t0   # remnant ran out (no preempt)
            elif not grouped:
                finished_tasks[job] += 1
                if finished_tasks[job] == k:
                    resolve_job(job, now, success=True)
            else:
                gi = gid[job, widx]
                fin_g[job][gi] += 1
                if fin_g[job][gi] == gneed:
                    # group delivered its r survivors: cancel ITS
                    # remnants now (group-local); the job resolves once
                    # every group has
                    done_groups.add((job, int(gi)))
                    groups_done[job] += 1
                    cancel_tasks(
                        job, now,
                        [i for i in range(n)
                         if gid[job, i] == gi and i != widx])
                    if groups_done[job] == g:
                        resolve_job(job, now, success=True)
            start_next(w, widx, now)

    order = sorted(jobs)
    lat = np.array([jobs[j].latency for j in order])
    failed = np.array([not job_ok.get(j, False) for j in order])
    horizon = max((jobs[j].done for j in order), default=1.0)
    busy = sum(w.busy_time for w in workers)
    waste = sum(w.wasted_time for w in workers)
    completions = int((~failed).sum())
    return ClusterResult(
        latencies=lat,
        utilization=busy / (n * horizon),
        wasted_frac=waste / max(busy, 1e-12),
        throughput=completions / horizon,
        warmup=cfg.warmup,
        job_failed=failed,
    )


def sweep_oracle(scenario: Scenario, loads, ks=None, num_jobs: int = 1000,
                 reps: int = 1, preempt: bool = True,
                 cancel_overhead: float = 0.0, seed: int = 0,
                 warmup=None, retry: Optional[RetryPolicy] = None,
                 assignment=None, device=DEFAULT_DEVICE):
    """The (loads x ks) surface on the oracle, cell by cell — the slow
    validation twin of ``cluster_batched.sweep`` with the same
    ``ClusterSweep`` result type and defaults (``warmup=None`` resolves
    through the shared ``cluster.default_warmup``).  ``reps`` runs each
    cell that many
    times on shifted seeds; latency stats pool replications and
    post-warmup jobs, per-lane rates average over replications — the
    same aggregation as the batched engine.

    A ``scenario.failures`` model (or a killing ``retry`` timeout) runs
    every cell through the crash-restart loop; the surface then carries
    ``failure_rate``.  Schedules are drawn per (cell, rep) seed — a
    DIFFERENT sampling layout from the batched engine's one-schedule-
    per-rep CRN discipline, so cross-backend failure comparisons are
    distributional, not samplewise (the exact-parity path is an
    injected schedule through ``simulate``).  Draws land on ``device``.
    """
    from .cluster_batched import ClusterSweep, resolve_failure_args
    n = scenario.n
    device = resolve(device)
    ks = tuple(scenario.legal_ks()) if ks is None \
        else tuple(int(k) for k in ks)
    loads = [float(v) for v in loads]
    if not loads or any(v <= 0 for v in loads):
        raise ValueError("loads must be positive arrival rates")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if warmup is None:
        warmup = default_warmup(num_jobs)
    failures, retry = resolve_failure_args(scenario, retry)
    faulty = retry is not None
    L, K = len(loads), len(ks)
    shape = (L, K)
    mean = np.zeros(shape)
    p50, p95, p99 = np.zeros(shape), np.zeros(shape), np.zeros(shape)
    util, waste, thru = np.zeros(shape), np.zeros(shape), np.zeros(shape)
    fail = np.zeros(shape) if faulty else None
    for i, lam in enumerate(loads):
        for j, k in enumerate(ks):
            lats, us, ws, ts, fs = [], [], [], [], []
            for r in range(reps):
                cfg = ClusterConfig(
                    n_workers=n, k=k, arrival_rate=lam, num_jobs=num_jobs,
                    preempt=preempt, cancel_overhead=cancel_overhead,
                    seed=seed + 7919 * r, warmup=warmup,
                    arrivals=scenario.arrivals,
                    worker_speeds=scenario.worker_speeds,
                    failures=failures,
                    retry=retry if faulty else None,
                    assignment=assignment)
                res = simulate_oracle(cfg, scenario.dist, scenario.scaling,
                                      delta=scenario.delta, device=device)
                lats.append(res.steady_latencies)
                us.append(res.utilization)
                ws.append(res.wasted_frac)
                ts.append(res.throughput)
                fs.append(res.failure_rate)
            pooled = np.concatenate(lats)
            empty = pooled.size == 0          # every post-warmup job failed
            mean[i, j] = pooled.mean() if not empty else np.inf
            p50[i, j] = np.quantile(pooled, 0.50) if not empty else np.inf
            p95[i, j] = np.quantile(pooled, 0.95) if not empty else np.inf
            p99[i, j] = np.quantile(pooled, 0.99) if not empty else np.inf
            util[i, j] = np.mean(us)
            waste[i, j] = np.mean(ws)
            thru[i, j] = np.mean(ts)
            if faulty:
                fail[i, j] = np.mean(fs)
    return ClusterSweep(
        loads=tuple(loads), ks=ks, warmup=int(warmup), reps=int(reps),
        mean=mean, p50=p50, p95=p95, p99=p99, utilization=util,
        wasted_frac=waste, throughput=thru, failure_rate=fail,
    )
