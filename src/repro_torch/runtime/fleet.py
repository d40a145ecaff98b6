"""Fleet-scale chunked cluster engine: n ~ 10^4 workers x 10^5+ jobs.

The monolithic batched engine (``runtime.cluster_batched``) materializes
the full (reps, K, num_jobs, n) service table and the (reps, loads, K,
num_jobs) latency cube — fine at n ~ 10^2, hopeless at fleet scale (one
n = 10^4 x 10^5-job float32 table alone is ~4 GB).  This module runs the
SAME per-job recurrence (the step factories of ``cluster_batched`` are
reused unchanged — ``make_plain_step`` etc., so the dynamics are shared
code, not a re-implementation) in a memory-bounded streaming form:

  * **Chunked loop** — an outer loop over fixed-size job chunks; the
    carry holds only the (lanes, n) worker free-times, the arrival-
    process state, a per-lane clock base and the streaming-statistics
    state.  Peak memory is O(lanes * n + chunk * n), independent of
    num_jobs.
  * **Chunk-offset sampling** — every random input (service noise,
    arrival gaps, retry jitter, reservoir acceptance, the failure
    schedule) is drawn from per-GLOBAL-job-index row keys
    (``core.scenario.job_row_keys``, counter-based ``core.threefry``
    bits), so any chunking of [0, N) walks the bit-identical sample path
    — on the host and on the card alike.  The chunk size is a pure
    performance knob.  (An equal-in-law path different from the
    monolithic engine's generator draws.)
  * **Per-chunk clock rebasing** — at each chunk boundary the free
    times, the failure schedule and the statistics are re-expressed
    relative to the chunk's last arrival, so float32 never carries a
    large absolute clock.  Absolute horizons are rebuilt on the host in
    float64 from the per-chunk offsets.
  * **Streaming statistics** — Welford count/mean/M2 merged per chunk
    plus a fixed-size Algorithm-R reservoir for p50/p95/p99
    (``runtime.streamstats``); warmup is a job-index mask.  The exact
    small-trace path (identical ``summarize_sweep`` aggregation) is kept
    for parity and moderate sizes.
  * **Sharded lanes** — the flattened (loads x K) lane axis can be split
    over ``shard`` cards, each running its lanes' loop; ``shard=1`` is
    the unsharded path (pinned by tests).  No multi-card run is checked
    by anything in this repo.

How it maps onto the card: as in the monolithic engine, each job step is
one set of PyTorch operations over every lane, enqueued by one Python
loop that never reads a value back; per-chunk scalars stay on the device
and reach the host once, after the loop.  The JAX package pads the last
chunk and freezes the carry with four ``where``s a step; padded steps
change nothing (their gaps are 0, their outputs dropped), so this loop
runs exactly ``num_jobs`` steps and has no freeze.  The JAX package
selects the k-th finish by a 31-pass radix bisection at n >= 1024
(XLA's CPU sort is slow there); the step here keeps the sort, which
gives the same value bit for bit on the non-negative finishes — one
sort launch against ~120 launches of host time a step.  ``_kth_bisect``
is kept as a function, held to both.

Entry points: ``fleet_sweep`` mirrors ``cluster_batched.sweep`` and
returns the same ``ClusterSweep``; ``cluster_batched.sweep(...,
chunk_size=...)`` and the surface cache dispatch here.
``run_fleet``/``summarize_fleet`` are the raw lane-level API the
(k, assignment) co-optimizer (``assign.surface.co_sweep``) slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve
from ..assign.strategies import (Assignment, group_ids_matrix,
                                 is_all_workers)
from ..core import threefry
from ..core.distributions import Scaling
from ..core.policy import RetryPolicy
from ..core.scenario import Scenario, job_row_keys
from ..obs import recorder as _trace
from .cluster_batched import (ClusterSweep, make_failure_step,
                              make_grouped_failure_step, make_grouped_step,
                              make_plain_step, resolve_failure_args,
                              summarize_sweep, validate_sweep_args)
from .failures import torch_namespace
from .streamstats import (reservoir_init, reservoir_update_chunk,
                          reservoir_values_host, welford_finalize_host,
                          welford_init, welford_merge_chunk)

__all__ = ["FleetLanes", "FleetRaw", "build_fleet_lanes", "co_fleet_lanes",
           "default_chunk", "fleet_compile_count", "fleet_sweep",
           "run_fleet", "summarize_fleet", "trim_raw_loads"]

_FLEET_CONFIGS: set = set()

_DEFAULT_CHUNK = 512


def fleet_compile_count() -> int:
    """How many distinct static configurations the chunked engine has run.

    The JAX package counts jit traces of its fleet kernel here; the port
    compiles nothing, so it counts the distinct tuples of what the
    reference's jit keys on — the static arguments (scaling, n,
    num_jobs, chunk, preempt, retry, grouping, stream, reservoir, shard
    count, largest task size), the lane count, the distribution and
    arrival families, the presence of delta and the failure model's
    event count — plus the device.  Fresh rates and seeds on the same
    shapes add nothing.
    """
    return len(_FLEET_CONFIGS)


def _peak_rss_mb() -> float:
    """Peak resident set of this process in MB (ru_maxrss is KB on
    Linux, bytes on macOS); -1.0 where ``resource`` is unavailable."""
    try:
        import resource
        import sys
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak / (1024.0 * 1024.0) if sys.platform == "darwin" \
            else peak / 1024.0
    except Exception:
        return -1.0


def default_chunk(num_jobs: int) -> int:
    """The ``chunk_size=None`` resolution: one chunk for small traces; at
    scale, the smallest chunk that keeps the chunk COUNT of the 512
    bound — balanced chunks instead of a ragged tail (600 jobs give
    2 x 300)."""
    num_jobs = int(num_jobs)
    if num_jobs <= _DEFAULT_CHUNK:
        return num_jobs
    num_chunks = -(-num_jobs // _DEFAULT_CHUNK)
    return -(-num_jobs // num_chunks)


def _kth_bisect(nat: torch.Tensor, k) -> torch.Tensor:
    """Exact k-th smallest of non-negative float32 values along the last
    axis, by radix bisection on the bit patterns.

    For floats >= 0 the int32 bit pattern is order-isomorphic to the
    float ordering (+inf included), so building the answer bit by bit
    from the MSB — keep a candidate bit iff fewer than k values lie
    strictly below it — lands exactly on ``sort(nat)[k-1]`` in 31
    comparison passes.  ``k`` is an int or an integer tensor over the
    leading axes; returns the leading axes' shape.
    """
    x = nat.contiguous().view(torch.int32)
    k = torch.as_tensor(k, device=nat.device)
    pre = torch.zeros(nat.shape[:-1], dtype=torch.int32, device=nat.device)
    for i in range(31):
        cand = pre | (1 << (30 - i))
        below = (x < cand[..., None]).sum(-1)
        pre = torch.where(below >= k, pre, cand)
    return pre.view(torch.float32)


# --------------------------------------------------------------------------
# Lane bundles: the flattened (k [, assignment]) axis
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetLanes:
    """The chunked engine's flattened lane bundle (one entry per k — or
    per (assignment, k) when the co-optimizer builds it).

    Unlike ``assign.strategies.GroupLanes`` the worker->group masks are
    per-lane CONSTANT rows (B, n), not (B, num_jobs, n) — the chunked
    engine requires a per-job-constant placement (``RandomGroups``
    re-draws masks every job and is rejected at build time).
    """

    k: np.ndarray               # (B,) int32 per-lane k
    s: np.ndarray               # (B,) int32 task size n // k
    r: np.ndarray               # (B,) int32 within-group rank (k ungrouped)
    gid: np.ndarray             # (B, n) int32 (or (B, 0) ungrouped)
    grouped: bool
    groups: Optional[int]       # max group count (None ungrouped)
    signature: Optional[tuple]  # structural cache key


def _reject_per_job(assignment: Assignment) -> None:
    if assignment.per_job():
        raise ValueError(
            f"{type(assignment).__name__} re-draws its placement per job; "
            "the chunked engine carries one constant worker->group row per "
            "lane — use the monolithic engine (chunk_size=None) for "
            "per-job-random placements")


def build_fleet_lanes(assignment: Optional[Assignment], n: int,
                      ks: Sequence[int],
                      speeds: Optional[Tuple[float, ...]] = None
                      ) -> FleetLanes:
    """Resolve one strategy into the chunked engine's lane bundle."""
    karr = np.asarray([int(k) for k in ks], np.int32)
    if is_all_workers(assignment):
        return FleetLanes(k=karr, s=(n // karr).astype(np.int32),
                          r=karr.copy(), gid=np.zeros((karr.size, 0),
                                                      np.int32),
                          grouped=False, groups=None, signature=None)
    _reject_per_job(assignment)
    rs, gids, gmax = [], [], 1
    for k in karr:
        g, r, gid = group_ids_matrix(assignment, n, int(k), 1, speeds)
        gmax = max(gmax, g)
        rs.append(r)
        gids.append(gid[0])
    return FleetLanes(k=karr, s=(n // karr).astype(np.int32),
                      r=np.asarray(rs, np.int32),
                      gid=np.asarray(gids, np.int32), grouped=True,
                      groups=gmax,
                      signature=assignment.cache_signature(n, tuple(
                          int(k) for k in karr)))


def co_fleet_lanes(assignments: Sequence[Assignment], n: int,
                   ks: Sequence[int],
                   speeds: Optional[Tuple[float, ...]] = None
                   ) -> FleetLanes:
    """Flatten an A x K (assignment, k) grid into one grouped lane axis —
    the chunked twin of ``assign.surface.co_sweep``'s lane flattening.
    ``AllWorkers`` rides as a single-group lane (g=1, r=k), which the
    grouped recurrence reduces to the ungrouped dynamics bit-for-bit."""
    karr, rs, gids, gmax = [], [], [], 1
    kt = tuple(int(k) for k in ks)
    for a in assignments:
        _reject_per_job(a)
        for k in kt:
            g, r, gid = group_ids_matrix(a, n, k, 1, speeds)
            gmax = max(gmax, g)
            karr.append(k)
            rs.append(r)
            gids.append(gid[0])
    karr = np.asarray(karr, np.int32)
    return FleetLanes(k=karr, s=(n // karr).astype(np.int32),
                      r=np.asarray(rs, np.int32),
                      gid=np.asarray(gids, np.int32), grouped=True,
                      groups=gmax,
                      signature=tuple(a.cache_signature(n, kt)
                                      for a in assignments))


# --------------------------------------------------------------------------
# The engine: outer chunk loop, inner job loop over every lane at once
# --------------------------------------------------------------------------

def _lane_steps(dev, lane_k, lane_r, crash, recover, *, n, cancel_overhead,
                preempt, retry, grouped, groups):
    """The step of this lane bundle, built from ``cluster_batched``'s
    factories over the flattened (B,) lane axis: free times (B, n), the
    job's arrivals (B, 1), ``crash``/``recover`` (B, n, M)."""
    if retry is not None:
        xp = torch_namespace(dev)
        if grouped:
            return make_grouped_failure_step(cancel_overhead, preempt, crash,
                                             recover, retry, lane_r, groups,
                                             xp)
        return make_failure_step(lane_k, n, cancel_overhead, preempt, crash,
                                 recover, retry, xp)
    if grouped:
        ridx = (lane_r - 1)[:, None, None].expand(lane_r.shape[0], groups, 1)
        return make_grouped_step(cancel_overhead, preempt, lane_r[:, None],
                                 ridx, groups, dev)
    return make_plain_step((lane_k - 1)[:, None], cancel_overhead, preempt)


def _fleet_lanes_run(key, dev, rates, lane_k, lane_s, lane_r, lane_gid,
                     speeds, cancel_overhead, dist, arrivals, delta,
                     failures, warm, *, scaling, n, num_jobs, chunk,
                     preempt, retry, grouped, groups, stream, reservoir,
                     s_max):
    """One replication of the chunked lane grid, on ``dev``.

    ``rates``/``lane_*`` are lane-major over the flattened (loads x
    K[-per-assignment]) axis, as device tensors.  The outer loop walks
    ceil(num_jobs / chunk) chunks; each chunk draws its shared inputs
    from global-job-index row keys, runs every lane's jobs through the
    step, folds the streaming statistics and REBASES the clock: the free
    times drop the chunk's last arrival instant, so the float32 clock
    stays O(chunk / rate) at any horizon.  Per-chunk scalars (busy and
    wasted increments, arrival offsets, horizon candidates) are stacked
    on the device for float64 reconstruction on the host.

    CRN discipline matches the monolithic engine: one service/arrival
    key pair per replication shared across lanes (arrival gaps drawn
    once at unit rate and scaled per lane), one failure schedule per
    replication shared across lanes, service noise transformed per
    lane's task size inside the step — the (chunk, n) base draw is the
    only materialization, never (lanes, chunk, n).  Streams: service and
    arrivals split from the replication key, the failure schedule, retry
    jitter and reservoir acceptance folded in with 7, 8 and 9 — the
    reference's separation.

    Returns (statistics state or None, {name: stacked device tensor}).
    """
    have_fail = retry is not None
    have_jitter = have_fail and retry.max_attempts > 1 and retry.jitter > 0
    k_svc, k_arrv = threefry.split(key)
    k_jit = threefry.fold_in(key, 8)
    k_stat = threefry.fold_in(key, 9)
    if have_fail and failures is not None:
        crash, recover, _ = failures.schedule_chunk(
            threefry.fold_in(key, 7), n, 0, failures.max_events)
    else:
        crash = torch.zeros((n, 0), dtype=torch.float32, device=dev)
        recover = crash
    b = rates.shape[0]
    sf = lane_s.to(torch.float32)[:, None]                  # (b, 1)
    sidx = lane_s - 1
    d0 = dist.shift if delta is None else delta
    if scaling is Scaling.ADDITIVE:
        def to_srow(zrow):                                  # (n, s_max)
            return zrow[:, sidx].T * speeds
    elif scaling is Scaling.SERVER_DEPENDENT:
        def to_srow(zrow):                                  # (n,)
            return (d0 + sf * zrow) * speeds
    else:
        def to_srow(zrow):
            return (sf * d0 + zrow) * speeds
    steps = dict(n=n, cancel_overhead=cancel_overhead, preempt=preempt,
                 retry=retry, grouped=grouped, groups=groups)
    step = None if have_fail else _lane_steps(dev, lane_k, lane_r, None,
                                              None, **steps)
    extra = (lane_gid,) if grouped else ()
    zero = torch.zeros((b,), dtype=torch.float32, device=dev)

    F = torch.zeros((b, n), dtype=torch.float32, device=dev)
    ast = arrivals.arrival_state0(dev)
    base = zero
    if stream:
        cnt, mean, m2 = welford_init(b, dev)
        res = reservoir_init(b, reservoir, dev)
    ys = {name: [] for name in ("busy", "wasted", "a_last", "last")}
    if have_fail:
        ys.update(hrel=[], nok=[])
    if not stream:
        ys.update(lat=[], **({"ok": []} if have_fail else {}))
    for j0 in range(0, num_jobs, chunk):
        m = min(chunk, num_jobs - j0)
        # -- shared chunk inputs (row-keyed: chunking-invariant) ----------
        g_unit, ast = arrivals.gaps_chunk(k_arrv, j0, m, rate=1.0,
                                          state=ast)
        A_unit = torch.cumsum(g_unit.to(torch.float32), dim=0)
        rks = job_row_keys(k_svc, j0, m)
        if scaling is Scaling.ADDITIVE:
            u = threefry.uniform(rks, n * s_max).view(m, n, s_max)
            z = torch.cumsum(dist.from_uniform(u), dim=-1)
        else:
            z = dist.noise_from_uniform(threefry.uniform(rks, n))
        ujit = None
        if have_jitter:
            a1 = retry.max_attempts - 1
            ujit = threefry.uniform(job_row_keys(k_jit, j0, m),
                                    n * a1).view(m, n, a1)
        A = A_unit[None, :] / rates[:, None]                 # (b, m)
        if have_fail:
            # rebased schedule: chunk clocks start at the last arrival of
            # the previous chunk
            step = _lane_steps(dev, lane_k, lane_r,
                               crash[None] - base[:, None, None],
                               recover[None] - base[:, None, None], **steps)
        carry = (F, zero, zero)
        lat = torch.empty((m, b), dtype=torch.float32, device=dev)
        okj = torch.empty((m, b), dtype=torch.bool, device=dev) \
            if have_fail else None
        for i in range(m):
            inp = (A[:, i:i + 1], to_srow(z[i])) + extra
            if have_fail:
                inp += (None if ujit is None else ujit[i],)
                carry, (lat[i], okj[i]) = step(carry, inp)
            else:
                carry, lat[i] = step(carry, inp)
        F2, busy_d, wasted_d = carry
        lat = lat.T                                           # (b, m)
        a_last = A_unit[-1] / rates                           # (b,)
        if stream:
            post = torch.arange(j0, j0 + m, device=dev) >= warm
            include = post[None, :] if okj is None else okj.T & post[None, :]
            include = include.expand(b, m)
            ua = threefry.uniform(job_row_keys(k_stat, j0, m), 1)[:, 0]
            res, _ = reservoir_update_chunk(res, cnt, lat, include, ua)
            cnt, mean, m2 = welford_merge_chunk((cnt, mean, m2), lat,
                                                include)
        ys["busy"].append(busy_d)
        ys["wasted"].append(wasted_d)
        ys["a_last"].append(a_last)
        ys["last"].append(lat[:, -1])
        if have_fail:
            # failure resolutions need not be monotone in j: track the
            # chunk-relative horizon candidate per lane
            ys["hrel"].append((A + lat).amax(dim=1))
            ys["nok"].append(okj.sum(dim=0).to(torch.float32))
        if not stream:
            ys["lat"].append(lat)
            if have_fail:
                ys["ok"].append(okj.T)
        F = F2 - a_last[:, None]
        base = base + a_last
    out = {name: (torch.cat(v, dim=1) if name in ("lat", "ok")
                  else torch.stack(v))
           for name, v in ys.items()}
    return ((cnt, mean, m2, res) if stream else None), out


# --------------------------------------------------------------------------
# On the host: replication loop, float64 reconstruction
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FleetRaw:
    """Raw per-lane outputs of a chunked run, host-side, reps stacked.

    The lane axis is reshaped back to (loads, KL); ``summarize_fleet``
    turns a KL slice of it into a ``ClusterSweep`` (the co-optimizer
    slices per assignment).  Exactly one of the exact cube (``lat``/
    ``ok``) and the streaming state (``cnt``/``mean``/``m2``/``res``)
    is populated.
    """

    loads: Tuple[float, ...]
    warmup: int
    reps: int
    num_jobs: int
    n: int
    stream: bool
    have_fail: bool
    busy: np.ndarray                 # (reps, L, KL) float64
    wasted: np.ndarray               # (reps, L, KL) float64
    horizon: np.ndarray              # (reps, L, KL) float64
    a_last: np.ndarray               # (reps, L)     float64
    lat: Optional[np.ndarray]        # (reps, L, KL, num_jobs) float64
    ok: Optional[np.ndarray]         # (reps, L, KL, num_jobs) bool
    cnt: Optional[np.ndarray]        # (reps, L, KL) int
    mean: Optional[np.ndarray]       # (reps, L, KL) float32
    m2: Optional[np.ndarray]         # (reps, L, KL) float32
    res: Optional[np.ndarray]        # (reps, L, KL, R) float32
    nok: Optional[np.ndarray]        # (reps, L, KL) float64 completions


def _shard_devices(dev: torch.device, shard: Optional[int]):
    """The devices the lane axis is split over: ``[dev]`` unsharded,
    else the first ``shard`` cards (or the host, where shard is 1)."""
    ndev = 0 if shard is None else int(shard)
    if not ndev:
        return [dev]
    avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    if not (1 <= ndev <= avail):
        raise ValueError(f"shard={ndev} needs 1..{avail} devices "
                         f"(have {avail})")
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(ndev)]


def run_fleet(scenario: Scenario, loads: Sequence[float], lanes: FleetLanes,
              *, num_jobs: int, reps: int, preempt: bool,
              cancel_overhead: float, seed: int, warmup: int, arrivals,
              speeds, failures, retry: Optional[RetryPolicy], chunk: int,
              stream: bool, reservoir: int, shard: Optional[int],
              device=DEFAULT_DEVICE) -> FleetRaw:
    """Run the chunked engine over (loads x lanes) on ``device``, one
    pass per replication, and reconstruct absolute-clock quantities in
    float64 from the per-chunk outputs.  With ``shard`` the lane axis is
    split into that many contiguous parts (the last lane duplicated up
    to a multiple, trimmed after), each run on its own card; every
    part's loop is enqueued before any result is read."""
    n = scenario.n
    if chunk < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk}")
    if reservoir < 1:
        raise ValueError(f"reservoir must be >= 1, got {reservoir}")
    dev = resolve(device)
    devices = _shard_devices(dev, shard)
    ndev = 0 if shard is None else int(shard)
    L, KL = len(loads), int(lanes.k.size)
    B = L * KL
    rates = np.repeat(np.asarray(loads, np.float32), KL)
    lk = np.tile(lanes.k.astype(np.int64), L)
    ls = np.tile(lanes.s.astype(np.int64), L)
    lr = np.tile(lanes.r.astype(np.int64), L)
    gid = np.tile(lanes.gid.astype(np.int64), (L, 1))
    pad = (-B) % max(ndev, 1)
    if pad:            # duplicate the last lane; trimmed after the run
        rates = np.concatenate([rates, np.repeat(rates[-1], pad)])
        lk, ls, lr = (np.concatenate([x, np.repeat(x[-1], pad)])
                      for x in (lk, ls, lr))
        gid = np.concatenate([gid, np.tile(gid[-1:], (pad, 1))], axis=0)
    s_max = int(ls.max())
    have_fail = retry is not None
    delta = None if scenario.delta is None else float(scenario.delta)
    _FLEET_CONFIGS.add((
        scenario.scaling, n, int(num_jobs), int(chunk), bool(preempt), retry,
        lanes.grouped, lanes.groups, bool(stream), int(reservoir), ndev,
        s_max, B + pad, type(scenario.dist).__name__,
        type(arrivals).__name__, delta is None,
        None if failures is None or not have_fail
        else int(failures.max_events), str(dev)))
    parts = np.array_split(np.arange(B + pad), len(devices))

    def on(d, x, idx):
        return torch.as_tensor(x[idx], device=d)

    acc = {k: [] for k in ("busy", "wasted", "horizon", "a_last", "lat",
                           "ok", "cnt", "mean", "m2", "res", "nok")}
    rec = _trace.active()
    rep_keys = threefry.split(threefry.key(seed, "cpu"), int(reps))
    for rep in range(int(reps)):
        t0 = rec.now() if rec is not None else 0.0
        runs = []
        for d, idx in zip(devices, parts):
            runs.append(_fleet_lanes_run(
                rep_keys[rep].to(d), d, on(d, rates, idx), on(d, lk, idx),
                on(d, ls, idx), on(d, lr, idx), on(d, gid, idx),
                torch.as_tensor(speeds, device=d), float(cancel_overhead),
                scenario.dist, arrivals, delta,
                failures if have_fail else None, int(warmup),
                scaling=scenario.scaling, n=n, num_jobs=int(num_jobs),
                chunk=int(chunk), preempt=bool(preempt), retry=retry,
                grouped=lanes.grouped, groups=lanes.groups,
                stream=bool(stream), reservoir=int(reservoir), s_max=s_max))
        # one host copy per part, after every part's loop is enqueued;
        # lanes sit on axis 1 of the per-chunk outputs, 0 of the rest
        ysn = {k: np.concatenate([r[1][k].cpu().numpy() for r in runs],
                                 axis=0 if k in ("lat", "ok") else 1)
               for k in runs[0][1]}
        ysn = {k: (v[:B] if k in ("lat", "ok") else v[:, :B])
               for k, v in ysn.items()}
        al_c = ysn["a_last"].astype(np.float64)
        a_abs = np.cumsum(al_c, axis=0)
        a_fin = a_abs[-1]                                       # (B,)
        acc["busy"].append(
            ysn["busy"].astype(np.float64).sum(0).reshape(L, KL))
        acc["wasted"].append(
            ysn["wasted"].astype(np.float64).sum(0).reshape(L, KL))
        acc["a_last"].append(a_fin.reshape(L, KL)[:, 0])
        if have_fail:
            base_before = a_abs - al_c
            horizon = (base_before + ysn["hrel"].astype(np.float64)).max(0)
            acc["nok"].append(
                ysn["nok"].astype(np.float64).sum(0).reshape(L, KL))
        else:
            horizon = a_fin + ysn["last"][-1].astype(np.float64)
        acc["horizon"].append(horizon.reshape(L, KL))
        if stream:
            cnt, mean, m2, res = (
                np.concatenate([r[0][i].cpu().numpy() for r in runs])[:B]
                for i in range(4))
            acc["cnt"].append(cnt.reshape(L, KL))
            acc["mean"].append(mean.reshape(L, KL))
            acc["m2"].append(m2.reshape(L, KL))
            acc["res"].append(res.reshape(L, KL, -1))
        else:
            acc["lat"].append(
                ysn["lat"].astype(np.float64).reshape(L, KL, num_jobs))
            if have_fail:
                acc["ok"].append(ysn["ok"].astype(bool).reshape(
                    L, KL, num_jobs))
        if rec is not None:
            # per-REPLICATION granularity, as in the JAX package (whose
            # chunk loop is inside one jit call); the port reports the
            # device where the reference reports whether it compiled
            rec.event("sweep", name="fleet", dur=rec.now() - t0,
                      rep=rep, reps=int(reps), n=n, lanes=B,
                      num_chunks=-(-int(num_jobs) // int(chunk)),
                      chunk=int(chunk), jobs=int(num_jobs),
                      stream=bool(stream), device=str(dev),
                      rss_mb=_peak_rss_mb())

    def stk(name):
        return np.stack(acc[name]) if acc[name] else None

    return FleetRaw(
        loads=tuple(float(v) for v in loads), warmup=int(warmup),
        reps=int(reps), num_jobs=int(num_jobs), n=n, stream=bool(stream),
        have_fail=have_fail, busy=stk("busy"), wasted=stk("wasted"),
        horizon=stk("horizon"), a_last=stk("a_last"), lat=stk("lat"),
        ok=stk("ok"), cnt=stk("cnt"), mean=stk("mean"), m2=stk("m2"),
        res=stk("res"), nok=stk("nok"))


def summarize_fleet(raw: FleetRaw, ks: Sequence[int],
                    kslice: Optional[slice] = None) -> ClusterSweep:
    """A KL slice of a raw chunked run -> ``ClusterSweep``.

    Exact mode feeds the UNCHANGED ``cluster_batched.summarize_sweep``
    (identical post-processing to the monolithic engine); streaming mode
    finalizes the Welford/reservoir state on the host — quantiles are
    exact whenever every replication's included-sample count fits the
    reservoir, and a uniform-sample estimate beyond that.
    """
    sl = slice(None) if kslice is None else kslice
    loads, ks = raw.loads, tuple(int(k) for k in ks)
    L, K = len(loads), len(ks)
    busy = raw.busy[:, :, sl]
    wasted = raw.wasted[:, :, sl]
    horizon = raw.horizon[:, :, sl]
    if busy.shape[2] != K:
        raise ValueError(f"kslice selects {busy.shape[2]} lanes, ks has {K}")
    if not raw.stream:
        return summarize_sweep(
            raw.lat[:, :, sl], busy, wasted, raw.a_last, loads, ks,
            raw.warmup, raw.reps, raw.num_jobs, raw.n,
            ok=None if raw.ok is None else raw.ok[:, :, sl],
            horizon=horizon)
    cnt = raw.cnt[:, :, sl].reshape(raw.reps, -1)
    tot, mean, _ = welford_finalize_host(
        cnt, raw.mean[:, :, sl].reshape(raw.reps, -1),
        raw.m2[:, :, sl].reshape(raw.reps, -1))
    R = raw.res.shape[-1]
    vals = reservoir_values_host(
        raw.res[:, :, sl].reshape(raw.reps, -1, R), cnt)
    qs = np.full((3, L * K), np.inf)
    for i, v in enumerate(vals):
        if v.size:
            qs[:, i] = np.quantile(v, [0.50, 0.95, 0.99])
    mean = np.where(tot > 0, mean, np.inf).reshape(L, K)
    if raw.have_fail:
        completions = raw.nok[:, :, sl]
        fail = (1.0 - cnt.sum(axis=0)
                / (raw.reps * (raw.num_jobs - raw.warmup))).reshape(L, K)
    else:
        completions = float(raw.num_jobs)
        fail = None
    return ClusterSweep(
        loads=loads, ks=ks, warmup=raw.warmup, reps=raw.reps, mean=mean,
        p50=qs[0].reshape(L, K), p95=qs[1].reshape(L, K),
        p99=qs[2].reshape(L, K),
        utilization=(busy / (raw.n * horizon)).mean(axis=0),
        wasted_frac=(wasted / np.maximum(busy, 1e-12)).mean(axis=0),
        throughput=(completions / horizon).mean(axis=0),
        failure_rate=fail)


def trim_raw_loads(raw: FleetRaw, num_loads: int) -> FleetRaw:
    """Drop bucket-padded load rows (the surface cache pads the load
    axis; lanes are independent, so trimming after the run is exact)."""
    def cut(x):
        return None if x is None else x[:, :num_loads]

    return dataclasses.replace(
        raw, loads=raw.loads[:num_loads], busy=cut(raw.busy),
        wasted=cut(raw.wasted), horizon=cut(raw.horizon),
        a_last=cut(raw.a_last), lat=cut(raw.lat), ok=cut(raw.ok),
        cnt=cut(raw.cnt), mean=cut(raw.mean), m2=cut(raw.m2),
        res=cut(raw.res), nok=cut(raw.nok))


# --------------------------------------------------------------------------
# Public entry point
# --------------------------------------------------------------------------

def fleet_sweep(scenario: Scenario, loads: Sequence[float],
                ks: Optional[Sequence[int]] = None, num_jobs: int = 1000,
                reps: int = 1, preempt: bool = True,
                cancel_overhead: float = 0.0, seed: int = 0,
                warmup: Optional[int] = None,
                retry: Optional[RetryPolicy] = None,
                assignment: Optional[Assignment] = None, *,
                chunk_size: Optional[int] = None, stream: bool = False,
                reservoir: int = 4096,
                shard: Optional[int] = None,
                device=DEFAULT_DEVICE) -> ClusterSweep:
    """``cluster_batched.sweep`` semantics on the chunked engine, on
    ``device`` (default ``"cuda"``; pass ``device="cpu"`` for the host).

    ``chunk_size`` bounds the in-flight job window (None -> one chunk
    for small traces, <= 512 at scale); ``stream=True`` replaces the
    exact latency cube with the bounded-memory Welford + reservoir
    statistics (``reservoir`` samples per lane); ``shard`` splits the
    lane axis over that many cards (None/0 = one device, identical
    results).  The chunk size and shard count are performance knobs, not
    semantics: any chunking draws the bit-identical sample path.
    """
    n = scenario.n
    ks, loads, warmup, arrivals, speeds = validate_sweep_args(
        scenario, loads, ks, num_jobs, reps, warmup)
    failures, retry = resolve_failure_args(scenario, retry)
    lanes = build_fleet_lanes(assignment, n, ks, scenario.worker_speeds)
    chunk = default_chunk(num_jobs) if chunk_size is None else int(chunk_size)
    raw = run_fleet(scenario, loads, lanes, num_jobs=int(num_jobs),
                    reps=int(reps), preempt=bool(preempt),
                    cancel_overhead=float(cancel_overhead), seed=int(seed),
                    warmup=warmup, arrivals=arrivals, speeds=speeds,
                    failures=failures, retry=retry, chunk=chunk,
                    stream=bool(stream), reservoir=int(reservoir),
                    shard=shard, device=device)
    return summarize_fleet(raw, ks)
