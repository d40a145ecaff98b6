"""Surface cache: the (loads x ks) queueing surfaces of the control loop's
steady-state re-plans, keyed by their structure.

In the JAX package ``cluster_batched.sweep`` compiles the distribution
and arrival parameters into its executable, so this module runs the same
lane grid through a jit whose parameters are TRACED and keys the warm
executable on the surface's structure.  The port compiles nothing: every
surface is a fresh loop of PyTorch operations, and a re-plan with fresh
fitted floats costs what the first call cost.  What this module keeps is
the contract the control loop reads:

  * the structural key ``(service family, scaling, n, k-grid, load-grid
    bucket, num_jobs, reps, preempt, arrival family, delta presence,
    failure events, retry, placement signature[, chunk knobs])`` —
    never the fitted values — with a hit/miss count per lookup
    (``record_cache_key``) on the metrics plane under the reference's
    names (``surface_cache.hits`` / ``.misses``; a miss's wall time on the
    ``surface_cache.compile_ms`` histogram), and the flight recorder's
    ``cache_hit`` / ``cache_miss`` / ``compile`` events;
  * the load-axis bucket padding (``load_bucket``): the load grid is
    padded up to a fixed length with the last load repeated and trimmed
    after the run.  It is exact: the monolithic engine draws arrivals
    once across loads and only the rate sweeps, so a padded lane changes
    no other lane's draws.

``cached_sweep`` mirrors ``cluster_batched.sweep``'s signature and is
dispatchable as ``backend="cached"`` (``runtime.cluster.
resolve_sweep_backend``, ``api.LoadAwareLatency``).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from .._device import DEFAULT_DEVICE, generator, resolve
from ..assign.strategies import Assignment, build_lanes
from ..core.policy import RetryPolicy
from ..core.scenario import Scenario
from ..obs import metrics as _metrics
from ..obs import recorder as _trace
from .cluster_batched import (ClusterSweep, _host, _lane_args, _sweep_core,
                              resolve_failure_args, summarize_sweep,
                              validate_sweep_args)

__all__ = ["cached_sweep", "load_bucket", "record_cache_key",
           "reset_surface_cache_stats", "surface_cache_stats"]

#: Load-grid lengths are padded up to one of these (ascending).
_LOAD_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

#: Hit/miss accounting lives on the metrics plane (``obs.metrics``);
#: the key registry stays module-local.
_C_HITS = _metrics.REGISTRY.counter("surface_cache.hits")
_C_MISSES = _metrics.REGISTRY.counter("surface_cache.misses")
_H_COMPILE_MS = _metrics.REGISTRY.hist("surface_cache.compile_ms")
_KEYS: Dict[tuple, int] = {}


def load_bucket(num_loads: int) -> int:
    """The padded load-axis length for a requested grid size."""
    for b in _LOAD_BUCKETS:
        if num_loads <= b:
            return b
    raise ValueError(
        f"load grid of {num_loads} exceeds the largest bucket "
        f"{_LOAD_BUCKETS[-1]}; call cluster_batched.sweep directly")


def surface_cache_stats() -> dict:
    """Hit/miss accounting of the surface cache: a MISS is a call whose
    structural key has not been seen yet this process (the JAX package
    pays its XLA trace there), a HIT one whose key has.  (Backed by the
    ``surface_cache.hits``/``.misses`` counters of
    ``obs.metrics.REGISTRY``.)"""
    return {"hits": _C_HITS.value, "misses": _C_MISSES.value,
            "entries": len(_KEYS)}


def reset_surface_cache_stats() -> None:
    """Zero the hit/miss counters.  The key registry is kept, as the JAX
    package keeps its warm executables: a post-reset call on a seen key
    still counts as a hit."""
    _C_HITS.reset()
    _C_MISSES.reset()


def record_cache_key(cache_key: tuple) -> bool:
    """Count one cache lookup; True when the key was already seen.
    Shared by ``cached_sweep`` and the co-optimizing assignment surface
    (``assign.surface.co_sweep``), which builds its own flattened key.
    Each lookup also lands on the flight recorder (``cache_hit`` /
    ``cache_miss``) when one is installed."""
    warm = cache_key in _KEYS
    if warm:
        _C_HITS.inc()
        _KEYS[cache_key] += 1
    else:
        _C_MISSES.inc()
        _KEYS[cache_key] = 1
    rec = _trace.active()
    if rec is not None:
        rec.event("cache_hit" if warm else "cache_miss",
                  name="surface_cache", family=str(cache_key[0]),
                  key=str(cache_key))
    return warm


def _record_surface_call(warm: bool, wall_ms: float, which: str) -> None:
    """Metrics + trace for one surface call: a MISS's wall time lands on
    the ``compile_ms`` histogram and a ``compile`` event (the name the
    reference gives it; here it is the first call's whole wall time); a
    HIT stays metrics-only."""
    if not warm:
        _H_COMPILE_MS.update(wall_ms)
        rec = _trace.active()
        if rec is not None:
            rec.event("compile", name=which, wall_ms=wall_ms)


def _padded_loads(loads: Sequence[float]) -> tuple:
    """``loads`` padded to its bucket with the last load repeated."""
    loads = tuple(loads)
    return loads + (loads[-1],) * (load_bucket(len(loads)) - len(loads))


def _cached_fleet(scenario, loads, ks, num_jobs, reps, preempt,
                  cancel_overhead, seed, warmup, arrivals, speeds, failures,
                  retry, assignment, chunk_size, stream, reservoir, shard,
                  device):
    """The chunked engine behind the cache facade: bucket-pad the load
    axis, record the structural key, trim after the run."""
    from .fleet import (build_fleet_lanes, default_chunk, run_fleet,
                        summarize_fleet, trim_raw_loads)
    n = scenario.n
    lanes = build_fleet_lanes(assignment, n, ks, scenario.worker_speeds)
    chunk = default_chunk(num_jobs) if chunk_size is None else int(chunk_size)
    padded = _padded_loads(loads)
    warm = record_cache_key(
        ("fleet", type(scenario.dist).__name__, scenario.scaling.value, n,
         ks, len(padded), int(num_jobs), int(reps), bool(preempt),
         type(arrivals).__name__, scenario.delta is None,
         None if failures is None else int(failures.max_events), retry,
         lanes.signature, chunk, bool(stream), int(reservoir),
         0 if shard is None else int(shard)))
    t0 = time.perf_counter()
    raw = run_fleet(scenario, padded, lanes, num_jobs=int(num_jobs),
                    reps=int(reps), preempt=bool(preempt),
                    cancel_overhead=float(cancel_overhead), seed=int(seed),
                    warmup=warmup, arrivals=arrivals, speeds=speeds,
                    failures=failures, retry=retry, chunk=chunk,
                    stream=bool(stream), reservoir=int(reservoir),
                    shard=shard, device=device)
    _record_surface_call(warm, (time.perf_counter() - t0) * 1e3,
                         "cached_fleet")
    return summarize_fleet(trim_raw_loads(raw, len(loads)), ks)


def cached_sweep(scenario: Scenario, loads: Sequence[float],
                 ks: Optional[Sequence[int]] = None, num_jobs: int = 1000,
                 reps: int = 1, preempt: bool = True,
                 cancel_overhead: float = 0.0, seed: int = 0,
                 warmup: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 assignment: Optional[Assignment] = None,
                 chunk_size: Optional[int] = None, stream: bool = False,
                 reservoir: int = 4096,
                 shard: Optional[int] = None,
                 device=DEFAULT_DEVICE) -> ClusterSweep:
    """``cluster_batched.sweep`` through the surface cache, on ``device``
    (default ``"cuda"``; pass ``device="cpu"`` for the host).

    Same semantics, draws and CRN discipline — the same numbers as the
    uncached call: the load axis is bucket-padded and trimmed back, and
    the call is counted under its structural key (the placement by its
    ``Assignment.cache_signature``, a failure model by its event count
    and the ``retry`` policy).  Any of ``chunk_size`` / ``stream`` /
    ``shard`` routes through the chunked fleet engine
    (``runtime.fleet``), with the chunk size, streaming mode, reservoir
    capacity and shard count joining the key.
    """
    dev = resolve(device)
    n = scenario.n
    ks, loads, warmup, arrivals, speeds = validate_sweep_args(
        scenario, loads, ks, num_jobs, reps, warmup)
    failures, retry = resolve_failure_args(scenario, retry)
    if chunk_size is not None or stream or shard is not None:
        return _cached_fleet(scenario, loads, ks, num_jobs, reps, preempt,
                             cancel_overhead, seed, warmup, arrivals,
                             speeds, failures, retry, assignment,
                             chunk_size, stream, reservoir, shard, dev)
    lanes = build_lanes(assignment, n, ks, int(num_jobs),
                        scenario.worker_speeds)
    L = len(loads)
    padded = _padded_loads(loads)
    warm = record_cache_key(
        (type(scenario.dist).__name__, scenario.scaling.value, n,
         ks, len(padded), int(num_jobs), int(reps), bool(preempt),
         type(arrivals).__name__, scenario.delta is None,
         None if failures is None else int(failures.max_events),
         retry, None if lanes is None else lanes.signature))

    rec = _trace.active()
    t_rec = rec.now() if rec is not None else 0.0
    t0 = time.perf_counter()
    out = _host(_sweep_core(
        generator(seed, dev), np.asarray(padded, np.float32), speeds,
        float(cancel_overhead), scenario.dist, scenario.scaling, n, ks,
        int(num_jobs), int(reps), bool(preempt), arrivals,
        None if scenario.delta is None else float(scenario.delta),
        failures, retry, *_lane_args(lanes)))
    _record_surface_call(warm, (time.perf_counter() - t0) * 1e3,
                         "cached_sweep")
    if rec is not None:
        # every engine call names its device on the trace (the fleet and
        # batched engines do too), so a run report shows where the
        # surfaces ran
        rec.event("sweep", name="cached", dur=rec.now() - t_rec,
                  n=n, num_jobs=int(num_jobs), reps=int(reps),
                  lanes=len(padded) * len(ks), device=str(dev))

    # trim the padded lanes before aggregation: lanes are independent and
    # share their draws, so the surviving cells are the unpadded call's
    if retry is None:
        lat, busy, wasted, a_last = out
        ok = horizon = None
    else:
        lat, busy, wasted, a_last, ok, horizon = out
        ok, horizon = ok[:, :L], horizon[:, :L]
    return summarize_sweep(lat[:, :L], busy[:, :L], wasted[:, :L],
                           a_last[:, :L], loads, ks, warmup, reps, num_jobs,
                           n, ok=ok, horizon=horizon)
