"""(k, assignment) co-optimization: one engine call for the whole grid.

``runtime.cluster_batched.sweep`` already folds every (load, k) queueing
cell of ONE placement into a single engine call.  Placement adds a third
axis — and because the grouped lanes take their rank/mask arrays as DATA
with only the max group count fixed, the assignment axis can ride the
SAME lane dimension: ``co_sweep`` flattens the A x K (assignment, k) grid
into one extended k-lane axis and runs the entire (loads x A x K) surface
through one ``_sweep_core`` call.

CRN discipline: task size s = n/k is independent of the grouping, so
every assignment lane at the same k consumes the IDENTICAL service
table — the placement comparison is exactly paired, and the argmin over
(k, assignment) is a within-sample decision, not a noise race.

``backend="oracle"`` is the validation twin: one discrete-event sweep
per assignment, same summaries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .._device import DEFAULT_DEVICE, generator, resolve
from ..core.policy import RetryPolicy
from ..core.scenario import Scenario
from .strategies import AllWorkers, Assignment, group_ids_matrix

__all__ = ["AssignmentSurface", "co_sweep"]


@dataclasses.dataclass
class AssignmentSurface:
    """The (loads x ks) surface per assignment, plus joint argmins.

    ``sweeps[i]`` is the full ``ClusterSweep`` of ``assignments[i]`` —
    every per-placement metric (mean/p95/utilization/...) is available
    exactly as from a single-assignment sweep; this object adds the
    CO-optimized views across the placement axis.
    """

    assignments: Tuple[Assignment, ...]
    sweeps: Tuple["ClusterSweep", ...]  # noqa: F821 — runtime import

    @property
    def loads(self) -> Tuple[float, ...]:
        return self.sweeps[0].loads

    @property
    def ks(self) -> Tuple[int, ...]:
        return self.sweeps[0].ks

    def sweep_for(self, assignment: Optional[Assignment]):
        """The ``ClusterSweep`` of one strategy (None = AllWorkers)."""
        a = AllWorkers() if assignment is None else assignment
        for cand, sw in zip(self.assignments, self.sweeps):
            if cand == a:
                return sw
        raise KeyError(f"{a!r} is not on this surface "
                       f"(assignments: {self.assignments})")

    def metric(self, name: str) -> np.ndarray:
        """The stacked (A, L, K) metric cube."""
        return np.stack([sw.metric(name) for sw in self.sweeps])

    def min_curve(self, load_idx: int = 0, metric: str = "mean"
                  ) -> Dict[int, float]:
        """k -> best-over-assignments metric at one load: the envelope
        the planner's objective actually sees once placement is free."""
        cube = self.metric(metric)[:, load_idx, :]        # (A, K)
        return {int(k): float(v) for k, v in zip(self.ks, cube.min(axis=0))}

    def kstar(self, metric: str = "mean"
              ) -> Dict[float, object]:
        """load -> jointly optimal (k, assignment).

        Ties resolve to the earliest assignment in ``assignments`` and,
        within it, the smallest k (ks are ascending) — so AllWorkers
        first in the list means "prefer the paper's dispatch unless a
        placement strictly wins".  A load whose whole (A, K) slab is
        non-finite (every cell the all-failed ``np.inf`` sentinel) maps
        to ``runtime.cluster_batched.Infeasible`` instead of a bogus
        first-cell argmin.
        """
        from ..runtime.cluster_batched import Infeasible
        cube = self.metric(metric)                        # (A, L, K)
        out: Dict[float, object] = {}
        for i, lam in enumerate(self.loads):
            slab = cube[:, i, :]
            if not np.any(np.isfinite(slab)):
                out[float(lam)] = Infeasible(load=float(lam), metric=metric)
                continue
            flat = int(np.argmin(slab))                   # first min wins
            a, j = divmod(flat, len(self.ks))
            out[float(lam)] = (int(self.ks[j]), self.assignments[a])
        return out


def _resolved(assignments: Sequence[Optional[Assignment]]
              ) -> Tuple[Assignment, ...]:
    out = []
    for a in assignments:
        a = AllWorkers() if a is None else a
        if not isinstance(a, Assignment):
            raise TypeError(f"assignments must be Assignment strategies "
                            f"(or None), got {a!r}")
        out.append(a)
    if not out:
        raise ValueError("co_sweep needs at least one assignment")
    return tuple(out)


def co_sweep(scenario: Scenario, loads: Sequence[float],
             assignments: Sequence[Optional[Assignment]],
             ks: Optional[Sequence[int]] = None, num_jobs: int = 1000,
             reps: int = 1, preempt: bool = True,
             cancel_overhead: float = 0.0, seed: int = 0,
             warmup: Optional[int] = None,
             retry: Optional[RetryPolicy] = None,
             backend: str = "batched", chunk_size: Optional[int] = None,
             stream: bool = False, reservoir: int = 4096,
             shard: Optional[int] = None,
             device=DEFAULT_DEVICE) -> AssignmentSurface:
    """Every (load, k, assignment) cell — batched in ONE engine call on
    ``device`` (default ``"cuda"``; pass ``device="cpu"`` for the host).

    The A x K grid flattens into the engine's k-lane axis: ``ks`` tiled
    A times as the lane tuple, the per-lane within-group ranks and
    (num_jobs, n) placement masks concatenated as data, and the single
    group count taken as the max over the grid (lanes with fewer groups
    pad with empty rows the lanes mask out).  Each assignment must be
    legal for every k in ``ks`` (g | k and g | n).

    ``backend="oracle"`` runs one discrete-event sweep per assignment.
    ``backend="cached"`` (the compiled-surface cache) and the chunked
    knobs ``chunk_size`` / ``stream`` / ``shard`` (with ``reservoir``)
    belong to the fleet slice of the port, which is not in yet: they
    raise ``NotImplementedError``.
    """
    from ..runtime.cluster_batched import _chunked_not_ported
    assignments = _resolved(assignments)
    chunked = chunk_size is not None or stream or shard is not None
    if chunked and backend == "oracle":
        raise ValueError("chunk_size/stream/shard are batched-engine "
                         "knobs; backend='oracle' does not take them")
    if backend == "oracle":
        from ..runtime.cluster_oracle import sweep_oracle
        sweeps = tuple(
            sweep_oracle(scenario, loads, ks=ks, num_jobs=num_jobs,
                         reps=reps, preempt=preempt,
                         cancel_overhead=cancel_overhead, seed=seed,
                         warmup=warmup, retry=retry, assignment=a,
                         device=device)
            for a in assignments)
        return AssignmentSurface(assignments=assignments, sweeps=sweeps)
    if backend == "cached":
        raise NotImplementedError(
            "backend='cached' (the compiled-surface cache) is not ported "
            "yet: it comes with the next slice; use 'batched' or 'oracle'")
    if backend != "batched":
        raise ValueError(f"backend must be 'batched', 'cached', or "
                         f"'oracle', got {backend!r}")
    _chunked_not_ported(chunk_size, stream, shard)

    from ..runtime.cluster_batched import (_host, _sweep_core,
                                           resolve_failure_args,
                                           summarize_sweep,
                                           validate_sweep_args)

    dev = resolve(device)
    n = scenario.n
    ks, loads, warmup, arrivals, speeds = validate_sweep_args(
        scenario, loads, ks, num_jobs, reps, warmup)
    failures, retry = resolve_failure_args(scenario, retry)
    K, A = len(ks), len(assignments)

    # -- flatten the (assignment, k) grid into one lane axis ---------------
    rs, gids, gmax = [], [], 1
    for a in assignments:
        for k in ks:
            g, r, gid = group_ids_matrix(a, n, k, int(num_jobs),
                                         scenario.worker_speeds)
            gmax = max(gmax, g)
            rs.append(r)
            gids.append(gid)
    out = _host(_sweep_core(
        generator(seed, dev), np.asarray(loads, np.float32), speeds,
        float(cancel_overhead), scenario.dist, scenario.scaling, n,
        tuple(ks) * A, int(num_jobs), int(reps), bool(preempt), arrivals,
        None if scenario.delta is None else float(scenario.delta),
        failures, retry, gmax, np.asarray(rs, np.int64), np.stack(gids)))
    if retry is None:
        lat, busy, wasted, a_last = out
        ok = horizon = None
    else:
        lat, busy, wasted, a_last, ok, horizon = out

    # -- slice the flattened lane axis back into per-assignment surfaces ---
    sweeps = []
    for ai in range(A):
        c = slice(ai * K, (ai + 1) * K)
        sweeps.append(summarize_sweep(
            lat[:, :, c, :], busy[:, :, c], wasted[:, :, c], a_last,
            loads, ks, warmup, reps, num_jobs, n,
            ok=None if ok is None else ok[:, :, c, :],
            horizon=None if horizon is None else horizon[:, :, c]))
    return AssignmentSurface(assignments=assignments, sweeps=tuple(sweeps))
