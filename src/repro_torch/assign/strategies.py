"""Task-to-worker assignment strategies: WHICH workers race WHICH sub-tasks.

The paper's dispatch fans every job's n tasks to all n workers and takes
the k-th order statistic.  At fleet scale that is one point in a larger
placement space (Behrouzi-Far & Soljanin, arXiv:1808.02838 /
2006.02318): partition the n workers into g *replication groups* of
c = n/g workers, give each group k/g of the job's k sub-tasks (MDS-coded
within the group), and the job completes when EVERY group has delivered
its share::

    D_i = (k/g)-th smallest finish within group i      (r = k/g)
    D   = max_i D_i

g = 1 recovers the k-th-smallest-over-all-workers rule exactly; g = k is
pure fractional-repetition placement (per-group min, max over the k
groups).  Task size stays s = n/k for every g, so CRN service tables are
shared across strategies and placement comparisons are exactly paired.

Strategies here are frozen, hashable *descriptions*; the heavy lifting
(masks as data, order statistics) lives in the engines.  This module
imports only numpy so ``core.policy`` can depend on it without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "AllWorkers",
    "Assignment",
    "GroupLanes",
    "RandomGroups",
    "ReplicationGroups",
    "RoundRobin",
    "SpeedAware",
    "build_lanes",
    "group_ids_matrix",
    "is_all_workers",
]


def _check_divisible(n: int, k: int, g: int) -> None:
    if g < 1 or g > k:
        raise ValueError(f"groups g={g} must satisfy 1 <= g <= k={k}")
    if k % g != 0:
        raise ValueError(f"g={g} must divide k={k} (k/g sub-tasks per group)")
    if n % g != 0:
        raise ValueError(f"g={g} must divide n={n} (n/g workers per group)")


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Base class: how a job's n coded tasks map onto the n workers.

    Subclasses are frozen dataclasses so they hash, compare, and embed in
    ``Policy``.  The contract:

    - ``num_groups(n, k)``  -> g (1 <= g <= k, g | k, g | n)
    - ``group_ids(n, k, num_jobs, speeds)`` -> int32 (num_jobs, n) array
      mapping worker -> group per job, or None for the legacy
      all-workers fast path
    - ``cache_signature(n, ks)`` -> hashable structural key: two
      strategies with the same signature share a compiled executable
      (masks are traced data, group COUNT is static)
    """

    def num_groups(self, n: int, k: int) -> int:
        return 1

    def validate(self, n: int, k: int) -> None:
        _check_divisible(n, k, self.num_groups(n, k))

    def group_ids(self, n: int, k: int, num_jobs: int,
                  speeds: Optional[Tuple[float, ...]] = None
                  ) -> Optional[np.ndarray]:
        raise NotImplementedError

    def cache_signature(self, n: int, ks: Tuple[int, ...]) -> tuple:
        gs = tuple(self.num_groups(n, k) for k in ks)
        return (type(self).__name__, gs, self.per_job())

    def per_job(self) -> bool:
        """True when masks genuinely vary per job (random placement)."""
        return False


def _grouped_g(g: Optional[int], k: int) -> int:
    return k if g is None else int(g)


@dataclasses.dataclass(frozen=True)
class AllWorkers(Assignment):
    """Every task races on every worker — the paper's dispatch, verbatim.

    This is the backward-compatible default: it resolves to the legacy
    (ungrouped) engine path, so results are bit-for-bit identical to an
    ``assignment=None`` run.
    """

    def num_groups(self, n: int, k: int) -> int:
        return 1

    def validate(self, n: int, k: int) -> None:  # always legal
        return None

    def group_ids(self, n, k, num_jobs, speeds=None):
        return None

    def cache_signature(self, n, ks):
        return None


@dataclasses.dataclass(frozen=True)
class ReplicationGroups(Assignment):
    """Contiguous replication groups: workers [0..c), [c..2c), ...

    ``g=None`` defaults to g=k — one group per sub-task, size n/k, the
    fractional-repetition layout of 1808.02838.
    """

    g: Optional[int] = None

    def num_groups(self, n, k):
        return _grouped_g(self.g, k)

    def group_ids(self, n, k, num_jobs, speeds=None):
        g = self.num_groups(n, k)
        row = (np.arange(n, dtype=np.int32) // (n // g)).astype(np.int32)
        return np.broadcast_to(row, (num_jobs, n))


@dataclasses.dataclass(frozen=True)
class RoundRobin(Assignment):
    """Strided placement: worker w joins group w mod g.

    Under block-structured heterogeneity (slow machines adjacent in
    index), striding spreads slow workers one-per-group, so no group's
    order statistic is dominated by two stragglers.  Per-job rotation of
    the stride is a provable no-op (max-over-groups is invariant to
    group relabelling), so the mask is static.
    """

    g: Optional[int] = None

    def num_groups(self, n, k):
        return _grouped_g(self.g, k)

    def group_ids(self, n, k, num_jobs, speeds=None):
        g = self.num_groups(n, k)
        row = (np.arange(n, dtype=np.int32) % g).astype(np.int32)
        return np.broadcast_to(row, (num_jobs, n))


@dataclasses.dataclass(frozen=True)
class RandomGroups(Assignment):
    """Balanced uniform-random partition, redrawn per job (CRN-keyed).

    The strategy carries its OWN seed, exogenous to the sweep seed:
    two sweeps with different service seeds see the SAME placement
    sequence, and the placement race (random vs round-robin) stays
    exactly CRN-paired on service draws.
    """

    g: Optional[int] = None
    seed: int = 0

    def num_groups(self, n, k):
        return _grouped_g(self.g, k)

    def per_job(self):
        return True

    def group_ids(self, n, k, num_jobs, speeds=None):
        g = self.num_groups(n, k)
        base = np.arange(n, dtype=np.int32) % g  # balanced template
        rng = np.random.default_rng(
            np.random.SeedSequence([0x5EED, int(self.seed), n, k]))
        # one permutation per job, vectorized as argsort of uniforms
        # (re-plans regenerate masks; a python loop over jobs dominated
        # warm re-plan latency)
        perm = np.argsort(rng.random((num_jobs, n)), axis=1)
        return base[perm].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SpeedAware(Assignment):
    """Pack the slowest workers into the same groups (sorted blocks).

    Workers are sorted by speed multiplier DESCENDING (larger multiplier
    = slower: task time is multiplied by it) and cut into contiguous
    groups, so stragglers concentrate in few groups instead of poisoning
    every group's order statistic.  ``speeds=None`` falls back to
    ``Scenario.worker_speeds`` at resolution time (identity if unset);
    use :meth:`with_speeds` to inject measured estimates from
    ``Telemetry.worker_speed_stats()``.
    """

    g: Optional[int] = None
    speeds: Optional[Tuple[float, ...]] = None

    def num_groups(self, n, k):
        return _grouped_g(self.g, k)

    def with_speeds(self, speeds) -> "SpeedAware":
        return dataclasses.replace(
            self, speeds=tuple(float(s) for s in speeds))

    def group_ids(self, n, k, num_jobs, speeds=None):
        g = self.num_groups(n, k)
        sp = self.speeds if self.speeds is not None else speeds
        if sp is None:
            sp = (1.0,) * n
        if len(sp) != n:
            raise ValueError(
                f"SpeedAware needs {n} worker speeds, got {len(sp)}")
        # stable sort, slowest (largest multiplier) first -> they share
        # the leading contiguous groups
        order = np.argsort(-np.asarray(sp, dtype=np.float64), kind="stable")
        row = np.empty(n, dtype=np.int32)
        row[order] = np.arange(n, dtype=np.int32) // (n // g)
        return np.broadcast_to(row, (num_jobs, n))

    def cache_signature(self, n, ks):
        # speeds are traced data (they only permute the mask); the
        # executable depends on the group structure alone, so a placement
        # re-plan with fresh measured speeds hits the warm compile.
        gs = tuple(self.num_groups(n, k) for k in ks)
        return ("SpeedAware", gs, False)


def is_all_workers(assignment: Optional[Assignment]) -> bool:
    """True when the strategy resolves to the legacy all-workers path."""
    return assignment is None or isinstance(assignment, AllWorkers)


def group_ids_matrix(assignment: Assignment, n: int, k: int, num_jobs: int,
                     speeds: Optional[Tuple[float, ...]] = None
                     ) -> Tuple[int, int, np.ndarray]:
    """Resolve one (n, k) cell: returns (g, r, gid) with gid (num_jobs, n).

    Both engines call this, so batched lanes and the DES oracle walk the
    SAME placement — masks are part of the CRN contract.
    """
    assignment.validate(n, k)
    g = assignment.num_groups(n, k)
    gid = assignment.group_ids(n, k, num_jobs, speeds)
    if gid is None:  # AllWorkers: one group, rank k
        gid = np.zeros((num_jobs, n), dtype=np.int32)
        return 1, k, gid
    return g, k // g, np.ascontiguousarray(gid, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class GroupLanes:
    """Per-sweep lane bundle: static group count + traced rank/mask data.

    ``groups`` is the max group count over the k lanes (static: it sets
    array shapes in the kernel); lanes with fewer groups pad with empty
    group rows, masked out of the max.  ``r`` is the per-lane within-
    group completion rank k/g; ``gid`` maps (lane, job, worker) -> group.
    """

    groups: int                 # static G_max
    r: np.ndarray               # (K,) int32
    gid: np.ndarray             # (K, num_jobs, n) int32
    signature: tuple            # structural cache key


def build_lanes(assignment: Optional[Assignment], n: int,
                ks: Tuple[int, ...], num_jobs: int,
                speeds: Optional[Tuple[float, ...]] = None
                ) -> Optional[GroupLanes]:
    """Resolve a strategy into the batched engine's lane bundle.

    Returns None for the legacy all-workers path (engines then run the
    untouched ungrouped kernels).
    """
    if is_all_workers(assignment):
        return None
    rs, gids, gmax = [], [], 1
    for k in ks:
        g, r, gid = group_ids_matrix(assignment, n, k, num_jobs, speeds)
        gmax = max(gmax, g)
        rs.append(r)
        gids.append(gid)
    return GroupLanes(
        groups=gmax,
        r=np.asarray(rs, dtype=np.int32),
        gid=np.stack(gids).astype(np.int32),
        signature=assignment.cache_signature(n, tuple(ks)),
    )
