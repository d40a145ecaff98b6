"""Task-to-worker assignment: replication groups as a policy axis.

Strategies (`AllWorkers`, `ReplicationGroups`, `RoundRobin`,
`RandomGroups`, `SpeedAware`) are import-light and re-exported eagerly;
the sweep-surface helpers (`co_sweep`, `AssignmentSurface`) pull in the
batched engine, which imports ``core.policy``, which imports THIS
package — so they load lazily (PEP 562) to keep the import graph
acyclic.
"""
from .strategies import (AllWorkers, Assignment, GroupLanes, RandomGroups,
                         ReplicationGroups, RoundRobin, SpeedAware,
                         build_lanes, group_ids_matrix, is_all_workers)

__all__ = [
    "AllWorkers",
    "Assignment",
    "AssignmentSurface",
    "GroupLanes",
    "RandomGroups",
    "ReplicationGroups",
    "RoundRobin",
    "SpeedAware",
    "build_lanes",
    "co_sweep",
    "group_ids_matrix",
    "is_all_workers",
]

_LAZY = {"co_sweep": "surface", "AssignmentSurface": "surface"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
