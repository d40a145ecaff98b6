"""Partition specs (the reference's ``jax.sharding.PartitionSpec`` and
``NamedSharding``), with no dependencies: the models and the optimizer
describe their placement with them, and ``launch.mesh`` resolves them
against a mesh."""
from __future__ import annotations

import dataclasses
from typing import Any


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): one element a
    dimension, each ``None`` (replicated), a mesh axis name, or a tuple of
    names (sharded over their product, the first axis major)."""

    def __new__(cls, *elems):
        return super().__new__(cls, elems)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``); ``mesh`` is
    a ``launch.mesh.Mesh``."""
    mesh: Any
    spec: P
