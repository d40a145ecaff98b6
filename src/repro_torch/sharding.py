"""Partition specs (the reference's ``jax.sharding.PartitionSpec`` and
``NamedSharding``), with no dependencies: the models and the optimizer
describe their placement with them, and ``launch.mesh`` resolves them
against a mesh.

``local_block`` and ``shard_shape`` resolve a spec on a mesh for one
rank: along each dimension, block ``i`` of the product of the spec
element's axis sizes, ``i`` the rank's coordinate over those axes with
the first axis major (GSPMD's layout).  A mesh here is anything with
``axis_names``, ``sizes`` and ``coordinate()`` (``launch.mesh.Mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple


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


def axes_of(elem) -> Tuple[str, ...]:
    """The axis names of one spec element."""
    if elem is None:
        return ()
    return (elem,) if isinstance(elem, str) else tuple(elem)


def _parts(mesh, elem) -> Tuple[int, int]:
    """(this rank's block index, the number of blocks) along a dimension
    sharded by ``elem``."""
    coord = dict(zip(mesh.axis_names, mesh.coordinate()))
    index, parts = 0, 1
    for a in axes_of(elem):
        index = index * mesh.sizes[a] + coord[a]
        parts *= mesh.sizes[a]
    return index, parts


def local_rows(mesh, elem, size: int) -> slice:
    """This rank's contiguous part of a dimension of ``size`` sharded by
    the spec element ``elem``; raises ``ValueError`` where the axes'
    product does not divide ``size`` (GSPMD refuses such an input)."""
    index, parts = _parts(mesh, elem)
    if size % parts:
        raise ValueError(f"{size} rows do not split over {elem!r} "
                         f"({parts} parts)")
    n = size // parts
    return slice(index * n, (index + 1) * n)


def _elems(spec: Optional[Sequence], ndim: int) -> Tuple[Any, ...]:
    """``spec``'s elements padded with None to ``ndim`` (a missing spec or
    a short one replicates the rest, as JAX's)."""
    elems = tuple(spec or ())
    if len(elems) > ndim:
        raise ValueError(f"spec {spec!r} has more elements than the "
                         f"{ndim} dimensions of its tensor")
    return elems + (None,) * (ndim - len(elems))


def local_block(mesh, spec, shape) -> Tuple[slice, ...]:
    """The slices of this rank's block of a global tensor of ``shape``
    placed by ``spec`` (no mesh: the whole tensor)."""
    if mesh is None:
        return tuple(slice(0, n) for n in shape)
    return tuple(local_rows(mesh, e, n)
                 for e, n in zip(_elems(spec, len(shape)), shape))


def shard_shape(mesh, spec, shape) -> Tuple[int, ...]:
    """The shape of this rank's block (the reference's
    ``NamedSharding.shard_shape``)."""
    return tuple(s.stop - s.start for s in local_block(mesh, spec, shape))


def replicas(mesh, spec) -> int:
    """How many ranks of ``mesh`` hold the same block of a tensor placed
    by ``spec``."""
    sharded = 1
    for e in spec or ():
        for a in axes_of(e):
            sharded *= mesh.sizes[a]
    return mesh.size // sharded
