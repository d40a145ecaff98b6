"""Device meshes (a port of the JAX package's ``launch/mesh.py``).

Axes:
  single-pod : (data=16, model=16)            = 256 ranks
  multi-pod  : (pod=2, data=16, model=16)     = 512 ranks

``data``  -- batch (data parallelism); the paper's n redundancy workers
             are contiguous slices of it.
``model`` -- tensor parallelism: attention heads, FFN columns, experts,
             SSM heads and inner channels, and vocab.
``pod``   -- pure data parallelism across pods.

One process is one rank is one device.  A ``Mesh`` is PyTorch's
``DeviceMesh`` over the process group's ranks, seen as the reference's
``jax.sharding.Mesh``: its axis names, its shape, this rank's device and
its coordinate, and a process group for each axis and for the batch
axes together (``group``).  A ``Mesh`` built without a ``DeviceMesh`` is a mesh of
names and sizes only (the reference's ``AbstractMesh``): specs resolve
against it, nothing runs on it.  ``named`` pairs each partition spec
``P`` of a tree with a mesh, as the reference's ``NamedSharding``s (both
live in the leaf module ``sharding``, which the models and the optimizer
import; this module re-exports them).

Importing this module starts nothing.  ``make_host_mesh`` uses the
process group that exists (``torch.distributed.init_process_group``,
given its store, rank and world size by the caller) and starts a
one-rank group in memory when there is none.  The backend is NCCL for a
CUDA device and gloo for the CPU; the caller may name another (two ranks
sharing one card need gloo, since NCCL refuses two ranks on one device),
and a group whose backend is not the one asked for raises: NCCL is never
swapped for gloo behind the caller's back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .._device import DEFAULT_DEVICE, resolve
from ..sharding import (NamedSharding, P, axes_of,  # noqa: F401 (re-exported)
                        local_block, local_rows, shard_shape)

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and sizes (the reference's ``mesh.axis_names`` and
    ``mesh.devices.shape``), this rank's device and, when it runs, the
    ``DeviceMesh`` of the process group's ranks."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device = torch.device("cpu")
    device_mesh: Any = None
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False)

    def __deepcopy__(self, memo):
        # a mesh names process groups, which are not copied: a copy of a
        # model placed on it is placed on the same ranks
        return self

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coordinate(self) -> Tuple[int, ...]:
        """This rank's index along each axis (zeros for a mesh of names
        and sizes only)."""
        if self.device_mesh is None:
            return (0,) * len(self.shape)
        return tuple(self.device_mesh.get_coordinate())

    def group(self, *axes: str):
        """The process group over ``axes`` (this rank's, the others fixed);
        None where they span one rank, when collectives over them are the
        identity.  Raises for a mesh of names and sizes only and for axes
        whose group was not made with the mesh (each axis, the batch axes
        together, all axes)."""
        key = tuple(a for a in axes if self.sizes[a] > 1)
        if not key:
            return None
        if self.device_mesh is None:
            raise ValueError(f"a mesh of names and sizes only has no process "
                             f"group over {axes}")
        if key not in self.groups:
            raise ValueError(f"no process group over {axes} on {self}")
        return self.groups[key]


def _backend(device: torch.device, backend: Optional[str]) -> str:
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def _rank_device(device, backend: Optional[str]) -> torch.device:
    """This rank's device, starting a one-rank process group when none
    exists; raises when the group's backend is not the one asked for."""
    dev = resolve(device)
    if dev.type == "cuda":
        if dev.index is not None:
            torch.cuda.set_device(dev)
        dev = torch.device("cuda", torch.cuda.current_device())
    want = _backend(dev, backend)
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_backend()
    if have != want:
        raise ValueError(
            f"the process group's backend is {have!r}, not {want!r} for "
            f"{dev}; pass backend={have!r} to use it")
    return dev


def _mesh(dev: torch.device, shape: Tuple[int, ...],
          names: Tuple[str, ...]) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} holds {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    mesh = Mesh(names, tuple(shape), dev, dm)
    ranks = dm.mesh
    if not torch.equal(ranks.flatten().cpu(), torch.arange(world)):
        raise ValueError("the mesh's ranks are not in row-major order")
    big = tuple(a for a in names if mesh.sizes[a] > 1)
    for a in big:
        mesh.groups[(a,)] = dm.get_group(a)
    if len(big) > 1:
        mesh.groups[big] = dist.group.WORLD
    batch = tuple(a for a in batch_axes(mesh) if a in big)
    if len(batch) > 1 and batch not in mesh.groups:
        mesh.groups[batch] = _new_group(mesh, ranks, batch)
    return mesh


def _new_group(mesh: Mesh, ranks: torch.Tensor, axes: Tuple[str, ...]):
    """This rank's group over ``axes``: every rank makes every such group
    (``new_group`` is collective), in the same order."""
    dims = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.shape)) if i not in dims]
    rows = ranks.permute(*rest, *dims).reshape(-1, math.prod(
        mesh.shape[i] for i in dims))
    mine = None
    for row in rows.tolist():
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    return mine


def make_production_mesh(*, multi_pod: bool = False, device=DEFAULT_DEVICE,
                         backend: Optional[str] = None) -> Mesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``, over a process group of exactly that many ranks."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return _mesh(_rank_device(device, backend), shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device=DEFAULT_DEVICE,
                   backend: Optional[str] = None) -> Mesh:
    """(data, model) over the process group's n ranks, clamped as the
    reference's: data = min(data, n), and the model axis takes the rest,
    max(n // data, 1), whatever ``model`` says (as there).  Without a
    process group: one rank, (1, 1)."""
    dev = _rank_device(device, backend)
    n = dist.get_world_size()
    data = min(data, n)
    return _mesh(dev, (data, max(n // data, 1)), ("data", "model"))


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh: Mesh, global_batch: int) -> P:
    """Largest (pod, data) prefix that divides the batch; P(None) if
    none."""
    axes = batch_axes(mesh)
    sizes = mesh.sizes
    for cand in (axes, axes[-1:]):
        total = math.prod(sizes[a] for a in cand)
        if global_batch % total == 0:
            return P(cand if len(cand) > 1 else cand[0])
    return P(None)


def named(mesh: Mesh, spec_tree):
    """Each ``P`` of a tree of dicts and tuples as ``NamedSharding(mesh,
    spec)``."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    leaves = [named(mesh, v) for v in spec_tree]
    if hasattr(spec_tree, "_fields"):          # a named tuple (OptState)
        return type(spec_tree)(*leaves)
    return type(spec_tree)(leaves)
