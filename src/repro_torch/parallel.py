"""The collectives of a model placed on a two-axis mesh, as autograd
functions.  The reference has no counterpart: GSPMD inserts these
collectives where its partition specs meet.

- ``gather_data``: all-gather forward, reduce-scatter (sum) backward.
  FSDP: a parameter sharded over ``data`` is gathered where a layer uses
  it, and its gradient comes back summed over the data ranks, in the
  rank's block.
- ``copy_to_model``: identity forward, all-reduce backward.  A tensor
  replicated over ``model`` that enters a computation sharded over it
  (an activation before a column-parallel product, a weight that every
  rank uses on its own heads or experts) gets each rank's part of its
  gradient, summed here.
- ``reduce_from_model``: all-reduce forward, identity backward: the
  partial sums of a row-parallel product, of a vocab-parallel lookup or
  of the rank's experts.
- ``gather_model``: all-gather forward, the rank's block of the gradient
  backward (the gathered tensor feeds computations every model rank
  repeats): the decode path's queries and outputs where the cache's
  head dim is over ``model``.

A group of None (an axis of one rank) makes each of them the identity,
with no autograd node.  The collectives are ``torch.distributed``'s own
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``)
on NCCL and on gloo, CPU and CUDA tensors alike; ``calls`` counts them
by (operation, backend).  A group whose backend lacks one raises.  Every
collective passes through ``_count``, which also reports it to the op
recorder (``_trace``): the reference's kind name (``all-reduce``,
``all-gather``, ``reduce-scatter``), the operand's bytes (a rank's block
for a gather, the whole input of a reduce-scatter, as the reference's HLO
operands), its dtype, and the group's size and global ranks.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.distributed as dist

from . import _trace

#: collectives issued, by (operation, backend)
calls: collections.Counter = collections.Counter()

# torch renamed the tensor-in tensor-out collectives; the old names stay
# (deprecated) where the new ones exist
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


#: the reference's HLO name of each collective
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter"}


def _count(op: str, group, x: torch.Tensor) -> None:
    calls[(op, dist.get_backend(group))] += 1
    if _trace.sinks:
        ranks = dist.get_process_group_ranks(group)
        _trace.emit({"kind": "collective", "op": _KINDS[op],
                     "bytes": x.numel() * x.element_size(),
                     "dtype": str(x.dtype)[6:], "shapes": [list(x.shape)],
                     "group_size": len(ranks), "ranks": ranks})


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (returned)."""
    if group is not None:
        _count("all_reduce", group, x)
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in group
    rank order."""
    n = size(group)
    if n == 1:
        return x
    _count("all_gather", group, x)
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0],) + front.shape[1:],
                      dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, front, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over the group, this rank's block along ``dim``."""
    n = size(group)
    if n == 1:
        return x
    _count("reduce_scatter", group, x)
    front = x.movedim(dim, 0).contiguous()
    if front.shape[0] % n:
        raise ValueError(f"{front.shape[0]} rows do not split over {n} ranks")
    out = torch.empty((front.shape[0] // n,) + front.shape[1:],
                      dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, front, group=group)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = x.shape[dim] // size(group)
    return x.narrow(dim, rank(group) * n, n)


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None


def gather_data(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if size(group) == 1 else _GatherData.apply(x, dim, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if size(group) == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if size(group) == 1 else _ReduceFromModel.apply(x, group)


def gather_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if size(group) == 1 else _GatherModel.apply(x, dim, group)


def gather_leaf(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole of a tensor placed on ``mesh`` by ``spec`` (this rank's
    block ``x``), gathered over each sharded dimension's axes: every
    rank of the mesh gets it."""
    from .sharding import _elems, axes_of
    for dim, elem in enumerate(_elems(spec, x.dim())):
        x = all_gather(x, dim, mesh.group(*axes_of(elem)))
    return x.contiguous()


def flat_all_reduce(tensors, group: Optional[object]):
    """``tensors`` summed over ``group`` in ONE all-reduce of one flat
    fp32 buffer; each comes back in its shape and dtype."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out
