"""Step builders and meta-tensor input specs for every (arch x shape) cell
(a port of the JAX package's ``launch/steps.py``): the one definition of
the train, prefill and decode steps that the entry points and checks
share.

Cell kinds (from ``configs.SHAPES``):
  train   -> train_step(params, opt, tokens, labels, weights)   [coded step]
  prefill -> prefill_step(params, tokens) -> logits
  decode  -> serve_step(params, cache, tokens, pos) -> (logits, cache)

A ``Cell`` has no ``jitted`` or ``lower``: its ``fn`` is called directly
on real tensors, and its ``args`` describe the global inputs as ``meta``
tensors (shape and dtype, no storage), leaf for leaf the reference's
``ShapeDtypeStruct``s.  ``args[0]`` is ``models.api.param_shapes``'
tree; ``fn`` takes the model module that holds parameters of those
shapes (``models.api.init_params``, ``convert.params_to_port``).  The
train and decode steps update their ``donate`` arguments in place (the
parameters and the optimizer state; the cache), where the reference
donates their buffers.  An embedding-input family (hubert-xlarge,
internvl2-76b) takes (B, S, d) embeddings in the compute dtype and
separate int32 labels: its train cell is how it trains at full width.

On a ``launch.mesh`` mesh (``mesh=``; none is the one-device cell) every
rank holds GSPMD's block of every parameter, moment, batch input, output
and cache tensor, for every family on a mesh of any shape
(``models.transformer``, ``models.ssm_lm``: FSDP over ``data``; heads,
FFN columns, experts, SSM inner channels and vocab over ``model``).
``Cell.rows`` are the rank's contiguous rows of the batch inputs and of
the logits, those of ``batch_spec`` (the reference's), in every cell;
``fn`` takes the rank's rows (``Cell.shard`` cuts them from the global
inputs) and the rank's blocks (``Cell.materialize`` draws them).  The
prefill and decode logits are the rank's vocab columns (the reference's
``P(batch, None, "model")``).  The decode step runs on the cache's rows,
those of ``cache_specs``' batch axis (``data`` for the transformer
families; none for the SSM families, whose state the reference
replicates, so every rank runs the whole batch): where they are not
within the rank's token rows it gathers the tokens over the batch axes
that split them, and where the rank's token rows are not within the
cache's rows (a transformer on a mesh with ``pod`` and ``data`` both
larger than 1) it gathers the logits over the cache's axes, then keeps
its token rows.  The train step computes sum(nll * w) / B over its rows,
counting a data rank's rows once (model ranks hold the same rows and
compute the same loss), runs the backward, whose FSDP gathers
reduce-scatter the ``data``-sharded gradients, then reduces the
gradients by their spec: the loss and every leaf replicated over
``data`` in one all-reduce over the batch axes (pod and data), the
``data``-sharded leaves in one over ``pod``.  AdamW then updates the
rank's blocks, clipping to the norm over the whole mesh.  A group of one
rank moves nothing, so on one rank the cell is the one-device step's
arithmetic, bit for bit.  An MoE forms the reference's token groups over
the global batch (``models.moe``): the cells name the process group over
which the rows the model runs on are split.

Under the ``params16`` switch (``models.layers.opt_enabled``) the train
step casts the fp32 masters (on a mesh the rank's shards, before their
gathers, which then move the compute dtype) to the compute dtype once a
step and runs the model on the cast tensors
(``torch.func.functional_call``); the gradients come back to fp32
through the cast.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Tuple

import torch

from .. import parallel
from .._device import DEFAULT_DEVICE, generator, resolve
from ..configs.base import SHAPES, ModelConfig, ShapeConfig, get_config
from ..models import api, frontends
from ..models.layers import opt_enabled
from ..models.params import dtype_of
from ..optim import adamw
from ..runtime.coded_step import (CodedStepConfig, make_grad_step,
                                  make_train_step, weighted_loss_fn)
from ..sharding import axes_of, replicas, shard_shape
from .mesh import P, Mesh, batch_axes, batch_spec, local_rows


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    """One (arch x shape) cell: its step and the step's inputs as meta
    tensors, for ``cfg`` on ``device``."""
    arch: str
    shape: str
    kind: str
    fn: Callable                    # the step function
    args: Tuple[Any, ...]           # meta tensors (and step 0)
    cfg: ModelConfig
    device: torch.device
    donate: Tuple[int, ...] = ()    # arguments the step updates in place
    opt_cfg: Optional[adamw.AdamWConfig] = None
    mesh: Optional[Mesh] = None
    # this rank's rows of the batch inputs and logits (None: all)
    rows: Optional[slice] = None
    # a train cell's (params, tokens, labels, weights) -> (loss, grads),
    # the gradients reduced as ``fn`` reduces them before AdamW
    grad_step: Optional[Callable] = None

    def shard(self, *inputs):
        """This rank's rows of batch inputs given whole (their leading
        axis)."""
        return tuple(x if self.rows is None else x[self.rows]
                     for x in inputs)

    def materialize(self, seed: int = 0) -> Tuple[Any, ...]:
        """Real inputs of ``args``' shapes and dtypes on ``device``, drawn
        from ``seed``: the parameters (``api.init_params``, trainable for
        a train cell), a fresh optimizer state, token ids (embeddings from
        ``models.frontends`` for an embedding-input family) and labels
        uniform over the vocabulary, unit weights, a zero cache and
        position 0.  On a mesh every rank draws the same global parameters
        and batch and keeps its blocks and ``rows`` (a zero cache of its
        block)."""
        cfg, gen = self.cfg, generator(seed, self.device)
        params = api.init_params(cfg, gen, trainable=self.kind == "train",
                                 mesh=self.mesh)

        def inputs(spec):
            if spec.is_floating_point():
                return frontends.synthetic_embeddings(
                    cfg, gen, *spec.shape[:2], cfg.compute_dtype)
            return torch.randint(0, cfg.vocab_size, spec.shape,
                                 generator=gen, device=self.device,
                                 dtype=spec.dtype)

        if self.kind == "train":
            _, _, tok, lab, w = self.args
            return (params, adamw.init(self.opt_cfg, params),
                    *self.shard(inputs(tok), inputs(lab),
                                torch.ones(w.shape, device=self.device)))
        if self.kind == "prefill":
            return (params, *self.shard(inputs(self.args[1])))
        _, cache, tok, _ = self.args
        specs = api.cache_specs(cfg) if self.mesh is not None else None
        return (params, _zeros(cache, self.device, specs, self.mesh),
                *self.shard(inputs(tok)),
                torch.zeros((), dtype=torch.int32, device=self.device))


def _zeros(tree, device: torch.device, specs=None, mesh=None):
    """A zero tensor on ``device`` for each meta tensor of ``tree`` (with
    ``specs``, a congruent tree, the rank's block of each on ``mesh``)."""
    if isinstance(tree, torch.Tensor):
        shape = tree.shape if specs is None else \
            shard_shape(mesh, specs, tree.shape)
        return torch.zeros(shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _zeros(v, device, None if specs is None else specs[k],
                          mesh) for k, v in tree.items()}
    return tuple(_zeros(v, device, None if specs is None else s, mesh)
                 for v, s in zip(tree, specs or [None] * len(tree)))


def _placement(cfg: ModelConfig, mesh: Optional[Mesh],
               device) -> torch.device:
    """The cell's device: the mesh's rank device, else ``device``."""
    if mesh is None:
        return resolve(DEFAULT_DEVICE if device is None else device)
    if device is not None and resolve(device).type != mesh.device.type:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    return mesh.device


def _placed(mesh: Optional[Mesh], step: Callable) -> Callable:
    """``step(params, ...)`` that first raises where ``params`` are not
    placed on the cell's mesh (a whole module on a mesh, or blocks
    without one, would compute silently wrong values)."""
    @functools.wraps(step)
    def checked(params, *args):
        if getattr(params, "mesh", None) is not mesh:
            raise ValueError(
                f"the parameters are placed on {params.mesh}, the cell on "
                f"{mesh}: build them on the cell's mesh "
                f"(Cell.materialize, api.init_params or "
                f"convert.params_to_port with mesh=)")
        return step(params, *args)
    return checked


def _batch_rows(mesh: Optional[Mesh], global_batch: int):
    """(the spec element of the batch's rows, ``batch_spec``'s, and this
    rank's rows); (None, None) without a mesh."""
    if mesh is None:
        return None, None
    elem = batch_spec(mesh, global_batch)[0]
    return elem, local_rows(mesh, elem, global_batch)


def _split(mesh: Optional[Mesh], elem):
    """The process group over which rows placed by the spec element
    ``elem`` are split (None: every rank holds them all); looked up when
    a step runs, since a cell builds on a mesh of names and sizes too."""
    return None if mesh is None else mesh.group(*axes_of(elem))


def _regroup(x: torch.Tensor, mesh: Mesh, have, want, batch: int
             ) -> torch.Tensor:
    """The rows of the spec element ``want`` of a batch of ``batch`` rows
    (its leading axis), from ``x``, the rows of ``have``: a slice where
    they lie within those, else from the whole batch, gathered over
    ``have``'s axes."""
    held, wanted = local_rows(mesh, have, batch), local_rows(mesh, want,
                                                             batch)
    if not (held.start <= wanted.start and wanted.stop <= held.stop):
        x = parallel.all_gather(x, 0, _split(mesh, have))
        held = slice(0, batch)
    return x[wanted.start - held.start:wanted.stop - held.start]


class _Bound(torch.nn.Module):
    """``loss(model, *args)`` as a module's forward, so that
    ``torch.func.functional_call`` can run it on other tensors."""

    def __init__(self, model: torch.nn.Module, loss: Callable):
        super().__init__()
        self.model, self.loss = model, loss

    def forward(self, *args):
        return self.loss(self.model, *args)


def _params16(loss: Callable, dtype: torch.dtype) -> Callable:
    """``loss`` on the fp32 masters cast once to ``dtype`` (the reference's
    cast-before-gather); other dtypes pass as they are."""
    def cast_loss(params, *args):
        cast = {f"model.{n}": p.to(dtype) if p.dtype == torch.float32 else p
                for n, p in adamw.named(params).items()}
        return torch.func.functional_call(_Bound(params, loss), cast, args)
    return cast_loss


def _grad_reduce(cfg: ModelConfig, mesh: Mesh) -> Callable:
    """(loss, grads) -> the same summed over the ranks that computed parts
    of them, by each leaf's spec (``api.placement``): the loss and the
    leaves replicated over ``data`` in one flat all-reduce over the batch
    axes; the ``data``-sharded leaves, whose gather's backward summed
    them over ``data``, in one over the other batch axes (``pod``).  A
    leaf's partial sums over ``model`` were summed by the model's own
    ``copy_to_model``."""
    specs = api.placement(cfg)
    axes = batch_axes(mesh)

    def sharded(name):
        return any("data" in axes_of(e) for e in specs[name])

    def reduce(lval, grads):
        over_batch = mesh.group(*axes)
        over_pod = mesh.group(*(a for a in axes if a != "data"))
        rest = [n for n in grads if not sharded(n)]
        fsdp = [n for n in grads if sharded(n)]
        *summed, loss = parallel.flat_all_reduce(
            [grads[n] for n in rest] + [lval.reshape(1)], over_batch)
        out = dict(zip(rest, summed))
        out.update(zip(fsdp, parallel.flat_all_reduce(
            [grads[n] for n in fsdp], over_pod)))
        return loss.reshape(()), {n: out[n] for n in grads}
    return reduce


def _train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                mesh: Optional[Mesh], share: Optional[float], elem=None
                ) -> Tuple[Callable, Callable]:
    """(step, grad_step): ``make_train_step`` with the ``params16`` cast
    and, on a mesh (``share``: the rank's part of the global mean, its
    rows over the global batch and over the batch ranks that hold the
    same rows; ``elem``: the spec element of its rows), the rank's loss
    scaled to its share, ``_grad_reduce`` before AdamW and the norm over
    the whole mesh."""
    def loss(params, tokens, labels, weights):
        value = weighted_loss_fn(cfg, _split(mesh, elem))(
            params, tokens, labels, weights)
        return value if share is None or share == 1.0 else value * share
    if opt_enabled("params16"):
        loss = _params16(loss, dtype_of(cfg.compute_dtype))
    reduce = None if mesh is None else _grad_reduce(cfg, mesh)
    grad_step = make_grad_step(loss, reduce)
    if mesh is None:
        return make_train_step(cfg, opt_cfg, loss, reduce), grad_step
    counts = {n: replicas(mesh, s) for n, s in api.placement(cfg).items()}

    def step(*args):
        # the mesh's groups are looked up when the step runs: a cell
        # builds on a mesh of names and sizes too
        return make_train_step(cfg, opt_cfg, loss, reduce, counts,
                               mesh.group(*mesh.axis_names))(*args)
    return step, grad_step


def default_opt_cfg() -> adamw.AdamWConfig:
    return adamw.AdamWConfig()


def _token_specs(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    """The model input: token ids (B, S) int32, or (B, S, d) embeddings in
    the compute dtype for an embedding-input family."""
    if cfg.embedding_inputs:
        return _meta((batch, seq, cfg.d_model), dtype_of(cfg.compute_dtype))
    return _meta((batch, seq), torch.int32)


def build_train_cell(cfg: ModelConfig, shape: ShapeConfig,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     device=None, mesh: Optional[Mesh] = None,
                     step_cfg: Optional[CodedStepConfig] = None) -> Cell:
    """The coded training step: ``weighted_loss_fn``'s value and gradient,
    then ``adamw.apply_updates``; returns (params, opt_state, metrics)
    with ``metrics`` = loss, grad_norm, lr.  Labels are int32 (B, S) and
    the per-example decode weights fp32 (B,).  ``step_cfg``: the coded
    batch's plan, whose workers a rank's rows must hold whole."""
    opt_cfg = opt_cfg or default_opt_cfg()
    pshapes = api.param_shapes(cfg)
    b, s = shape.global_batch, shape.seq_len
    dev = _placement(cfg, mesh, device)
    elem, rows = _batch_rows(mesh, b)
    share = None
    if mesh is not None:
        n = rows.stop - rows.start
        # batch ranks holding the same rows each count them once in the
        # sum; model ranks compute the same sum
        batch_ranks = math.prod(mesh.sizes[a] for a in batch_axes(mesh))
        share = n / b / (batch_ranks // (b // n))
        if step_cfg is not None and n % step_cfg.per_worker_rows:
            raise ValueError(f"{n} rows a rank split worker blocks of "
                             f"{step_cfg.per_worker_rows} rows")
    args = (pshapes, adamw.state_shapes(opt_cfg, pshapes),
            _token_specs(cfg, b, s), _meta((b, s), torch.int32),
            _meta((b,), torch.float32))
    fn, grad_step = _train_step(cfg, opt_cfg, mesh, share, elem)
    fn, grad_step = _placed(mesh, fn), _placed(mesh, grad_step)
    return Cell(arch=cfg.name, shape=shape.name, kind="train", fn=fn,
                args=args, cfg=cfg, device=dev, donate=(0, 1),
                opt_cfg=opt_cfg, mesh=mesh, rows=rows, grad_step=grad_step)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig,
                       device=None, mesh: Optional[Mesh] = None) -> Cell:
    b = shape.global_batch
    elem, rows = _batch_rows(mesh, b)

    @functools.partial(_placed, mesh)
    def prefill_step(params, tokens):
        return api.forward(cfg, params, tokens, split=_split(mesh, elem))

    args = (api.param_shapes(cfg), _token_specs(cfg, b, shape.seq_len))
    dev = _placement(cfg, mesh, device)
    return Cell(arch=cfg.name, shape=shape.name, kind="prefill",
                fn=prefill_step, args=args, cfg=cfg, device=dev, mesh=mesh,
                rows=rows)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig,
                      device=None, mesh: Optional[Mesh] = None) -> Cell:
    """One serve step: a new token with a KV (or SSM) cache of seq_len.
    On a mesh the tokens and the logits are the rank's ``batch_spec``
    rows, the cache its block (``Cell.materialize``), and the step runs on
    the cache's rows (see the module doc)."""
    b = shape.global_batch
    tok, rows = _batch_rows(mesh, b)
    if mesh is not None:
        (held,) = {spec[1] for spec in _spec_leaves(api.cache_specs(cfg))}
        local_rows(mesh, held, b)       # raises where the cache's rows
        #                                 do not split (GSPMD refuses)

    @functools.partial(_placed, mesh)
    def serve_step(params, cache, tokens, pos):
        if mesh is None:
            return api.decode_step(cfg, params, cache, tokens, pos)
        logits, cache = api.decode_step(
            cfg, params, cache, _regroup(tokens, mesh, tok, held, b), pos,
            _split(mesh, held))
        return _regroup(logits, mesh, held, tok, b), cache

    args = (api.param_shapes(cfg), api.cache_shapes(cfg, b, shape.seq_len),
            _token_specs(cfg, b, 1), _meta((), torch.int32))
    dev = _placement(cfg, mesh, device)
    return Cell(arch=cfg.name, shape=shape.name, kind="decode",
                fn=serve_step, args=args, cfg=cfg, device=dev,
                donate=(1,), mesh=mesh, rows=rows)


def _spec_leaves(tree) -> list:
    """The ``P`` leaves of a tree of dicts and tuples."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [x for v in tree for x in _spec_leaves(v)]


def build_cell(arch: str, shape_name: str, overrides: Optional[dict] = None,
               device=None, mesh: Optional[Mesh] = None) -> Cell:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_cell(cfg, shape, device=device, mesh=mesh)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, device, mesh)
    return build_decode_cell(cfg, shape, device, mesh)
