"""Step builders and meta-tensor input specs for every (arch x shape) cell
(a port of the JAX package's ``launch/steps.py``): the one definition of
the train, prefill and decode steps that the entry points and checks
share.

Cell kinds (from ``configs.SHAPES``):
  train   -> train_step(params, opt, tokens, labels, weights)   [coded step]
  prefill -> prefill_step(params, tokens) -> logits
  decode  -> serve_step(params, cache, tokens, pos) -> (logits, cache)

On one device a ``Cell`` has no shardings, mesh, ``jitted`` or ``lower``:
its ``fn`` is called directly on real tensors, and its ``args`` describe
them as ``meta`` tensors (shape and dtype, no storage), leaf for leaf the
reference's ``ShapeDtypeStruct``s.  ``args[0]`` is
``models.api.param_shapes``' tree; ``fn`` takes the model module that
holds parameters of those shapes (``models.api.init_params``,
``convert.params_to_port``).  The train and decode steps update their
``donate`` arguments in place (the parameters and the optimizer state;
the cache), where the reference donates their buffers.  An
embedding-input family (hubert-xlarge, internvl2-76b) takes (B, S, d)
embeddings in the compute dtype and separate int32 labels: its train
cell is how it trains at full width.

The reference's train step has a ``params16`` branch (one fp32 -> bf16
cast of the masters a step, under its ``REPRO_OPT`` switch); it waits
with the other ``REPRO_OPT`` switches (ROADMAP Queue 1), so the train
cell is the reference's default step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from .._device import DEFAULT_DEVICE, generator, resolve
from ..configs.base import SHAPES, ModelConfig, ShapeConfig, get_config
from ..models import api, frontends
from ..models.params import dtype_of
from ..optim import adamw
from ..runtime.coded_step import make_train_step


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

    def materialize(self, seed: int = 0) -> Tuple[Any, ...]:
        """Real inputs of ``args``' shapes and dtypes on ``device``, drawn
        from ``seed``: the parameters (``api.init_params``, trainable for
        a train cell), a fresh optimizer state, token ids (embeddings from
        ``models.frontends`` for an embedding-input family) and labels
        uniform over the vocabulary, unit weights, a zero cache and
        position 0."""
        cfg, gen = self.cfg, generator(seed, self.device)
        params = api.init_params(cfg, gen, trainable=self.kind == "train")

        def inputs(spec):
            if spec.is_floating_point():
                return frontends.synthetic_embeddings(
                    cfg, gen, *spec.shape[:2], cfg.compute_dtype)
            return torch.randint(0, cfg.vocab_size, spec.shape,
                                 generator=gen, device=self.device,
                                 dtype=spec.dtype)

        if self.kind == "train":
            _, _, tok, lab, w = self.args
            return (params, adamw.init(self.opt_cfg, params), inputs(tok),
                    inputs(lab), torch.ones(w.shape, device=self.device))
        if self.kind == "prefill":
            return params, inputs(self.args[1])
        _, cache, tok, _ = self.args
        return (params, _zeros(cache, self.device), inputs(tok),
                torch.zeros((), dtype=torch.int32, device=self.device))


def _zeros(tree, device: torch.device):
    """A zero tensor on ``device`` for each meta tensor of ``tree``."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _zeros(v, device) for k, v in tree.items()}
    return tuple(_zeros(v, device) for v in tree)


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
                     device=DEFAULT_DEVICE) -> Cell:
    """The coded training step: ``weighted_loss_fn``'s value and gradient,
    then ``adamw.apply_updates``; returns (params, opt_state, metrics)
    with ``metrics`` = loss, grad_norm, lr.  Labels are int32 (B, S) and
    the per-example decode weights fp32 (B,)."""
    opt_cfg = opt_cfg or default_opt_cfg()
    pshapes = api.param_shapes(cfg)
    b, s = shape.global_batch, shape.seq_len
    args = (pshapes, adamw.state_shapes(opt_cfg, pshapes),
            _token_specs(cfg, b, s), _meta((b, s), torch.int32),
            _meta((b,), torch.float32))
    return Cell(arch=cfg.name, shape=shape.name, kind="train",
                fn=make_train_step(cfg, opt_cfg), args=args, cfg=cfg,
                device=resolve(device), donate=(0, 1), opt_cfg=opt_cfg)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig,
                       device=DEFAULT_DEVICE) -> Cell:
    def prefill_step(params, tokens):
        return api.forward(cfg, params, tokens)

    args = (api.param_shapes(cfg),
            _token_specs(cfg, shape.global_batch, shape.seq_len))
    return Cell(arch=cfg.name, shape=shape.name, kind="prefill",
                fn=prefill_step, args=args, cfg=cfg, device=resolve(device))


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig,
                      device=DEFAULT_DEVICE) -> Cell:
    """One serve step: a new token with a KV (or SSM) cache of seq_len."""
    def serve_step(params, cache, tokens, pos):
        return api.decode_step(cfg, params, cache, tokens, pos)

    b = shape.global_batch
    args = (api.param_shapes(cfg), api.cache_shapes(cfg, b, shape.seq_len),
            _token_specs(cfg, b, 1), _meta((), torch.int32))
    return Cell(arch=cfg.name, shape=shape.name, kind="decode",
                fn=serve_step, args=args, cfg=cfg, device=resolve(device),
                donate=(1,))


def build_cell(arch: str, shape_name: str, overrides: Optional[dict] = None,
               device=DEFAULT_DEVICE) -> Cell:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_cell(cfg, shape, device=device)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, device)
    return build_decode_cell(cfg, shape, device)
