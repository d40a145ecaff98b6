"""The coded any-k-of-n gradient step: the paper's technique as a training
feature (a port of the JAX package's ``runtime/coded_step.py``).

The ``n`` redundancy workers are the n row blocks of one coded batch.
Data parts are assigned by a fractional-repetition gradient code
(core.coding); each worker's rows are its (replicated) part rows.  Decode
is folded into the gradient reduction: the per-example loss weights carry
the decode coefficients (a_i = 0 for stragglers, one finisher per part
group), so the weighted loss's gradient *is* the decoded gradient — no
master round-trip, no extra pass.  See DESIGN.md §4.

One card plays the n workers, as the reference does on a single host.  The
straggler mask comes from ``alive_fn`` (sampled from the paper's service
models by ``runtime.straggler``, or gather timeouts in production); the
step function is the same either way: the decode coefficients are an
input.  The step runs eagerly on the parameters' device: the reference's
``jit`` and buffer donation have no counterpart here (no
``torch.compile``), and the parameters and moments are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.coding import FractionalRepetitionCode, gc_decode_weights
from ..core.policy import Policy, RetryPolicy
from ..data.pipeline import (DataConfig, coded_batch, decode_example_weights,
                             expand_worker_weights)
from ..models import api
from ..models.layers import cross_entropy_loss
from ..optim import adamw


@dataclasses.dataclass(frozen=True)
class CodedStepConfig:
    """Redundancy plan for one training job."""
    n_workers: int            # redundancy groups
    c: int                    # replication factor (task size in parts); c=1
                              # is splitting, c=n is replication
    unique_batch: int         # unique examples per step (the "job size")

    def __post_init__(self):
        if self.n_workers % self.c:
            raise ValueError("c must divide n_workers")

    @classmethod
    def from_policy(cls, policy: Policy, unique_batch: int) -> "CodedStepConfig":
        """Build the runtime config from the planner's typed decision."""
        return cls(n_workers=policy.n, c=policy.c, unique_batch=unique_batch)

    @property
    def policy(self) -> Policy:
        """This config's redundancy decision as a ``Policy`` (k = n/c)."""
        return Policy.from_c(self.n_workers, self.c)

    @property
    def code(self) -> FractionalRepetitionCode:
        return FractionalRepetitionCode(n=self.n_workers, c=self.c)

    @property
    def coded_batch_rows(self) -> int:
        """Materialized rows = unique * c (replication inflates the batch)."""
        return self.unique_batch * self.c

    @property
    def per_worker_rows(self) -> int:
        return self.coded_batch_rows // self.n_workers


def weighted_loss_fn(cfg: ModelConfig, split=None) -> Callable:
    """loss(params, tokens, labels, weights) with per-example weights.

    weights (B,) -- decode coefficients expanded to examples; the weighted
    mean over coded rows equals the plain mean over unique rows when the
    weights come from ``decode_example_weights``.  ``split``: the process
    group over which the rows are the global batch's blocks
    (``models.api.train_forward``; a cell on a mesh).
    """
    def loss(params, tokens, labels, weights):
        logits = api.train_forward(cfg, params, tokens,
                                   split=split).float()
        nll = api.token_nll(cfg, params, logits, labels).mean(dim=-1)  # (B,)
        return (nll * weights).mean()
    return loss


def _value_and_grad(loss: Callable, params, *args):
    """(loss, {name: grad}) of ``loss(params, *args)`` over every
    parameter of ``params`` (a module, or a dictionary of tensors)."""
    leaves = adamw.named(params)
    lval = loss(params, *args)
    grads = torch.autograd.grad(lval, list(leaves.values()))
    return lval.detach(), dict(zip(leaves, grads))


def make_grad_step(loss: Callable, reduce: Optional[Callable] = None
                   ) -> Callable:
    """(params, tokens, labels, weights) -> (loss, {name: grad}) of
    ``loss``, then ``reduce(loss, grads) -> (loss, grads)`` when given
    (``launch.steps``' cells on a mesh: their gradient reduction)."""
    def grad_step(params, tokens, labels, weights):
        lval, grads = _value_and_grad(loss, params, tokens, labels, weights)
        if reduce is not None:
            lval, grads = reduce(lval, grads)
        return lval, grads
    return grad_step


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    loss: Optional[Callable] = None,
                    reduce: Optional[Callable] = None,
                    replicas: Optional[dict] = None, group=None) -> Callable:
    """(params, opt_state, tokens, labels, weights) -> (params, opt, metrics)
    with ``metrics`` = loss, grad_norm, lr.  ``loss`` replaces
    ``weighted_loss_fn(cfg)``; ``reduce`` runs between the backward and
    AdamW (``make_grad_step``); ``replicas`` and ``group``: AdamW's global
    norm over a mesh's blocks."""
    grad_step = make_grad_step(
        weighted_loss_fn(cfg) if loss is None else loss, reduce)

    def step(params, opt_state, tokens, labels, weights):
        lval, grads = grad_step(params, tokens, labels, weights)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state, replicas, group)
        metrics["loss"] = lval
        return params, opt_state, metrics

    return step


def make_coded_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                          step_cfg: "CodedStepConfig") -> Callable:
    """(params, opt_state, tokens, labels, worker_weights) -> ... with the
    decode-weight expansion INSIDE the step: the host ships only the
    (n_workers,) decode coefficients; the repeat-to-examples count and the
    mean-normalization scale are constants of the step
    (``expand_worker_weights``)."""
    loss = weighted_loss_fn(cfg)
    per_worker_rows = step_cfg.per_worker_rows
    scale = step_cfg.coded_batch_rows / step_cfg.unique_batch

    def step(params, opt_state, tokens, labels, worker_weights):
        weights = expand_worker_weights(worker_weights, per_worker_rows, scale)
        lval, grads = _value_and_grad(loss, params, tokens, labels, weights)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = lval
        return params, opt_state, metrics

    return step


def make_eval_step(cfg: ModelConfig) -> Callable:
    def eval_step(params, tokens, labels):
        logits = api.forward(cfg, params, tokens)
        return cross_entropy_loss(logits, labels)
    return eval_step


def _device_of(params) -> torch.device:
    return next(iter(adamw.named(params).values())).device


class CodedTrainer:
    """Host-side driver: builds coded batches, samples/ingests straggler
    masks, derives decode weights, and invokes the step on the
    parameters' device.

    ``alive_fn(step) -> bool (n,)`` supplies the straggler mask (simulated
    here; gather timeouts in production).  If a part group loses all its
    workers, decode is impossible.  With a ``retry`` policy the step first
    RE-POLLS the gather once after the policy's first backoff delay
    (workers that already arrived stay arrived — a straggler often only
    needs the grace period); only if decode is still impossible does it
    fall back to WAITING for the full barrier (all-ones weights on the
    unique rows) — and both the retry and the fallback are counted.  A
    ``telemetry`` sink receives the per-step retry count
    (``FleetHealth.retries_per_task``).
    """

    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 step_cfg: CodedStepConfig, opt_cfg: adamw.AdamWConfig,
                 alive_fn: Optional[Callable[[int], np.ndarray]] = None,
                 retry: Optional[RetryPolicy] = None,
                 telemetry=None):
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.alive_fn = alive_fn
        self.step_cfg = step_cfg          # property: builds the step
        self.retry = retry
        self.telemetry = telemetry
        self.decode_failures = 0
        self.stragglers_dropped = 0
        self.decode_retries = 0           # re-polls that rescued (or tried
                                          # to rescue) an undecodable mask
        self.retry_wait = 0.0             # total backoff grace charged

    @property
    def step_cfg(self) -> CodedStepConfig:
        return self._step_cfg

    @step_cfg.setter
    def step_cfg(self, cfg: CodedStepConfig) -> None:
        """Swap the redundancy plan (elastic resize / online re-plan).

        ``per_worker_rows`` and the normalization scale are constants of
        the step, so a new config rebuilds ``step_fn`` and re-sizes the
        data pipeline — assigning the field alone would keep running the
        stale step.
        """
        self._step_cfg = cfg
        self.data_cfg = dataclasses.replace(
            self.data_cfg, global_batch=cfg.unique_batch)
        self.step_fn = make_coded_train_step(self.model_cfg, self.opt_cfg,
                                             cfg)

    def decode_coefficients(self, alive: np.ndarray) -> np.ndarray:
        """(n_workers,) decode coefficients a_i for this step's alive mask."""
        code = self.step_cfg.code
        try:
            a = gc_decode_weights(code, alive)
            self.stragglers_dropped += int((~alive).sum())
        except RuntimeError:
            # a whole group straggled: wait for everyone (full barrier)
            self.decode_failures += 1
            a = np.zeros(code.n, np.float32)
            a[np.arange(code.num_groups) * code.c] = 1.0  # first member per group
        return a

    def weights_for(self, alive: np.ndarray) -> np.ndarray:
        """Host-side expanded per-example weights (reference/debug path; the
        step expands the coefficients on the device instead)."""
        return decode_example_weights(
            self.step_cfg.code, self.decode_coefficients(alive),
            self.step_cfg.per_worker_rows, self.step_cfg.unique_batch)

    def _decodable(self, alive: np.ndarray) -> bool:
        try:
            gc_decode_weights(self.step_cfg.code, alive)
            return True
        except RuntimeError:
            return False

    def gather_alive(self, step: int) -> np.ndarray:
        """This step's straggler mask, with the one-shot backoff re-poll.

        When the first gather leaves a part group with no finisher
        (decode impossible) and a ``retry`` policy is attached, the
        gather is polled once more after the policy's first backoff
        delay — the simulated harness charges the delay to
        ``retry_wait`` instead of sleeping — and the masks are OR-ed
        (an arrival is never un-arrived).  The retry count (0 or 1)
        feeds ``telemetry`` either way, so ``FleetHealth``'s
        ``retries_per_task`` reflects how often the grace period is
        earning its latency.
        """
        alive = (np.asarray(self.alive_fn(step), bool)
                 if self.alive_fn is not None
                 else np.ones(self.step_cfg.n_workers, bool))
        retries = 0
        if self.retry is not None and self.alive_fn is not None \
                and self.retry.max_attempts > 1 \
                and not self._decodable(alive):
            self.retry_wait += float(self.retry.delay(0))
            alive = alive | np.asarray(self.alive_fn(step), bool)
            retries = 1
            self.decode_retries += 1
        if self.telemetry is not None:
            self.telemetry.record_retries(retries)
        return alive

    def run_step(self, params, opt_state, step: int):
        toks, labs = coded_batch(self.data_cfg, step, self.step_cfg.code)
        alive = self.gather_alive(step)
        a = self.decode_coefficients(alive)
        dev = _device_of(params)
        as_tensor = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        return self.step_fn(params, opt_state, as_tensor(toks),
                            as_tensor(labs), as_tensor(a))
