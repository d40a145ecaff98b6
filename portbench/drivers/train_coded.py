"""Coded data-parallel training: ``runtime.coded_step.CodedTrainer``.

n workers in n / c part groups of c; each step's coded batch holds the
unique rows c times (one worker's block a row group), and a straggler
mask drawn from the seed gives the decode coefficients.  A worker's task
of c parts takes c x (``B`` with probability ``eps``, else 1) units; a
worker is alive when that is within ``deadline``.  Every worker's rows
are computed, replicas and the rows the mask zeroes included: the cell
emulates n workers on one card.

What is judged: the warm-up's ``first_steps`` steps (their losses, the
first gradient as AdamW takes it, from its first moment after one step,
and each leaf's change after them), which the reference follows from
the drawn weights; and the window's last step (its gradient and each
leaf's change), which the reference takes again from the program's own
state before it (parameters and moments, copied on the card when the
window has about one step left).  Where no copy was taken before the
last step (a step much slower than the one before it, or a traced
stretch, whose profile no copy may enter), the copy is taken after the
window and one more step of the same call is judged in its place.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights
from ..reference import compare, train as ref_train
from ..spec import program_config
from ..timing import sync

KIND = "train"
SYNC_EACH = True


def end_to_end(win) -> dict:
    return {"train_tokens_per_s": win.rate()}


def alive_mask(mix: dict, seed: int, step: int) -> np.ndarray:
    law = mix["straggle"]
    rng = np.random.default_rng(weights.seed_of(seed, "straggle", step))
    slow = rng.random(mix["n_workers"]) < law["eps"]
    times = mix["c"] * np.where(slow, law["B"], 1.0)
    return times <= law["deadline"]


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.mix, self.spec = cell.mix, cell.spec
        self.step = 0
        self.step_s = None          # host seconds of the newest step
        self.snap = None            # the state before a step, on the card
        self.loss = None

    @property
    def coded_rows(self) -> int:
        return self.mix["unique_rows"] * self.mix["c"]

    @property
    def work_per_unit(self) -> int:
        return self.mix["unique_rows"] * self.mix["seq_len"]

    def alive(self, step: int) -> np.ndarray:
        return alive_mask(self.mix, self.seed, step)

    def build(self) -> None:
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.models import api
        from repro_torch.optim import adamw
        from repro_torch.runtime.coded_step import (CodedStepConfig,
                                                    CodedTrainer)
        mix, spec = self.mix, self.spec
        pcfg = program_config(self.cell.config, self.cell.root)
        self.model = api.build(pcfg, self.device, trainable=True)
        weights.fill(self.model, spec, self.seed)
        opt_cfg = adamw.AdamWConfig(**mix["optimizer"])
        self.opt = adamw.init(opt_cfg, self.model)
        self.trainer = CodedTrainer(
            pcfg, DataConfig(vocab_size=spec.vocab, seq_len=mix["seq_len"],
                             global_batch=mix["unique_rows"], seed=self.seed),
            CodedStepConfig(n_workers=mix["n_workers"], c=mix["c"],
                            unique_batch=mix["unique_rows"]),
            opt_cfg, alive_fn=self.alive)

    def warm(self) -> None:
        losses = []
        b1 = self.mix["optimizer"]["b1"]
        for _ in range(self.mix["first_steps"]):
            losses.append(float(self.unit(None)))
            if self.step == 1:
                grad1 = {n: float(m.norm()) / (1 - b1)
                         for n, m in self.opt.mu.items()}
        shapes = weights.param_shapes(self.spec)
        with torch.no_grad():
            change = {n: float((p - weights.draw(self.spec, n, shapes[n],
                                                 self.seed, p.device)).norm())
                      for n, p in self.model.named_parameters()}
        self.first = {"losses": losses, "grad1": grad1, "change": change}

    def _copy_state(self) -> None:
        """The parameters and moments as they stand, into buffers on the
        card that later copies reuse."""
        state = {"params": dict(self.model.named_parameters()),
                 "mu": self.opt.mu, "nu": self.opt.nu}
        with torch.no_grad():
            if self.snap is None:
                self.snap = {k: {n: t.detach().clone() for n, t in d.items()}
                             for k, d in state.items()}
            else:
                for k, d in state.items():
                    for n, t in d.items():
                        self.snap[k][n].copy_(t)
        self.snap["step"] = self.step

    def unit(self, remaining):
        if remaining is not None and self.step_s is not None \
                and remaining <= 1.5 * self.step_s:
            self._copy_state()
        t = time.perf_counter()
        self.model, self.opt, metrics = self.trainer.run_step(
            self.model, self.opt, self.step)
        self.step += 1
        self.loss = metrics["loss"]
        sync(self.device)
        self.step_s = time.perf_counter() - t
        return self.loss

    def run_units(self, n: int) -> dict:
        for _ in range(n):
            self.unit(None)
        return {"rows": self.coded_rows, "seq": self.mix["seq_len"]}

    def judged(self) -> dict:
        if self.snap is None or self.snap["step"] != self.step - 1:
            self._copy_state()
            self.unit(None)
        b1 = self.mix["optimizer"]["b1"]
        snap = self.snap
        with torch.no_grad():
            grad = {n: float((m - b1 * snap["mu"][n]).norm()) / (1 - b1)
                    for n, m in self.opt.mu.items()}
            change = {n: float((p - snap["params"][n]).norm())
                      for n, p in self.model.named_parameters()}
        return {"first": self.first,
                "last": {"step": snap["step"], "losses": [float(self.loss)],
                         "grad1": grad, "change": change}}

    def free(self) -> None:
        self.model = self.opt = self.trainer = self.loss = None

    def reference(self, outputs: dict, precision: str = "fp32") -> dict:
        first = ref_train.run_steps(
            self.spec, self.mix, self.seed, self.alive,
            len(outputs["first"]["losses"]), self.device, precision)
        snap = self.snap
        last = ref_train.one_step(
            self.spec, self.mix, self.seed, self.alive, snap["step"],
            snap["params"], snap["mu"], snap["nu"], self.device, precision)
        return {"first": first, "last": last}

    def numbers(self, outputs: dict, ref: dict) -> dict:
        out = compare.train_numbers(outputs["first"], ref["first"])
        last = compare.train_numbers(outputs["last"], ref["last"])
        # one step's loss, a mean over every token of the batch, reads the
        # control as it reads the program (PERF.md): not compared
        out.update({f"last_{k}": v for k, v in last.items()
                    if k != "loss_gap"})
        return out

    def control_numbers(self, outputs: dict, ref: dict) -> dict:
        return self.numbers(self.reference(outputs, "fp8"), ref)
