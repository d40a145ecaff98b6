"""A fixture traffic kind, added as a file of its own: rows of text
scored by the program's prefill path (``models.api.forward``, then each
row's mean token cross-entropy), one batch a unit.  Judged: the window's
last batch's scores against the reference's."""
from __future__ import annotations

import torch

from .. import weights
from ..reference import model
from ..reference.numerics import Numerics
from ..spec import program_config, spec_of

KIND = "score"
SYNC_EACH = True


def end_to_end(win) -> dict:
    return {"score_tokens_per_s": win.rate()}


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.mix, self.spec = cell.mix, spec_of(cell.config)
        self.n = 0

    @property
    def work_per_unit(self) -> int:
        return self.mix["batch"] * self.mix["seq_len"]

    def build(self) -> None:
        from repro_torch.models import api
        self.pcfg = program_config(self.cell.config)
        self.api = api
        self.model = api.build(self.pcfg, self.device)
        weights.fill(self.model, self.spec, self.seed)

    def warm(self) -> None:
        self.run_units(self.mix["warmup_units"])

    def rows(self, i: int):
        g = weights.generator(self.seed, self.device, "score", i)
        t = torch.randint(0, self.spec.vocab, (self.mix["batch"],
                                               self.mix["seq_len"] + 1),
                          generator=g, device=self.device)
        return t[:, :-1], t[:, 1:]

    def unit(self, remaining=None):
        toks, labs = self.rows(self.n)
        with torch.no_grad():
            lg = self.api.forward(self.pcfg, self.model, toks)
        self.scores = model.token_nll(lg[..., :self.spec.vocab].float(),
                                      labs).mean(-1)
        self.n += 1
        return self.scores.sum()

    def run_units(self, n: int) -> dict:
        for _ in range(n):
            self.unit()
        return {"rows": self.mix["batch"], "seq": self.mix["seq_len"]}

    def judged(self) -> dict:
        return {"batch": self.n - 1, "scores": self.scores.cpu()}

    def free(self) -> None:
        self.model = self.api = None

    def reference(self, outputs: dict, precision: str = "fp32") -> dict:
        P = weights.draw_all(self.spec, self.seed, self.device)
        toks, labs = self.rows(outputs["batch"])
        with torch.no_grad():
            scores = model.row_loss(self.spec, Numerics(precision), P, toks,
                                    labs, remat=False)
        return {"scores": scores.cpu()}

    def numbers(self, outputs: dict, ref: dict) -> dict:
        gap = (outputs["scores"] - ref["scores"]).abs() / ref["scores"].abs()
        return {"score_gap": float(gap.max())}

    def control_numbers(self, outputs: dict, ref: dict) -> dict:
        return self.numbers(self.reference(outputs, "fp8"), ref)
