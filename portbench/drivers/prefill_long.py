"""Long prompts prefilled back to back by one caller (a closed loop):
``launch.steps.build_prefill_cell``'s step, the logits of every
position.

Request i is ``batch`` rows of ``seq_len`` token ids drawn uniformly on
the device from (seed, i).  What is judged is the window's last request:
the token the program puts first at every position, and its logits at
``sampled_positions`` positions a row drawn from the seed.
"""
from __future__ import annotations

import torch

from .. import weights
from ..reference import compare, serve
from ..spec import program_config
from ..timing import sync

KIND = "prefill"
SYNC_EACH = True


def end_to_end(win) -> dict:
    return {"prefill_tokens_per_s": win.rate()}


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.mix, self.spec = cell.mix, cell.spec
        self.n = 0
        self.out = None

    @property
    def work_per_unit(self) -> int:
        return self.mix["batch"] * self.mix["seq_len"]

    def build(self) -> None:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import steps
        from repro_torch.models import api
        mix = self.mix
        pcfg = program_config(self.cell.config, self.cell.root)
        self.cell_fn = steps.build_prefill_cell(
            pcfg, ShapeConfig("prefill", "prefill", mix["seq_len"],
                              mix["batch"]), device=self.device).fn
        self.model = api.build(pcfg, self.device)
        weights.fill(self.model, self.spec, self.seed)

    def warm(self) -> None:
        self.run_units(self.mix["warmup_units"])
        sync(self.device)

    def prompt(self, i: int, device=None) -> torch.Tensor:
        device = device or self.device
        g = weights.generator(self.seed, device, "prompt", i)
        return torch.randint(0, self.spec.vocab,
                             (self.mix["batch"], self.mix["seq_len"]),
                             generator=g, device=device, dtype=torch.int32)

    def unit(self, remaining=None) -> None:
        self.out = None
        self.out = self.cell_fn(self.model, self.prompt(self.n))
        self.n += 1

    def run_units(self, n: int) -> dict:
        for _ in range(n):
            self.unit()
        return {"rows": self.mix["batch"], "seq": self.mix["seq_len"]}

    def sample(self) -> torch.Tensor:
        g = weights.generator(self.seed, "cpu", "sample")
        k, s = self.mix["sampled_positions"], self.mix["seq_len"]
        return torch.stack([torch.randperm(s, generator=g)[:k].sort().values
                            for _ in range(self.mix["batch"])])

    def judged(self) -> dict:
        lg = self.out
        sample = self.sample()
        rows = torch.arange(lg.shape[0])[:, None]
        out = {"request": self.n - 1, "served": lg.argmax(-1).cpu(),
               "sampled": lg[rows, sample.to(lg.device)].float().cpu(),
               "sample": sample}
        self.out = None
        return out

    def free(self) -> None:
        self.model = self.cell_fn = self.out = None

    def reference(self, outputs: dict, precision: str = "fp32") -> dict:
        P = weights.draw_all(self.spec, self.seed, self.device)
        prompt = self.prompt(outputs["request"])
        rows = []
        for b in range(self.mix["batch"]):
            rows.append(serve.prefill_row(
                self.spec, P, prompt[b].long(),
                outputs["served"][b].to(self.device),
                outputs["sample"][b].to(self.device), precision))
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def control_numbers(self, outputs: dict, ref: dict) -> dict:
        """The fp32 reference read again at the tokens the fp8 reference
        puts first, and the fp8 reference's sampled logits."""
        low = self.reference(outputs, "fp8")
        low = {"request": outputs["request"], "served": low["top"].cpu(),
               "sampled": low["sampled"].cpu(), "sample": outputs["sample"]}
        return self.numbers(low, self.reference(low))

    def numbers(self, outputs: dict, ref: dict) -> dict:
        return {"token_gap": compare.token_gap(ref["best"], ref["served"]),
                "logit_err": compare.logit_error(outputs["sampled"],
                                                 ref["sampled"].cpu())}
