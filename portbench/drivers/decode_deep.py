"""Greedy decode at depth: ``launch.steps.build_decode_cell``'s step.

A batch of ``batch`` rows over a ``cache_len``-position cache drawn from
N(0, 1) on the device from the seed (in the cache's dtype, layer by
layer), standing for a prefilled context.  Step i feeds each row's last
token at position ``first_position`` + (i mod ``span``); the step's
argmax is fed back.  The work a step is fixed and no memory grows.

What is judged is the newest run of steps from ``first_position`` on (or
the one before, where the newest is shorter than ``min_judged``): the
tokens fed and served, and the cache rows those steps wrote that no later
step overwrote.  The reference feeds the same tokens after the same
drawn prefix.
"""
from __future__ import annotations

import torch

from .. import weights
from ..reference import compare, serve
from ..spec import program_config
from ..timing import sync

KIND = "decode"
SYNC_EACH = False
MAX_STEPS = 1 << 20


def end_to_end(win) -> dict:
    """The device's busy time a step, over profiled stretches of the mix's
    ``profiled_units`` steps once the window has closed: the step's cost
    on the card, which the host's issue speed does not change.  The
    window's own rate and gaps, which the host paces, are the per-layer
    ``wall_*.decode``."""
    if win.device_s_per_unit is None:
        return {}
    return {"decode_device_ms_per_step": win.device_s_per_unit * 1e3}


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.mix, self.spec = cell.mix, cell.spec
        self.n = 0

    @property
    def work_per_unit(self) -> int:
        return self.mix["batch"]

    def build(self) -> None:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import steps
        from repro_torch.models import api
        mix, spec = self.mix, self.spec
        pcfg = program_config(self.cell.config, self.cell.root)
        b, s = mix["batch"], mix["cache_len"]
        self.cell_fn = steps.build_decode_cell(
            pcfg, ShapeConfig("decode", "decode", s, b),
            device=self.device).fn
        self.model = api.build(pcfg, self.device)
        weights.fill(self.model, spec, self.seed)
        self.cache = api.init_cache(pcfg, b, s, mix["cache_dtype"],
                                    self.device)
        weights.fill_cache(*self.cache, self.seed)
        g = weights.generator(self.seed, self.device, "first_tokens")
        self.tok = torch.randint(0, spec.vocab, (b, 1), generator=g,
                                 device=self.device, dtype=torch.int32)
        self.fed = torch.empty((MAX_STEPS + 1, b), dtype=torch.int32,
                               device=self.device)

    def warm(self) -> None:
        self.run_units(self.mix["warmup_units"])
        sync(self.device)

    def position(self, i: int) -> int:
        return self.mix["first_position"] + i % self.mix["span"]

    def unit(self, remaining=None) -> None:
        if self.n >= MAX_STEPS:
            raise RuntimeError(f"more than {MAX_STEPS} decode steps")
        self.fed[self.n] = self.tok[:, 0]
        logits, self.cache = self.cell_fn(self.model, self.cache, self.tok,
                                          self.position(self.n))
        self.tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        self.n += 1

    def run_units(self, n: int) -> dict:
        first = self.n
        for _ in range(n):
            self.unit()
        return {"positions": [self.position(i)
                              for i in range(first, self.n)],
                "rows": self.mix["batch"]}

    def judged(self) -> dict:
        span, n = self.mix["span"], self.n
        start = (n - 1) // span * span
        end = n
        if end - start < self.mix["min_judged"] and start >= span:
            start, end = start - span, start
        over = n - end if end < n else 0      # positions written later
        self.fed[n] = self.tok[:, 0]
        p0 = self.mix["first_position"]
        kc, vc = self.cache
        rows = slice(p0 + over, p0 + (end - start))
        return {"fed": self.fed[start:end + 1].cpu(), "over": over,
                "k": kc[:, :, rows].cpu(), "v": vc[:, :, rows].cpu()}

    def free(self) -> None:
        self.model = self.cache = self.cell_fn = self.fed = None

    def reference(self, outputs: dict, precision: str = "fp32") -> dict:
        mix, spec, dev = self.mix, self.spec, self.device
        P = weights.draw_all(spec, self.seed, dev)
        shape = (mix["batch"], mix["cache_len"], spec.kv_heads,
                 spec.head_dim)
        dtype = getattr(torch, mix["cache_dtype"])
        p0 = mix["first_position"]

        def prefix(layer):
            return tuple(weights.cache_layer(self.seed, w, layer, shape,
                                             dtype, dev)[:, :p0]
                         for w in ("k", "v"))
        tokens = outputs["fed"][:-1].T.contiguous().to(dev)
        lg, k, v = serve.decode(spec, P, tokens, p0, prefix, precision)
        return {"logits": lg, "k": k, "v": v}

    def control_numbers(self, outputs: dict, ref: dict) -> dict:
        """The fp32 reference's readings of the tokens the fp8 reference
        puts first at the same positions, and of its cache rows."""
        low = self.reference(outputs, "fp8")
        fed = outputs["fed"].clone()
        fed[1:] = low["logits"].argmax(-1).T.cpu().to(fed.dtype)
        over = outputs["over"]
        return self.numbers({"fed": fed, "over": over,
                             "k": low["k"][:, :, over:].cpu(),
                             "v": low["v"][:, :, over:].cpu()}, ref)

    def numbers(self, outputs: dict, ref: dict) -> dict:
        lg = ref["logits"]
        served = outputs["fed"][1:].T.to(lg.device).long()
        best = lg.max(-1).values
        at = lg.gather(-1, served[..., None])[..., 0]
        over = outputs["over"]
        return {"token_gap": compare.token_gap(best, at),
                "cache_err": max(
                    compare.row_error(outputs["k"], ref["k"][:, :, over:]
                                      .cpu()),
                    compare.row_error(outputs["v"], ref["v"][:, :, over:]
                                      .cpu()))}
