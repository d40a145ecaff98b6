"""The reference's training steps: fp32 forward and autograd
backward row by row (each layer recomputed in the backward), the loss
weighted by the decode coefficients, then AdamW (clip to the global norm,
warmup-cosine schedule, bias-corrected moments, decoupled weight decay).

What the program's steps are compared on: each step's loss, a step's
gradient as the optimizer takes it (after clipping) by leaf, and each
leaf's change: after the first steps from the drawn weights, or in one
step from the program's own state.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from .. import weights
from ..spec import Spec
from . import data
from .model import row_loss
from .numerics import Numerics


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["decay_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    ratio = opt["min_lr_ratio"]
    return opt["lr"] * warm * (ratio + (1 - ratio) * 0.5
                               * (1 + math.cos(math.pi * t)))


def _grad_step(spec: Spec, num: Numerics, mix: dict, seed: int,
               alive: np.ndarray, step: int, P: Dict, device) -> float:
    """The coded batch of ``step``'s loss, its gradient left in each leaf's
    ``grad``; only the rows of non-zero weight are computed."""
    n_rows = mix["unique_rows"] * mix["c"]
    toks, labs, w = data.coded_rows(
        spec.vocab, mix["seq_len"], mix["unique_rows"], mix["n_workers"],
        mix["c"], seed, step, alive)
    total = 0.0
    for r in np.nonzero(w)[0]:
        tk = torch.from_numpy(toks[r:r + 1]).to(device)
        lb = torch.from_numpy(labs[r:r + 1]).to(device)
        loss = row_loss(spec, num, P, tk, lb)[0] * float(w[r]) / n_rows
        loss.backward()
        total += float(loss.detach())
    return total


@torch.no_grad()
def _adamw(opt: dict, P: Dict, m: Dict, v: Dict, t: int) -> Dict[str, float]:
    """AdamW's update ``t`` (from 1) in place; returns each leaf's gradient
    norm as the update took it, after clipping."""
    grads = {n: p.grad for n, p in P.items()}
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-12))
    lr = lr_at(opt, t)
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    norms = {n: float(g.norm()) * scale for n, g in grads.items()}
    for n, p in P.items():
        g = grads[n] * scale
        m[n].mul_(b1).add_(g, alpha=1 - b1)
        v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m[n] / c1) / ((v[n] / c2).sqrt() + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
        p.grad = None
    return norms


def run_steps(spec: Spec, mix: dict, seed: int,
              alive: Callable[[int], np.ndarray], steps: int, device,
              precision: str = "fp32") -> Dict:
    """The first ``steps`` steps from the drawn weights: each step's loss,
    the first step's gradient by leaf and each leaf's change after them."""
    num = Numerics(precision)
    shapes = weights.param_shapes(spec)
    P = {n: weights.draw(spec, n, sh, seed, device).requires_grad_(True)
         for n, sh in shapes.items()}
    m = {n: torch.zeros_like(p) for n, p in P.items()}
    v = {n: torch.zeros_like(p) for n, p in P.items()}
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        losses.append(_grad_step(spec, num, mix, seed, alive(t - 1), t - 1,
                                 P, device))
        norms = _adamw(mix["optimizer"], P, m, v, t)
        if t == 1:
            grad1 = norms
    with torch.no_grad():
        change = {n: float((p - weights.draw(spec, n, shapes[n], seed,
                                             device)).norm())
                  for n, p in P.items()}
    return {"losses": losses, "grad1": grad1, "change": change}


def one_step(spec: Spec, mix: dict, seed: int,
             alive: Callable[[int], np.ndarray], step: int, params: Dict,
             mu: Dict, nu: Dict, device, precision: str = "fp32") -> Dict:
    """Step ``step`` (from 0) taken from a given state, the parameters and
    moments before it (left as they are): its loss, its gradient by leaf
    and each leaf's change in it."""
    num = Numerics(precision)
    P = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in params.items()}
    m = {n: t.float().clone() for n, t in mu.items()}
    v = {n: t.float().clone() for n, t in nu.items()}
    loss = _grad_step(spec, num, mix, seed, alive(step), step, P, device)
    grad = _adamw(mix["optimizer"], P, m, v, step + 1)
    with torch.no_grad():
        change = {n: float((p - params[n].float()).norm())
                  for n, p in P.items()}
    return {"losses": [loss], "grad1": grad, "change": change}
