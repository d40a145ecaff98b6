"""Training driver: coded data parallelism with online re-planning (a port
of the JAX package's ``launch/train.py``).

Runs the control loop of DESIGN.md §2 on one device, with simulated
straggling:

  1. each step is dispatched as an [n, c] fractional-repetition coded job;
  2. per-worker completion times land in Telemetry;
  3. every ``replan_every`` steps the best-fit service model is re-fitted
     and the replication factor c* re-planned (paper Secs. IV-VI / Table I);
  4. async checkpoints every ``ckpt_every`` steps; restart resumes from the
     latest complete checkpoint (``checkpoint``, the reference's layout).

Every architecture trains at ``--scale tiny`` and ``small``: as in the
reference, those scales set ``num_experts=0`` and
``embedding_inputs=False`` (every family is then a token-input model; an
encoder stays bidirectional) and ``attn_every=0`` (a tiny zamba2 is a
pure SSM).  At ``--scale full`` the dense, MoE, SSM and hybrid families
train; an embedding-input config (hubert-xlarge, internvl2-76b) raises,
since the coded batches are token ids: it trains through
``launch.steps.build_train_cell``, as it does in the reference.

    python -m repro_torch.launch.train --arch qwen3-0.6b --scale tiny \\
        --steps 50 --n-workers 8 --straggle bimodal:10:0.3 \\
        --ckpt-dir build/ckpt [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import torch

from .. import checkpoint as ckpt
from .._device import DEFAULT_DEVICE, generator, resolve
from ..api import Scenario
from ..configs.base import ModelConfig, get_config
from ..core.distributions import Scaling, ShiftedExp
from ..data import DataConfig
from ..models import api
from ..optim import adamw
from ..runtime import (CodedStepConfig, CodedTrainer, StragglerSim,
                       Telemetry, best_fr_policy)
from .serve import TINY, parse_dist

SMALL = dict(num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
             d_ff=1024, vocab_size=2048, flash_block_kv=128,
             num_experts=0, attn_every=0, embedding_inputs=False,
             head_dim=None)


def exo_delta(dist, delta):
    """Exogenous per-CU delta for a Scenario: ShiftedExp carries its own
    shift, so only Pareto/Bi-Modal take the override (Sec. V-B, VI-B)."""
    return None if isinstance(dist, ShiftedExp) else delta


@dataclasses.dataclass
class TrainRun:
    """What ``main`` ran: the config, the trainer, the final parameters and
    optimizer state, the first step, one record per step (``step``,
    ``loss``, ``grad_norm``, ``lr``, ``c``, ``coded_rows``, the
    trainer's cumulative ``dropped`` and ``fallbacks``, and ``ms``: the
    step's device time by CUDA events on a card, host clock on the CPU)
    and the loop's host-clock seconds."""
    cfg: ModelConfig
    trainer: CodedTrainer
    params: torch.nn.Module
    opt_state: adamw.OptState
    start: int
    history: List[dict]
    seconds: float


def _mark(device: torch.device):
    """Now, as a recorded CUDA event on a card (read once, at the end) or
    the host clock elsewhere (the CPU runs a step synchronously)."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _ms(began, ended) -> float:
    if isinstance(began, float):
        return (ended - began) * 1e3
    return began.elapsed_time(ended)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--scale", choices=["tiny", "small", "full"], default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--unique-batch", type=int, default=8)
    ap.add_argument("--n-workers", type=int, default=8)
    ap.add_argument("--c", type=int, default=0, help="0 = plan from model")
    ap.add_argument("--straggle", default="bimodal:10:0.2")
    ap.add_argument("--deadline", type=float, default=5.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--replan-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = get_config(args.arch)
    if args.scale == "tiny":
        cfg = cfg.scaled(**{k: v for k, v in TINY.items()
                            if hasattr(cfg, k)})
    elif args.scale == "small":
        cfg = cfg.scaled(**{k: v for k, v in SMALL.items()
                            if hasattr(cfg, k)})
    if cfg.embedding_inputs:
        raise ValueError(
            f"{cfg.name} takes (B, S, d) embeddings and the coded batches "
            f"are token ids: train it through "
            f"launch.steps.build_train_cell, or at --scale tiny or small")

    dist = parse_dist(args.straggle)
    scaling = Scaling.DATA_DEPENDENT
    c = args.c
    if c == 0:
        if dist is not None:
            policy, _ = best_fr_policy(
                Scenario(dist, scaling, args.n_workers,
                         delta=exo_delta(dist, 1.0)), device)
            c = policy.c
        else:
            c = 1
    print(f"redundancy plan: n={args.n_workers} c={c} "
          f"(rate {(args.n_workers - c + 1)}/{args.n_workers})")

    step_cfg = CodedStepConfig(n_workers=args.n_workers, c=c,
                               unique_batch=args.unique_batch)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.unique_batch)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                decay_steps=max(args.steps, 100))

    sim = None
    alive_fn = None
    if dist is not None:
        sim = StragglerSim(dist, scaling, n=args.n_workers, s=c,
                           delta=1.0, seed=7, device=device)
        alive_fn = sim.alive_fn(args.deadline)

    trainer = CodedTrainer(cfg, data_cfg, step_cfg, opt_cfg,
                           alive_fn=alive_fn)
    telem = Telemetry(window=256)

    # ---- init or resume -------------------------------------------------
    start = 0
    params = api.init_params(cfg, generator(0, device), trainable=True)
    opt_state = adamw.init(opt_cfg, params)
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            restored, _ = ckpt.restore(args.ckpt_dir, latest,
                                       {"p": params, "o": opt_state},
                                       device=device)
            with torch.no_grad():
                for name, p in params.named_parameters():
                    p.copy_(restored["p"][name])
            opt_state = restored["o"]
            start = latest
            print(f"resumed from step {start}")

    history = []
    pending = None
    t0 = time.time()
    for step in range(start, args.steps):
        began = _mark(device)
        params, opt_state, metrics = trainer.run_step(params, opt_state, step)
        history.append(dict(step=step + 1, loss=metrics["loss"],
                            grad_norm=metrics["grad_norm"], lr=metrics["lr"],
                            c=trainer.step_cfg.c,
                            coded_rows=trainer.step_cfg.coded_batch_rows,
                            dropped=trainer.stragglers_dropped,
                            fallbacks=trainer.decode_failures,
                            ms=(began, _mark(device))))
        if sim is not None:
            telem.record_step(sim.sample_times(step), task_size=c)
        if (step + 1) % 10 == 0:
            print(f"step {step+1:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"dropped {trainer.stragglers_dropped} "
                  f"barrier-fallbacks {trainer.decode_failures}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.result()
            pending = ckpt.save_async(args.ckpt_dir, step + 1,
                                      {"p": params, "o": opt_state})
        if dist is not None and (step + 1) % args.replan_every == 0 \
                and telem.num_samples >= 32:
            fitted, family = telem.fit()
            new_policy, _ = best_fr_policy(
                Scenario(fitted, scaling, args.n_workers,
                         delta=exo_delta(fitted, 1.0)), device)
            if new_policy.c != trainer.step_cfg.c:
                print(f"re-plan @ {step+1}: fitted {family} -> "
                      f"c* = {new_policy.c} (was {trainer.step_cfg.c})")
                trainer.step_cfg = CodedStepConfig.from_policy(
                    new_policy, unique_batch=args.unique_batch)
    if pending is not None:
        pending.result()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    for rec in history:
        rec.update(loss=float(rec["loss"]), grad_norm=float(rec["grad_norm"]),
                   ms=_ms(*rec["ms"]))
    print(f"done: {args.steps - start} steps in {dt:.1f}s "
          f"({(args.steps - start)/max(dt,1e-9):.2f} steps/s)")
    return TrainRun(cfg, trainer, params, opt_state, start, history, dt)


if __name__ == "__main__":
    main()
