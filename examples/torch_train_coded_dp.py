"""End-to-end training with coded data parallelism, on the PyTorch port.

    PYTHONPATH=src python examples/torch_train_coded_dp.py --steps 300    # card
    PYTHONPATH=src python examples/torch_train_coded_dp.py --steps 12 \\
        --d-model 64 --layers 2 --vocab 512 --seq 32 --device cpu

The twin of ``examples/train_coded_dp.py``: a small LM (default ~64M
parameters, the qwen3-0.6b family at reduced width) trains for a few
hundred steps with coded data parallelism, simulated stragglers, online
re-planning, async checkpointing and an optional mid-run elastic resize,
through the same ``CodedTrainer`` that ``launch.train`` drives at full
width.  Checkpoints go to ``build/torch_coded_dp_ckpt`` under the
repository (``--ckpt-dir``); a second run resumes from them.
"""
import argparse
import time
from pathlib import Path

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch._device import generator, resolve
from repro_torch.api import FRCompletionTime, Planner, Scenario
from repro_torch.configs.base import get_config
from repro_torch.core.distributions import BiModal, Scaling
from repro_torch.data import DataConfig
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.runtime import (CodedStepConfig, CodedTrainer, StragglerSim,
                                 Telemetry, resize_plan)

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_coded_dp_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--resize-at", type=int, default=0,
                    help="elastic resize 8->6 workers at this step (0=off)")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32_000)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    # default ~64M params (qwen3 family, 8 x 512, 32k vocab); shrink via
    # --d-model/--layers/--vocab/--seq for CPU-budget runs
    cfg = get_config("qwen3-0.6b").scaled(
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(args.d_model // 64, 2),
        num_kv_heads=max(args.d_model // 128, 1), head_dim=64,
        d_ff=4 * args.d_model, vocab_size=args.vocab, remat="none",
        compute_dtype="float32", param_dtype="float32", flash_block_kv=128)
    params = api.init_params(cfg, generator(0, device), trainable=True)
    print(f"params: {sum(p.numel() for p in params.parameters())/1e6:.1f}M")

    n = 8
    dist = BiModal(8.0, 0.25)
    scaling = Scaling.DATA_DEPENDENT
    fr = Planner(FRCompletionTime(device=device)).plan(
        Scenario(dist, scaling, n, delta=1.0))
    policy = fr.policy
    print(f"initial plan: {policy} (c* = {policy.c}) "
          f"E[T] = {fr.expected_time:.2f} (k-curve {fr.curve})")

    step_cfg = CodedStepConfig.from_policy(policy, unique_batch=8)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=8)
    opt_cfg = adamw.AdamWConfig(lr=6e-4, warmup_steps=20,
                                decay_steps=args.steps)
    sim = StragglerSim(dist, scaling, n=n, s=policy.task_size, delta=1.0,
                       seed=3, device=device)
    trainer = CodedTrainer(cfg, data_cfg, step_cfg, opt_cfg,
                           alive_fn=sim.alive_fn(deadline=4.0))
    telem = Telemetry()
    opt_state = adamw.init(opt_cfg, params)

    start = 0
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest:
        restored, _ = ckpt.restore(args.ckpt_dir, latest,
                                   {"p": params, "o": opt_state},
                                   device=device)
        for name, p in params.named_parameters():
            p.data.copy_(restored["p"][name])
        opt_state = restored["o"]
        start = latest
        print(f"resumed from {latest}")

    losses, pending = [], None
    t0 = time.time()
    for step in range(start, args.steps):
        if args.resize_at and step == args.resize_at:
            new_cfg = resize_plan(trainer.step_cfg, 6, dist=dist,
                                  scaling=scaling, delta=1.0, device=device)
            print(f"ELASTIC RESIZE @ {step}: n 8->6, c*={new_cfg.c}")
            sim = StragglerSim(dist, scaling, n=6, s=new_cfg.c,
                               delta=1.0, seed=4, device=device)
            trainer.step_cfg = new_cfg
            trainer.alive_fn = sim.alive_fn(deadline=4.0)
        params, opt_state, m = trainer.run_step(params, opt_state, step)
        telem.record_step(sim.sample_times(step), trainer.step_cfg.c)
        losses.append(float(m["loss"]))
        if (step + 1) % 25 == 0:
            print(f"step {step+1:4d}  loss {np.mean(losses[-25:]):.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"dropped {trainer.stragglers_dropped}  "
                  f"fallbacks {trainer.decode_failures}")
        if (step + 1) % 50 == 0:
            if pending:
                pending.result()
            pending = ckpt.save_async(args.ckpt_dir, step + 1,
                                      {"p": params, "o": opt_state})
    if pending:
        pending.result()
    dt = time.time() - t0
    print(f"\n{args.steps - start} steps in {dt/60:.1f} min; "
          f"loss {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f}")
    fit, family = telem.fit()
    print(f"telemetry fit: {family} {fit}; stats {telem.straggle_stats()}")
    if np.mean(losses[-10:]) >= np.mean(losses[:10]):
        raise SystemExit("no learning: the loss did not decrease")
    print("OK: loss decreased under coded-DP with stragglers")


if __name__ == "__main__":
    main()
