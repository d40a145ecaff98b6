"""Adaptive coded training on the PyTorch port: the control loop re-plans
k mid-run.

    PYTHONPATH=src python examples/torch_adaptive_train.py --steps 120    # card
    PYTHONPATH=src python examples/torch_adaptive_train.py --device cpu

The twin of ``examples/adaptive_train.py``.  A small LM trains with coded
data parallelism on n=8 workers whose service times come from the
paper's models.  Mid-run the WORLD changes: the fleet flips from
deterministic-dominated work (S-Exp(1, 0.25) per CU -- optimal plan:
splitting, k=8) to heavy two-mode straggling (Bi-Modal(B=8, eps=0.25) --
optimal plan: coding, k=4).  Nothing tells the trainer: the
``AdaptivePlanner`` watches the per-CU step-barrier times, its CUSUM
detector flags the drift, the post-change window is refit by exact
likelihood, and the ``TrainerActuator`` swaps the coded step config in
place (the step rebuilds; training continues).

Watch the decode-failure counter: under the stale k=8 plan every dropped
straggler is a whole part group (full-barrier fallback each step); after
the re-plan to k=4 each part group has 2 workers and the step rides
through stragglers.
"""
import argparse
import time

import numpy as np

from repro_torch._device import generator, resolve
from repro_torch.api import AdaptivePlanner, Scenario
from repro_torch.configs.base import get_config
from repro_torch.control import TrainerActuator
from repro_torch.core.distributions import BiModal, Scaling, ShiftedExp
from repro_torch.data import DataConfig
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.runtime import CodedStepConfig, CodedTrainer, StragglerSim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--flip-at", type=int, default=50,
                    help="step at which the service regime flips")
    ap.add_argument("--deadline", type=float, default=4.0,
                    help="per-CU barrier timeout (task deadline = s*delta "
                         "+ (deadline - delta))")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = get_config("qwen3-0.6b").scaled(
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(args.d_model // 64, 2),
        num_kv_heads=max(args.d_model // 128, 1), head_dim=64,
        d_ff=4 * args.d_model, vocab_size=args.vocab, remat="none",
        compute_dtype="float32", param_dtype="float32", flash_block_kv=64)
    params = api.init_params(cfg, generator(0, device), trainable=True)
    print(f"params: {sum(p.numel() for p in params.parameters())/1e6:.1f}M")

    n, delta = 8, 1.0
    scaling = Scaling.DATA_DEPENDENT
    regimes = {0: ShiftedExp(delta, 0.25),        # deterministic-dominated
               args.flip_at: BiModal(8.0, 0.25)}  # heavy straggling
    # prior = the pre-flip world (its shift == the exogenous delta, so the
    # Scenario delta contract is satisfied); planner: k*=8 (splitting)
    planner = AdaptivePlanner(
        Scenario(regimes[0], scaling, n, delta=delta), device=device)
    policy = planner.policy
    print(f"prior plan: {policy} ({policy.strategy})")

    trainer = CodedTrainer(
        cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=8),
        CodedStepConfig.from_policy(policy, unique_batch=8),
        adamw.AdamWConfig(lr=6e-4, warmup_steps=10, decay_steps=args.steps))
    planner.attach(TrainerActuator(trainer))

    dist = regimes[0]
    sim = StragglerSim(dist, scaling, n=n, s=1, delta=delta, seed=3,
                       device=device)
    opt_state = adamw.init(trainer.opt_cfg, params)
    losses, fallbacks_at = [], []
    t0 = time.time()
    for step in range(args.steps):
        if step in regimes and step > 0:
            dist = regimes[step]
            sim = StragglerSim(dist, scaling, n=n, s=1, delta=delta,
                               seed=4, device=device)
            print(f"--- step {step}: WORLD FLIPS to {dist} "
                  f"(the trainer is not told) ---")
        # the step barrier observes per-CU times; task times for the
        # current plan reuse the same realized noise (data-dep: s*delta+Z)
        cu = sim.sample_times(step)
        s_task = trainer.step_cfg.c
        task = s_task * delta + (cu - delta)
        fails_before = trainer.decode_failures
        trainer.alive_fn = lambda _s: task <= \
            s_task * delta + (args.deadline - delta)
        params, opt_state, m = trainer.run_step(params, opt_state, step)
        losses.append(float(m["loss"]))
        fallbacks_at.append(trainer.decode_failures - fails_before)
        event = planner.observe(cu)
        if event is not None and event.switched:
            print(f"step {step}: RE-PLAN ({event.kind}, fitted "
                  f"{event.family}) {event.old_policy} -> "
                  f"{event.new_policy} in {event.replan_ms:.2f} ms")
        if (step + 1) % 20 == 0:
            print(f"step {step+1:4d}  loss {np.mean(losses[-20:]):.4f}  "
                  f"k={planner.policy.k}  "
                  f"fallbacks/step {np.mean(fallbacks_at[-20:]):.2f}")
    dt = time.time() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s")
    print(f"final policy: {planner.policy} ({planner.policy.strategy}); "
          f"model: {planner.model.family} {planner.model.dist}")
    switches = [e for e in planner.events if e.switched and e.kind != "boot"]
    if not switches:
        raise SystemExit("expected the regime flip to trigger a re-plan")
    if planner.policy.k != 4:
        raise SystemExit(f"expected k = 4 after the flip, got {planner.policy}")
    pre = np.mean(fallbacks_at[args.flip_at:switches[-1].at // n])
    post = np.mean(fallbacks_at[switches[-1].at // n:])
    print(f"decode fallbacks/step: {pre:.2f} under stale k=8 -> "
          f"{post:.2f} after re-plan")
    if np.mean(losses[-10:]) >= np.mean(losses[:10]):
        raise SystemExit("no learning: the loss did not decrease")
    print("OK: drift detected, re-planned online, training kept converging")


if __name__ == "__main__":
    main()
