"""Quickstart on the PyTorch port: the paper's diversity/parallelism
planner in five minutes.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The twin of ``examples/quickstart.py``:

1. State each problem as a typed ``Scenario`` and ask the ``Planner`` for
   the optimal redundancy ``Policy`` (paper Table I live; the analytic
   engine is host numpy, so these lines are the reference's).
2. Cross-check with Monte-Carlo on ``--device``, and swap in a tail
   objective.
3. Dispatch a real coded mat-vec job (the paper's Fig. 2 exemplar) on
   ``--device`` and complete it from the fastest k workers.
"""
import argparse

import numpy as np
import torch

from repro_torch._device import generator
from repro_torch.api import (MeanCompletionTime, Planner,
                             QuantileCompletionTime, Scenario)
from repro_torch.core import (BiModal, Pareto, Scaling, ShiftedExp,
                              decode_blocks, encode_blocks,
                              expected_completion_time, mds_generator)
from repro_torch.core.simulator import (expected_completion_mc,
                                        sample_task_times)

N = 12   # workers = job size in computing units (CUs)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the draws and the coded job run (default "
                         "cuda; cpu for the host)")
    ap.add_argument("--trials", type=int, default=40_000,
                    help="Monte-Carlo trials of section 2")
    args = ap.parse_args(argv)
    dev = args.device
    planner = Planner(MeanCompletionTime(device=dev))

    print("=" * 70)
    print("1. How much redundancy should this cluster use?")
    print("=" * 70)
    for scenario, label in [
        (Scenario(ShiftedExp(1.0, 10.0), Scaling.SERVER_DEPENDENT, N),
         "S-Exp(1,10), server-dependent straggling"),
        (Scenario(ShiftedExp(10.0, 1.0), Scaling.DATA_DEPENDENT, N),
         "S-Exp(10,1), data-dependent (deterministic work dominates)"),
        (Scenario(Pareto(1.0, 1.5), Scaling.SERVER_DEPENDENT, N),
         "Pareto(1,1.5), heavy-tailed servers"),
        (Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, N),
         "Bi-Modal(B=10, eps=0.3), additive per-CU times"),
    ]:
        p = planner.plan(scenario)
        print(f"  {label:55s} -> {p.strategy:11s} k*={p.k:2d} "
              f"(rate {p.code_rate:.2f}, c={p.policy.c}) "
              f"E[T]={p.expected_time:.2f}"
              + (f"  [{p.theorem_name}]" if p.theorem_name else ""))

    # tail-aware planning is one objective swap away from the same scenario
    tail_sc = Scenario(BiModal(10_000.0, 5e-4), Scaling.SERVER_DEPENDENT, N)
    k_mean = planner.plan(tail_sc).k
    k_q99 = planner.plan(tail_sc, QuantileCompletionTime(0.99,
                                                         device=dev)).k
    print(f"  rare huge stragglers: mean objective k*={k_mean}, "
          f"p99 objective k*={k_q99} (the tail changes the plan)")

    print()
    print("=" * 70)
    print("2. Closed form vs Monte-Carlo (k = 6, Bi-Modal additive)")
    print("=" * 70)
    dist = BiModal(10.0, 0.3)
    cf = expected_completion_time(dist, Scaling.ADDITIVE, 6, N)
    mc = expected_completion_mc(dist, Scaling.ADDITIVE, 6, N,
                                trials=args.trials, device=dev)
    print(f"  E[Y_6:12] closed-form {cf:.4f}   MC {mc:.4f}")

    print()
    print("=" * 70)
    print("3. A real coded job: A @ x with any-k-of-n completion (Fig. 2)")
    print("=" * 70)
    k = 6
    M, D = 1200, 256                     # 12 CUs of 100 rows each
    A = torch.randn((M, D), generator=generator(0, dev), device=dev)
    x = torch.randn((D,), generator=generator(1, dev), device=dev)
    blocks = A.reshape(k, M // k, D)     # k source tasks
    G = mds_generator(N, k)
    coded_tasks = encode_blocks(G, blocks)            # n coded tasks

    # each "worker" computes its coded block times x; sample who finishes
    outs = torch.einsum("nmd,d->nm", coded_tasks, x)
    times = sample_task_times(BiModal(10.0, 0.3), generator(2, dev), 1, N,
                              s=N // k, scaling=Scaling.ADDITIVE)[0]
    times = times.cpu().numpy()
    fastest = np.argsort(times)[:k]
    print(f"  completion times: {np.round(times, 2)}")
    print(f"  fastest k={k} workers: {sorted(fastest.tolist())} "
          f"(job done at t={float(np.sort(times)[k - 1]):.2f}, "
          f"vs splitting t={float(times.max()):.2f})")
    survivors = sorted(fastest.tolist())
    decoded = decode_blocks(G, survivors, outs[survivors])     # (k, M/k)
    full = (A @ x).reshape(k, M // k)
    err = float((decoded - full).abs().max() / full.abs().max())
    print(f"  decode rel error vs direct A@x: {err:.2e}  -> exact recovery")
    # fp32 Vandermonde decode at n=12 lands just above 1e-4 (quickstart.py)
    assert err < 1e-3
    return err


if __name__ == "__main__":
    main()
