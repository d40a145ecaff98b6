"""Load-aware planning on the PyTorch port: the k* x load surface on the
batched cluster engine.

    PYTHONPATH=src python examples/torch_load_sweep.py               # card
    PYTHONPATH=src python examples/torch_load_sweep.py --device cpu

The twin of ``examples/load_sweep.py``.  The paper scores one job in an
empty system; under arrivals, redundancy also inflates server occupancy,
so the optimal k shifts with load.  Each map below is ONE call of the
batched lane engine (``runtime.cluster_batched``) on ``--device``:

1. the k* x load map for a Bi-Modal straggler cluster;
2. the same map under BURSTY (MMPP) arrivals;
3. a heterogeneous fleet (two 3x-slow workers).
"""
import argparse

import numpy as np

from repro_torch.api import (LoadAwareLatency, MeanCompletionTime,
                             MMPPArrivals, Planner, Scenario)
from repro_torch.core import BiModal, Scaling

N = 12
LOADS = [0.01, 0.06, 0.12, 0.20]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the lanes run (default cuda; cpu for the "
                         "host)")
    ap.add_argument("--num-jobs", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    dev = args.device
    planner = Planner(MeanCompletionTime(device=dev))
    kw = dict(num_jobs=args.num_jobs, reps=args.reps, seed=0, device=dev)

    print("=" * 70)
    print("1. k* vs load, Bi-Modal(B=10, eps=0.3) additive, Poisson arrivals")
    print("=" * 70)
    sc = Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, N)
    law = LoadAwareLatency(**kw)
    surface = law.surface(sc, LOADS)
    print(f"  {'load':>6s} | " + " ".join(f"k={k:<4d}" for k in surface.ks))
    for i, lam in enumerate(surface.loads):
        row = " ".join(f"{surface.mean[i, j]:6.1f}"
                       for j in range(len(surface.ks)))
        print(f"  {lam:6.2f} | {row}")
    print("  k* map:", planner.kstar_vs_load(sc, LOADS, law))
    print("  (load -> 0 recovers the paper's single-job k* ="
          f" {planner.plan(sc).k})")

    print()
    print("=" * 70)
    print("2. the same cluster under MMPP burst arrivals (tail view, p99)")
    print("=" * 70)
    sc_burst = Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, N,
                        arrivals=MMPPArrivals(rate=1.0, slow=0.2, burst=5.0,
                                              switch=0.02))
    tail = LoadAwareLatency(metric="p99", **kw)
    burst_surface = tail.surface(sc_burst, LOADS)
    for i, lam in enumerate(LOADS):
        smooth = {k: surface.p99[i, j] for j, k in enumerate(surface.ks)}
        bursty = {k: burst_surface.p99[i, j]
                  for j, k in enumerate(burst_surface.ks)}
        ks_s = min(smooth, key=smooth.get)
        ks_b = min(bursty, key=bursty.get)
        print(f"  load {lam:5.2f}:  p99-k* poisson={ks_s:2d} "
              f"(p99 {smooth[ks_s]:6.1f})   mmpp={ks_b:2d} "
              f"(p99 {bursty[ks_b]:6.1f})")

    print()
    print("=" * 70)
    print("3. heterogeneous fleet: two 3x-slow workers in the same sweep")
    print("=" * 70)
    sc_het = Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, N,
                      worker_speeds=(1,) * 10 + (3.0, 3.0))
    het = law.surface(sc_het, LOADS)
    print("  homogeneous k*:", surface.kstar())
    print("  heterogeneous k*:", het.kstar())
    slow_penalty = het.mean / np.maximum(surface.mean, 1e-9)
    print(f"  mean-latency inflation from the slow pair: "
          f"{slow_penalty.min():.2f}x .. {slow_penalty.max():.2f}x")
    return {"poisson": surface, "mmpp": burst_surface, "hetero": het}


if __name__ == "__main__":
    main()
