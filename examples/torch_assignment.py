"""Task placement on the PyTorch port: replication groups, speed-aware
packing, and the jointly optimal (k, assignment) decision.

    PYTHONPATH=src python examples/torch_assignment.py               # card
    PYTHONPATH=src python examples/torch_assignment.py --device cpu

The twin of ``examples/assignment.py``.  On a fleet where a third of the
workers are 3x slow:

1. placement ORDER at a fixed k (all CRN-paired: same service draws,
   pure placement effect);
2. the jointly optimal (k, assignment) at one load via
   ``Planner.co_plan`` — the whole (k x placement) grid is ONE call of
   the lane engine on ``--device``;
3. how the winning placement shifts with load.
"""
import argparse

from repro_torch.api import (AllWorkers, LoadAwareLatency, Planner,
                             RandomGroups, ReplicationGroups, RoundRobin,
                             Scenario, SpeedAware)
from repro_torch.core import Scaling, ShiftedExp

N = 12
DIST = ShiftedExp(1.0, 1.25)
SPEEDS = (3.0,) * 4 + (1.0,) * 8          # 4 slow machines, adjacent


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the lanes run (default cuda; cpu for the "
                         "host)")
    ap.add_argument("--num-jobs", type=int, default=1200)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    kw = dict(num_jobs=args.num_jobs, reps=args.reps, seed=0,
              device=args.device)
    sc = Scenario(DIST, Scaling.SERVER_DEPENDENT, N, worker_speeds=SPEEDS)
    lam_max = 1.0 / (DIST.mean() * N)
    law = LoadAwareLatency(preempt=False, **kw)
    out = {}

    print("=" * 70)
    print(f"1. placement order at fixed k=4, g=4 (groups of {N // 4}), "
          "low load")
    print("=" * 70)
    strategies = [
        ("all-workers fan-out", AllWorkers()),
        ("round-robin groups ", RoundRobin(g=4)),
        ("random groups      ", RandomGroups(g=4)),
        ("speed-aware packing", SpeedAware(g=4)),
        ("contiguous blocks  ", ReplicationGroups(g=4)),
    ]
    sc_k4 = Scenario(DIST, Scaling.SERVER_DEPENDENT, N, worker_speeds=SPEEDS,
                     candidate_ks=(4,))   # g=4 is only legal where 4 | k
    out["order"] = {}
    for label, a in strategies:
        surf = LoadAwareLatency(preempt=False, assignment=a,
                                **kw).surface(sc_k4, [0.1 * lam_max])
        out["order"][label.strip()] = float(surf.mean[0, 0])
        print(f"  {label}: mean latency {surf.mean[0, 0]:6.2f}")

    print()
    print("=" * 70)
    print("2. co-optimized (k, assignment) at one load — one engine call")
    print("=" * 70)
    candidates = [AllWorkers(), RoundRobin(), RandomGroups(), SpeedAware()]
    plan = Planner(law).co_plan(
        sc, candidates, objective=LoadAwareLatency(
            arrival_rate=0.5 * lam_max, preempt=False, **kw))
    out["plan"] = plan
    print(f"  k* = {plan.k}  placement = "
          f"{plan.assignment if plan.assignment is not None else AllWorkers()}")
    print("  envelope curve (per k, best placement): "
          + ", ".join(f"k={k}: {v:.1f}" for k, v in sorted(plan.curve.items())))
    print(f"  policy: {plan.policy}")

    print()
    print("=" * 70)
    print("3. the winning placement vs load (code rate pinned at k=4)")
    print("=" * 70)
    law_q = LoadAwareLatency(preempt=True, **kw)
    loads = [f * lam_max for f in (2.0, 4.0, 8.0, 12.0)]
    surf = law_q.co_surface(sc_k4, loads, candidates)
    cube = surf.metric("mean")
    for i, lam in enumerate(loads):
        k, a = surf.kstar("mean")[float(lam)]
        per = ", ".join(f"{type(c).__name__}={cube[j, i, 0]:.1f}"
                        for j, c in enumerate(candidates))
        print(f"  load {lam / lam_max:5.1f} x unit:  winner = "
              f"{type(a).__name__:12s} ({per})")
    out["cube"] = cube
    return out


if __name__ == "__main__":
    main()
