"""SLO-grade tail serving on the PyTorch port: plan against p99, observe
completions, re-plan through a flash crowd.

    PYTHONPATH=src python examples/torch_serve_slo.py                  # card
    PYTHONPATH=src python examples/torch_serve_slo.py --smoke --device cpu

The twin of ``examples/serve_slo.py``.  The controller's COMMITTED
objective is the p99 of the load-aware latency surface (not the mean),
so hysteresis, re-plan decisions and the hedged actuator's delay all
live in tail units.  A streaming SLO monitor watches realized completion
latencies against a target and feeds burn alarms into the same drift
machinery as the arrival and sojourn channels.  Every surface runs on
the chunked fleet engine (``chunk_size=128``) on ``--device``.

The trace is day traffic interrupted by a flash crowd.  Watch the
committed k walk from redundancy (k=6: day tail is straggler-bound)
to full splitting (k=12: spike tail is capacity-bound) and back.
"""
import argparse

import numpy as np

from repro_torch.api import LoadAwareLatency, Scenario
from repro_torch.control import RedundancyController, replay
from repro_torch.control.controller import (ControllerConfig,
                                            HedgedServeActuator)
from repro_torch.core import BiModal, Regime, Scaling, sample_regime_trace
from repro_torch.core.scenario import PoissonArrivals
from repro_torch.obs import SLOMonitor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="tiny trace (CI)")
    ap.add_argument("--device", default="cuda",
                    help="where draws, surfaces and static lanes run "
                         "(default cuda; cpu for the host)")
    args = ap.parse_args(argv)
    dev = args.device

    n, ks = 12, (4, 6, 12)
    service = BiModal(10.0, 0.2)
    scaling = Scaling.SERVER_DEPENDENT
    day, spike = 0.07, 0.28
    steps = (80, 60, 80) if args.smoke else (300, 240, 300)
    num_jobs, reps = (200, 2) if args.smoke else (500, 3)

    regimes = [
        Regime(service, steps[0], arrivals=PoissonArrivals(day)),
        Regime(service, steps[1], arrivals=PoissonArrivals(spike)),
        Regime(service, steps[2], arrivals=PoissonArrivals(day)),
    ]
    trace = sample_regime_trace(regimes, scaling, n, seed=3,
                                s_values=[1, 2, 3], device=dev)

    # 1. the committed objective IS the tail: every plan rides the p99
    #    row of the cached queueing surface
    objective = LoadAwareLatency(num_jobs=num_jobs, reps=reps,
                                 backend="cached", preempt=False,
                                 metric="p99", chunk_size=128, device=dev)
    slo = SLOMonitor(target=110.0, quantile=0.99,
                     fast_window=32, slow_window=256,
                     burn_threshold=4.0, min_count=32)
    hedge = HedgedServeActuator()
    ctl = RedundancyController(
        Scenario(service, scaling, n, candidate_ks=ks),
        objective=objective,
        config=ControllerConfig(arrival_refit_gaps=48, arrival_min_gaps=12,
                                sojourn_forget=0.98, sojourn_min_jobs=24,
                                sojourn_refit_gaps=32,
                                arrival_emergency_ratio=4.0),
        actuators=[hedge], slo=slo, device=dev)

    # 2. replay feeds realized (arrival, completion) pairs per job —
    #    the controller observes what a serving frontend observes
    res = replay(trace, ctl, preempt=False, device=dev)

    print("committed plans (p99 objective):")
    for e in res.events:
        tag = e.drift.kind if e.drift else e.kind
        rate = f" rate={e.arrival.rate:.3f}" if e.arrival else ""
        print(f"  job {e.at // n:4d}: k {e.old_policy.k:2d} -> "
              f"{e.new_policy.k:2d}  [{tag}]{rate}")

    edges = np.cumsum([0, *steps])
    names = ["day", "SPIKE", "day"]
    skip = [min(s // 4, 60) for s in steps]
    for i, nm in enumerate(names):
        kk, cnt = np.unique(res.policy_k[edges[i]:edges[i + 1]],
                            return_counts=True)
        mix = ", ".join(f"k={a}x{c}" for a, c in zip(kk, cnt))
        p99 = res.controller_regime_quantile(0.99, skip[i])[i]
        print(f"  {nm:5s}: p99 {p99:6.1f}  ({mix})")

    # 3. the hedged actuator's delay comes from the committed plan's
    #    tail curve; the SLO monitor summarizes the realized stream
    print(f"hedge delay {hedge.hedge_delay:.2f} "
          f"(source: {hedge.delay_source})")
    st = slo.state()
    print(f"SLO target {st['target']:.0f}: realized p99 "
          f"{st.get('quantile_estimate', float('nan')):.1f}, "
          f"margin {st['margin']:+.1%}, burn alarms {st['alarms']}, "
          f"healthy={st['healthy']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
