"""Load-aware adaptive control on a queued cluster, on the PyTorch port.

    PYTHONPATH=src python examples/torch_adaptive_load.py               # card
    PYTHONPATH=src python examples/torch_adaptive_load.py --steps 60 --device cpu

The twin of ``examples/adaptive_load.py``.  A stationary service-time
law, a NON-stationary workload: the Poisson arrival rate flips light ->
heavy -> light while n FCFS workers serve [n, k]-redundant jobs whose
remnants cannot be preempted.  The single-job planner (the paper's
objective) is blind to this — its k* never moves.  The load-aware
``AdaptivePlanner`` estimates the arrival rate and burstiness from job
timestamps, detects the flips with a block CUSUM, and re-plans through
the batched cluster engine at the estimated load, each re-plan a
surface-cache call on ``--device``.

The run is flight-recorded: every drift alarm, commit and engine call
lands on ``repro_torch.obs``'s recorder and is exported as a JSONL trace
whose ``python -m repro_torch.obs.report`` rendering reconstructs exactly
the commit log printed below (the example verifies the equality before
exiting).
"""
from __future__ import annotations

import argparse

from repro_torch.api import (AdaptivePlanner, LoadAwareLatency,
                             MeanCompletionTime, Planner, Scenario)
from repro_torch.control import replay
from repro_torch.control.controller import RedundancyController
from repro_torch.core import (BiModal, Regime, Scaling, ShiftedExp,
                              sample_regime_trace)
from repro_torch.core.scenario import PoissonArrivals
from repro_torch.obs import recording
from repro_torch.obs.report import (decision_log,
                                    decision_log_from_control_events,
                                    render_report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--steps", type=int, default=400,
                    help="steps per regime")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="trace_adaptive_load.jsonl",
                    help="flight-recorder JSONL export path "
                         "('' disables tracing)")
    ap.add_argument("--device", default="cuda",
                    help="where draws, surfaces and static lanes run "
                         "(default cuda; cpu for the host)")
    args = ap.parse_args(argv)

    n, steps, dev = args.n, args.steps, args.device
    service = ShiftedExp(1.0, 10.0)
    scaling = Scaling.SERVER_DEPENDENT
    trace = sample_regime_trace(
        [Regime(service, steps, arrivals=PoissonArrivals(0.001)),
         Regime(service, steps, arrivals=PoissonArrivals(0.03)),
         Regime(service, steps, arrivals=PoissonArrivals(0.001))],
        scaling, n, seed=args.seed, device=dev)

    single_job_k = Planner(MeanCompletionTime(device=dev)).plan(
        Scenario(service, scaling, n)).policy.k
    print(f"single-job k* (the paper's objective, load-blind): "
          f"k={single_job_k}")

    prior = Scenario(BiModal(10.0, 0.3), scaling, n)
    planner = AdaptivePlanner(
        prior, objective=LoadAwareLatency(num_jobs=600, reps=2,
                                          backend="cached", preempt=False,
                                          device=dev), device=dev)
    with recording() as rec:
        for r, reg in enumerate(trace.regimes):
            rec.event("mark", name="regime", regime=r, start_step=r * steps,
                      rate=reg.arrivals.rate)
        res = replay(trace, planner.controller, preempt=False, device=dev)

    print(f"\nregimes (steps per regime: {steps}):")
    for r, (lo, hi) in enumerate(trace.boundaries()):
        ks = sorted(set(int(k) for k in res.policy_k[lo:hi]))
        rate = trace.regimes[r].arrivals.rate
        print(f"  regime {r}: Poisson rate {rate:g}  ->  controller ran "
              f"k in {ks} (clairvoyant oracle: k={res.oracle_k[r]})")
    print("\ncommits:")
    for e in res.events:
        arr = "" if e.arrival is None else \
            f"  rate~{e.arrival.rate:.4f} disp~{e.arrival.dispersion:.2f}"
        cache = " [cached surface]" if e.cached else " [closed form]"
        print(f"  step {e.at // n:4d}  {e.kind:5s}  k {e.old_policy.k:2d}"
              f" -> {e.new_policy.k:2d}  {e.replan_ms:7.1f} ms{cache}{arr}")

    print(f"\nload-aware regret vs per-regime oracle: {res.regret:.1%}")
    sj = RedundancyController(prior, device=dev)
    res_sj = replay(trace, sj, preempt=False, device=dev)
    print(f"single-job-objective controller regret:  {res_sj.regret:.0%}")
    if res.regret < 0.5 * res_sj.regret:
        print("-> closing the loop on LOAD, not just the service law, "
              "is what pays under arrivals.")

    if decision_log(rec.events()) != \
            decision_log_from_control_events(res.events):
        print("ERROR: the flight recorder's trace disagrees with the live "
              "commit log above")
        return 1
    if args.trace:
        written = rec.export_jsonl(args.trace)
        print(f"\nflight recorder: {written} events -> {args.trace} "
              f"(decision log verified against the commits above)")
        print(f"render the run report with:  PYTHONPATH=src python -m "
              f"repro_torch.obs.report {args.trace}")
        print("\n" + render_report(rec.events()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
