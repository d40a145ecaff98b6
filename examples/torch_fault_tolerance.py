"""Fault-tolerant fleet control, end to end, on the PyTorch port.

    PYTHONPATH=src python examples/torch_fault_tolerance.py              # card
    PYTHONPATH=src python examples/torch_fault_tolerance.py --steps 40 --device cpu

The twin of ``examples/fault_tolerance.py``.  A stationary service law, a NON-stationary FLEET: n workers serve
[n, k]-redundant jobs with a dominant deterministic part, so the
fault-free optimum is pure splitting (k = n, zero parity).  Mid-run a
crash storm kills three workers outright and adds background task loss
— every k = n job now fails (one lost task sinks it), and the static
plan's job-failure rate goes to ~100%.  The adaptive controller sees
only per-worker outcome masks: it estimates the loss rate (rule of
three), detects the storm with a failure-drift CUSUM, quarantines the
crash-loopers, floors redundancy on the live fleet, and — when the
storm ends — probationally restores the healed workers and returns to
full size.  See DESIGN.md §9.  The controller's estimators, detectors
and closed-form re-plans are host numpy; ``--device`` is where its
planner's objective would draw.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import MeanCompletionTime, Planner, Scenario
from repro_torch.control.controller import (ControllerConfig,
                                            RedundancyController)
from repro_torch.core import Scaling, ShiftedExp
from repro_torch.core.policy import RetryPolicy

N = 12
DELTA, W = 3.0, 1.0                    # work dominates straggle noise
TRUTH = Scenario(ShiftedExp(DELTA, W), Scaling.DATA_DEPENDENT, N)
STORM_DEAD = frozenset({3, 7, 11})
STORM_BG_LOSS = 0.05


def job(x_row, lost_row, active, task_n, k):
    """One [task_n, k] job on the ``active`` workers: (latency, ok)."""
    s = task_n / k
    done = sorted((s - 1.0) * DELTA + x_row[w]
                  for w in active if not lost_row[w])
    return (done[k - 1], True) if len(done) >= k else (None, False)


def run_phase(ctl, steps, dead, bg_loss, rng):
    lats, fails = [], 0
    static_fails = 0
    for _ in range(steps):
        x = DELTA + rng.exponential(W, N)
        lost = np.array([w in dead or rng.random() < bg_loss
                         for w in range(N)])
        # static no-failure plan: k = n over the FULL fleet
        if not job(x, lost, range(N), N, N)[1]:
            static_fails += 1
        # controller: dispatch to its current plan on the unquarantined
        pol = ctl.policy
        active = [w for w in range(N) if w not in ctl.quarantined][:pol.n]
        d, ok = job(x, lost, active, pol.n, pol.k)
        if ok:
            lats.append(d)
        else:
            fails += 1
        # telemetry: times for clean active workers, losses for the rest
        t = np.full(N, np.nan)
        loss_mask = np.zeros(N, bool)
        for w in active:
            if lost[w]:
                loss_mask[w] = True
            else:
                t[w] = x[w]
        ctl.observe(t, losses=loss_mask)
    mean = float(np.mean(lats)) if lats else float("inf")
    return mean, fails / steps, static_fails / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=120,
                    help="steps per phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the planner's device (default cuda; cpu for the "
                         "host)")
    args = ap.parse_args(argv)

    static = Planner(MeanCompletionTime(device=args.device)).plan(
        TRUTH).policy
    print(f"fault-free plan (the paper's objective): k={static.k} of "
          f"n={static.n} — pure splitting, zero parity")
    retry = RetryPolicy(max_attempts=3, backoff_base=0.5, backoff_mult=2.0)
    print(f"relaunch axis: RetryPolicy backoff "
          f"{[retry.delay(i) for i in range(retry.max_attempts - 1)]} s\n")

    ctl = RedundancyController(
        TRUTH, config=ControllerConfig(
            boot_samples=36, refit_samples=48, loss_forget=0.99,
            quarantine_weight=6.0, loss_refresh_outcomes=96),
        device=args.device)
    rng = np.random.default_rng(args.seed)
    phases = [("healthy", frozenset(), 0.0),
              ("STORM", STORM_DEAD, STORM_BG_LOSS),
              ("healed", frozenset(), 0.0)]
    for name, dead, bg in phases:
        mean, fail, sfail = run_phase(ctl, args.steps, dead, bg, rng)
        pol = ctl.policy
        q = list(ctl.quarantined)
        print(f"{name:8s} controller (n={pol.n:2d}, k={pol.k:2d}) "
              f"quarantined={q!r:12s} fail={fail:5.1%} "
              f"mean_latency={mean:6.3f}   | static k=n fail={sfail:5.1%}")

    print("\ncommits:")
    for e in ctl.events:
        loss = "" if e.loss is None else f"  loss~{e.loss.rate:.3f}"
        fb = " [oracle fallback]" if e.fallback else ""
        print(f"  outcome {e.at:5d}  {e.kind:8s} "
              f"(n={e.old_policy.n:2d}, k={e.old_policy.k:2d}) -> "
              f"(n={e.new_policy.n:2d}, k={e.new_policy.k:2d})  "
              f"quarantined={list(e.quarantined)}{loss}{fb}")

    healed = ctl.policy
    ok = healed.n == N and not ctl.quarantined
    print(f"\nfinal plan (n={healed.n}, k={healed.k}), "
          f"quarantine {'empty' if ok else ctl.quarantined}")
    if ok:
        print("-> the fleet degraded gracefully through the storm and "
              "returned to full size after the heal.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
