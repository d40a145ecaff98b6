"""Closed-loop evaluation: replay a nonstationary trace through the
controller and score regret against the clairvoyant per-regime oracle.

The trace (``core.scenario.sample_regime_trace``) carries task-time
tables for EVERY legal task size, all derived from one base draw per
regime (common random numbers), so the controller's trajectory, every
static plan, and the oracle are scored on the SAME realized randomness —
differences are pure policy, not sampling noise.

Step semantics, one job at a time (``trace.arrivals is None``): at step
t the controller's current policy (n, k) runs — the step completes at
the k-th smallest of the n task times at task size s = n/k (the paper's
Y_{k:n}) — and only then does the controller observe the step's per-CU
times (s = 1 column of the same tables; the runtime recovers CU times
from the step barrier since s is known).  Decisions at t therefore
depend only on data strictly before t.

QUEUED semantics (the trace carries arrival instants): each step is a
JOB arriving at its sampled instant and contending for the n FCFS
workers; its cost is the any-k queueing latency D_t - A_t, with worker
free-times carried across steps — so a policy switch also pays the
occupancy its predecessor left behind (draining in-flight redundancy).
Static plans and the per-regime oracle are scored on the SAME arrivals
and task tables by a scoring ``backend``: ``"batched"`` runs every
static k as one ``cluster_batched`` lane — all of them in one engine
call, in float32 on ``device`` (default ``"cuda"``) — and ``"oracle"``
runs the injected-trajectory discrete-event loop.  The controller's
time-varying-k path walks a float64 twin of the batched recurrence
(``_queue_step``; with a fixed k it reproduces the oracle lane
near-exactly — pinned by tests).  The controller additionally observes
each job's arrival ``timestamp``, which is what feeds load-aware
control.  Decisions depend only on observations, never on the scoring
backend, so the decision log is backend-invariant (pinned by tests).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve
from ..core.scenario import RegimeTrace
from .controller import ControlEvent, RedundancyController

__all__ = ["ReplayResult", "replay"]


def _queue_step(F: np.ndarray, a: float, srow: np.ndarray, k: int,
                preempt: bool, cancel_overhead: float):
    """One job through the exact FCFS/any-k/cancel recurrence — the
    float64 twin of ``cluster_batched._scan_lane``'s step (same
    completion rule, same tie-break, same preempt/purge accounting)."""
    start = np.maximum(a, F)
    nat = start + srow
    D = float(np.partition(nat, k - 1)[k - 1])
    lt = nat < D
    eq = nat == D
    take_eq = k - lt.sum()
    completed = lt | (eq & (np.cumsum(eq) * eq <= take_eq))
    inservice = (~completed) & (start < D)
    if preempt:
        F = np.where(completed, nat,
                     np.where(inservice, D + cancel_overhead, F))
    else:
        F = np.where(completed | inservice, nat, F)
    return F, D - a


def _static_queue_costs(trace: RegimeTrace, ks, times, backend: str,
                        preempt: bool, cancel_overhead: float,
                        device=DEFAULT_DEVICE) -> Dict[int, np.ndarray]:
    """Per-job latencies of every static k on the trace's arrivals, as
    float64 numpy."""
    n = trace.n
    A = trace.arrivals
    out: Dict[int, np.ndarray] = {}
    if backend == "cached":
        # the surface cache is a planning substrate; for injected-
        # trajectory static scoring it is the batched lane engine
        backend = "batched"
    if backend == "batched":
        from ..runtime.cluster_batched import _run_lanes
        # one lane per static k, every lane in one engine call (lanes are
        # independent: each equals its own ``_scan_lane`` bit for bit)
        dev = resolve(device)
        a = torch.as_tensor(np.asarray(A, np.float32), device=dev)
        s = torch.as_tensor(np.stack(
            [np.asarray(times[n // k], np.float32) for k in ks]), device=dev)
        lat = _run_lanes(a[None, None], s[None], list(ks),
                         float(cancel_overhead), bool(preempt))[0]
        lat = lat[0, 0].cpu().numpy().astype(np.float64)      # (K, steps)
        out = {k: lat[i] for i, k in enumerate(ks)}
    elif backend == "oracle":
        from ..runtime.cluster import ClusterConfig
        from ..runtime.cluster_oracle import simulate_oracle
        ref = trace.regimes[0]
        for k in ks:
            cfg = ClusterConfig(
                n_workers=n, k=k, arrival_rate=1.0,
                num_jobs=trace.num_steps, preempt=preempt,
                cancel_overhead=cancel_overhead)
            res = simulate_oracle(cfg, ref.dist, trace.scaling,
                                  service_times=times[n // k],
                                  arrival_times=A, device=device)
            out[k] = np.asarray(res.latencies, np.float64)
    else:
        raise ValueError(
            f"backend must be 'batched' or 'oracle', got {backend!r}")
    return out


@dataclasses.dataclass
class ReplayResult:
    """Controller / oracle / static completion-time accounting."""

    trace: RegimeTrace
    ks: Tuple[int, ...]
    controller_cost: np.ndarray          # (steps,) realized per-step times
    policy_k: np.ndarray                 # (steps,) k that ran each step
    events: List[ControlEvent]
    static_regime_means: Dict[int, np.ndarray]   # k -> (num_regimes,)
    controller_regime_means: np.ndarray          # (num_regimes,)
    observe_seconds_per_step: float
    replan_ms: List[float]
    backend: str = "paper"     # "paper" = single-job Y_{k:n} scoring;
                               # queued traces score via "batched"/"oracle"
    static_cost: Optional[Dict[int, np.ndarray]] = None
    #                          # k -> (steps,) per-job latencies of every
    #                          # static plan — retained so TAIL accounting
    #                          # (per-regime quantiles, the serving bench's
    #                          # p99 regret) can pool jobs, which per-regime
    #                          # MEANS cannot reconstruct

    # -- derived ------------------------------------------------------------
    @property
    def num_regimes(self) -> int:
        return len(self.trace.regimes)

    @property
    def regime_weights(self) -> np.ndarray:
        return np.asarray([r.num_steps for r in self.trace.regimes], float)

    @property
    def oracle_k(self) -> List[int]:
        """The clairvoyant per-regime arg-min static k."""
        ks = list(self.ks)
        return [int(ks[int(np.argmin(
            [self.static_regime_means[k][r] for k in ks]))])
            for r in range(self.num_regimes)]

    @property
    def oracle_regime_means(self) -> np.ndarray:
        return np.asarray([
            min(self.static_regime_means[k][r] for k in self.ks)
            for r in range(self.num_regimes)])

    @property
    def oracle_mean(self) -> float:
        w = self.regime_weights
        return float((self.oracle_regime_means * w).sum() / w.sum())

    @property
    def controller_mean(self) -> float:
        return float(self.controller_cost.mean())

    @property
    def regret(self) -> float:
        """Relative mean-completion-time excess over the oracle."""
        return self.controller_mean / self.oracle_mean - 1.0

    def static_mean(self, k: int) -> float:
        w = self.regime_weights
        return float((self.static_regime_means[k] * w).sum() / w.sum())

    def static_regret(self, k: int) -> float:
        return self.static_mean(k) / self.oracle_mean - 1.0

    def static_regime_regret(self, k: int) -> np.ndarray:
        """Per-regime relative excess of the static-k plan."""
        return self.static_regime_means[k] / self.oracle_regime_means - 1.0

    def controller_regime_regret(self) -> np.ndarray:
        return self.controller_regime_means / self.oracle_regime_means - 1.0

    # -- tail accounting (pooled per-regime quantiles) -----------------------
    def _regime_quantile(self, costs: np.ndarray, q: float,
                         skip: int) -> np.ndarray:
        """Per-regime q-quantile of a per-job cost array, dropping the
        first ``skip`` jobs of each regime (the adaptation/transition
        head a steady-phase tail comparison excludes; a regime shorter
        than ``skip`` keeps all its jobs rather than vanishing)."""
        reg_idx = self.trace.regime_index()
        out = np.empty(self.num_regimes)
        for r in range(self.num_regimes):
            x = costs[reg_idx == r]
            if skip and x.size > skip:
                x = x[skip:]
            out[r] = np.quantile(x, q)
        return out

    def controller_regime_quantile(self, q: float,
                                   skip: int = 0) -> np.ndarray:
        """Per-regime q-quantile of the controller's realized costs."""
        return self._regime_quantile(self.controller_cost, q, skip)

    def static_regime_quantile(self, k: int, q: float,
                               skip: int = 0) -> np.ndarray:
        """Per-regime q-quantile of the static-k per-job costs (needs
        the retained ``static_cost`` arrays — queued replays keep them)."""
        if self.static_cost is None:
            raise ValueError(
                "per-job static costs were not retained on this replay "
                "(paper-mode traces score single-job Y_{k:n} only)")
        return self._regime_quantile(self.static_cost[k], q, skip)

    def oracle_regime_quantile(self, q: float, skip: int = 0) -> np.ndarray:
        """The clairvoyant per-regime tail: for each regime, the best
        static k's q-quantile (the oracle may pick a different k per
        regime AND per objective — the mean oracle and the tail oracle
        legitimately diverge under load)."""
        return np.min(np.stack(
            [self.static_regime_quantile(k, q, skip) for k in self.ks]),
            axis=0)

    def quantile_regret(self, q: float, skip: int = 0) -> np.ndarray:
        """Per-regime relative q-quantile excess over the tail oracle."""
        return self.controller_regime_quantile(q, skip) / \
            self.oracle_regime_quantile(q, skip) - 1.0

    def summary(self) -> dict:
        return {
            "steps": int(self.trace.num_steps),
            "backend": self.backend,
            "controller_mean": self.controller_mean,
            "oracle_mean": self.oracle_mean,
            "regret": self.regret,
            "oracle_k": self.oracle_k,
            "static_regret": {int(k): self.static_regret(k) for k in self.ks},
            "worst_static_regime_regret": {
                int(k): float(self.static_regime_regret(k).max())
                for k in self.ks},
            "switches": [(int(e.at), e.kind, int(e.old_policy.k),
                          int(e.new_policy.k)) for e in self.events
                         if e.switched],
            "observe_seconds_per_step": self.observe_seconds_per_step,
            "replan_ms": self.replan_ms,
        }


def replay(trace: RegimeTrace, controller: RedundancyController,
           backend: str = "batched", preempt: bool = True,
           cancel_overhead: float = 0.0,
           device=DEFAULT_DEVICE) -> ReplayResult:
    """Run the controller over a trace; score it, every static plan, and
    the per-regime oracle on the same sample paths.

    A trace WITHOUT arrivals scores the paper objective (each step's
    Y_{k:n} in isolation; ``backend``/``preempt``/``cancel_overhead``
    are ignored).  A queued trace (``trace.has_arrivals``) scores
    any-k queueing latency with worker free-times carried across jobs;
    ``backend`` selects how the static lanes are scored ("batched" =
    one lane per k on ``device``, "oracle" = injected-trajectory DES) —
    decisions are backend-invariant.  ``device`` (default ``"cuda"``;
    pass ``device="cpu"`` for the host) runs the static lanes; the
    controller's own path is host float64 (``_queue_step``).
    """
    resolve(device)
    n = trace.n
    if controller.scenario.n != n:
        raise ValueError(
            f"controller plans for n={controller.scenario.n}, "
            f"trace has n={n}")
    if 1 not in trace.s_values:
        raise ValueError("trace must include s=1 (the CU telemetry column)")
    ks = tuple(sorted(n // s for s in trace.s_values if n % s == 0))
    times = {s: trace.times(s) for s in trace.s_values}
    steps = trace.num_steps
    reg_idx = trace.regime_index()
    queued = trace.has_arrivals

    # -- static plans and the oracle: vectorized over the whole trace ------
    if queued:
        static_cost = _static_queue_costs(trace, ks, times, backend,
                                          preempt, cancel_overhead, device)
    else:
        backend = "paper"
        static_cost = {
            k: np.partition(times[n // k], k - 1, axis=1)[:, k - 1]
            for k in ks}
    num_regimes = len(trace.regimes)
    static_regime_means = {
        k: np.asarray([c[reg_idx == r].mean() for r in range(num_regimes)])
        for k, c in static_cost.items()}

    # -- the closed loop ----------------------------------------------------
    cost = np.empty(steps)
    policy_k = np.empty(steps, dtype=np.int64)
    cu = times[1]
    A = trace.arrivals
    F = np.zeros(n)                 # queued mode: worker free-times
    observe_s = 0.0
    for t in range(steps):
        k = controller.policy.k
        if k not in static_cost:
            raise ValueError(
                f"controller chose k={k} but the trace lacks s={n // k}; "
                f"sample the trace with that task size (or constrain the "
                f"controller's scenario.candidate_ks)")
        policy_k[t] = k
        if queued:
            F, cost[t] = _queue_step(F, float(A[t]), times[n // k][t], k,
                                     preempt, cancel_overhead)
        else:
            cost[t] = static_cost[k][t]
        t0 = time.perf_counter()
        # the realized per-job completion cost doubles as the SLO
        # latency feed (a no-op unless the controller carries a monitor)
        controller.observe(cu[t],
                           timestamp=float(A[t]) if queued else None,
                           latency=float(cost[t]),
                           completion=float(A[t] + cost[t])
                           if queued else None)
        observe_s += time.perf_counter() - t0

    controller_regime_means = np.asarray(
        [cost[reg_idx == r].mean() for r in range(num_regimes)])
    return ReplayResult(
        trace=trace, ks=ks,
        controller_cost=cost, policy_k=policy_k,
        events=list(controller.events),
        static_regime_means=static_regime_means,
        controller_regime_means=controller_regime_means,
        observe_seconds_per_step=observe_s / max(steps, 1),
        replan_ms=[e.replan_ms for e in controller.events],
        backend=backend,
        static_cost=static_cost,
    )
