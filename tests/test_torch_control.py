"""The port's closed control loop against the JAX package.

Three kinds of check, strongest first:

  1. EXACT across packages, on the CPU, on the same injected inputs: the
     single-job controller replayed over one ``RegimeTrace`` built from
     numpy tables (paper mode over three families, a queued rate flip),
     a numpy-drawn loss stream through ``observe``, the load-aware
     controller with one deterministic stand-in curve patched into both
     packages, and the numpy modules under it (estimators, detectors,
     ``Telemetry``, ``SLOMonitor``, the run report) on the same streams.
  2. The port's own load-aware replay on its real engine, on the CPU:
     deterministic, through the surface cache, warm after the first
     surface of each family, no oracle fallback.
  3. Statistical, at ``tests/test_conformance.py``'s tolerances: the
     port's own ``sample_regime_trace`` draws (the reference's
     ``TestRegimeTrace`` ported, plus per-regime means).

The JAX package is imported inside the tests that compare with it.  The
example twins each get a short CPU run; the card tests (``gpu``) hold the
card's traces and static lanes to the host's.
"""
import dataclasses
import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api as papi
from repro_torch import control as pctl
from repro_torch.control import controller as pcontroller
from repro_torch.control.replay import _queue_step, _static_queue_costs
from repro_torch.core import distributions as pdists
from repro_torch.core import scenario as pscen
from repro_torch.obs import REGISTRY, recorder as precorder
from repro_torch.obs import report as preport
from repro_torch.runtime import surface_cache as psc
from repro_torch.runtime.telemetry import InsufficientTelemetry, Telemetry

CPU = "cpu"
N = 12
ROOT = Path(__file__).resolve().parents[1]
SERVER = pdists.Scaling.SERVER_DEPENDENT
PRIOR = ("BiModal", 10.0, 0.3)


def _ref(name):
    pytest.importorskip("jax")
    return pytest.importorskip(name)


class _Pkg:
    """One package's namespaces, so a test builds the same objects in
    both by name."""

    def __init__(self, root):
        import importlib
        self.dists = importlib.import_module(f"{root}.core.distributions")
        self.scen = importlib.import_module(f"{root}.core.scenario")
        self.api = importlib.import_module(f"{root}.api")
        self.ctl = importlib.import_module(f"{root}.control")
        self.controller = importlib.import_module(
            f"{root}.control.controller")
        self.report = importlib.import_module(f"{root}.obs.report")
        self.slo = importlib.import_module(f"{root}.obs.slo")
        self.telemetry = importlib.import_module(f"{root}.runtime.telemetry")
        self.port = root == "repro_torch"

    def dist(self, spec):
        return getattr(self.dists, spec[0])(*spec[1:])

    def kw(self):
        """The device keyword of the port's entry points (the CPU here)."""
        return {"device": CPU} if self.port else {}

    def trace(self, regimes, tables, arrivals, n=N, scaling="server"):
        """A ``RegimeTrace`` over the given numpy tables: ``regimes`` is
        [(dist spec, steps, arrival spec or None)]."""
        regs = tuple(self.scen.Regime(
            self.dist(d), steps,
            arrivals=None if a is None else getattr(self.scen, a[0])(*a[1:]))
            for d, steps, a in regimes)
        s_values = tuple(sorted(tables[0]))
        return self.scen.RegimeTrace(
            regimes=regs, scaling=self.dists.Scaling(scaling), n=n, seed=0,
            s_values=s_values, tables=tuple(tables), arrivals=arrivals)


def _pkgs():
    _ref("repro.control")
    return _Pkg("repro"), _Pkg("repro_torch")


# --------------------------------------------------------------------------
# Injected traces: numpy tables shared by both packages
# --------------------------------------------------------------------------

def _noise(spec, rng, shape):
    """Numpy draws of the random component Z = X - shift of a law."""
    name = spec[0]
    if name == "ShiftedExp":
        return rng.exponential(spec[2], shape)
    if name == "BiModal":
        return np.where(rng.random(shape) < spec[2], spec[1], 1.0)
    if name == "Pareto":
        return spec[1] * rng.random(shape) ** (-1.0 / spec[2])
    raise ValueError(name)


def _tables(regimes, seed, n=N):
    """Server-dependent tables d + s z per regime, every divisor s."""
    rng = np.random.default_rng(seed)
    out = []
    for spec, steps, _ in regimes:
        z = _noise(spec, rng, (steps, n))
        d = spec[1] if spec[0] == "ShiftedExp" else 0.0
        out.append({s: d + s * z for s in range(1, n + 1) if n % s == 0})
    return out


def _mmpp_gaps(rng, rate, steps, slow, burst, switch=0.05):
    """Numpy gaps of ``MMPPArrivals``: the state flips after an arrival
    with probability ``switch``; per-state rates normalized so the
    long-run rate is ``rate``."""
    e = rng.exponential(1.0, steps)
    state = np.cumsum(rng.random(steps) < switch) % 2          # start slow
    c = 0.5 * (1.0 / slow + 1.0 / burst)
    return e / (rate * c * np.where(state == 0, slow, burst))


def _arrivals(regimes, seed):
    rng = np.random.default_rng(seed + 1)
    gaps = np.concatenate([
        rng.exponential(1.0 / a[1], steps) if a[0] == "PoissonArrivals"
        else _mmpp_gaps(rng, a[1], steps, *a[2:]) for _, steps, a in regimes])
    return np.cumsum(gaps)


FAMILIES = [(("ShiftedExp", 1.0, 10.0), 120, None),
            (("BiModal", 1e4, 5e-4), 120, None),
            (("Pareto", 1.0, 2.5), 120, None)]
RATE_FLIP = [(("ShiftedExp", 1.0, 10.0), 150, ("PoissonArrivals", 0.002)),
             (("ShiftedExp", 1.0, 10.0), 150, ("PoissonArrivals", 0.03)),
             (("ShiftedExp", 1.0, 10.0), 150, ("PoissonArrivals", 0.002))]
# benchmarks/control_loop.py's burst_flip at its 600 steps a regime: the
# same mean rate throughout, the arrival SHAPE flips Poisson -> MMPP
# trains -> Poisson
BURST_FLIP = [(("ShiftedExp", 1.0, 10.0), 600, ("PoissonArrivals", 0.03)),
              (("ShiftedExp", 1.0, 10.0), 600,
               ("MMPPArrivals", 0.03, 0.2, 5.0)),
              (("ShiftedExp", 1.0, 10.0), 600, ("PoissonArrivals", 0.03))]
QUEUED = {"rate_flip": RATE_FLIP, "burst_flip": BURST_FLIP}


def _single_job(pkg):
    sc = pkg.api.Scenario(pkg.dist(PRIOR), pkg.dists.Scaling("server"), N)
    return pkg.ctl.RedundancyController(sc, **pkg.kw())


@pytest.mark.parametrize("script", ["paper", "queued", "queued_burst"])
def test_single_job_replay_equals_reference_bitwise(script):
    """Policy trajectory, realized costs, every static cost array, the
    oracle's k, the decision log: the same numbers bit for bit."""
    regimes = {"paper": FAMILIES, "queued": RATE_FLIP,
               "queued_burst": BURST_FLIP}[script]
    tables = _tables(regimes, seed=5)
    arrivals = None if script == "paper" else _arrivals(regimes, seed=5)
    out = []
    for pkg in _pkgs():
        trace = pkg.trace(regimes, tables, arrivals)
        res = pkg.ctl.replay(trace, _single_job(pkg), preempt=False,
                             **pkg.kw())
        out.append((res, pkg.report.decision_log_from_control_events(
            res.events)))
    (ref, ref_log), (got, got_log) = out
    np.testing.assert_array_equal(got.policy_k, ref.policy_k)
    np.testing.assert_array_equal(got.controller_cost, ref.controller_cost)
    assert got.ks == ref.ks
    for k in ref.ks:
        np.testing.assert_array_equal(got.static_cost[k], ref.static_cost[k])
    assert got.oracle_k == ref.oracle_k
    assert got.regret == ref.regret
    assert got_log == ref_log and len(ref_log) >= (2 if script == "paper" else 1)
    assert all(e.replan_ms >= 0 for e in got.events)


def test_paper_trace_switches_family_and_static_plans_pay():
    """The acceptance shape on the injected paper trace: the controller
    moves k with the family, and its regret undercuts the best static
    plan's."""
    port = _Pkg("repro_torch")
    trace = port.trace(FAMILIES, _tables(FAMILIES, seed=5), None)
    res = pctl.replay(trace, _single_job(port), device=CPU)
    assert len(set(res.policy_k.tolist())) >= 2
    assert res.regret < min(res.static_regret(k) for k in res.ks)


def _storm_stream(seed, steps=60):
    """A numpy loss stream: healthy, a crash storm (three dead workers
    plus 5 % background loss), healed."""
    rng = np.random.default_rng(seed)
    dead = {3, 7, 11}
    for phase in ("healthy", "storm", "healed"):
        for _ in range(steps):
            x = 3.0 + rng.exponential(1.0, N)
            lost = np.array([(phase == "storm" and (w in dead or
                                                    rng.random() < 0.05))
                             for w in range(N)])
            yield x, lost


def test_loss_stream_quarantine_equals_reference():
    """The fleet-degradation path on one numpy loss stream: every
    commit, every quarantine set and the policy after every step."""
    logs = []
    for pkg in _pkgs():
        sc = pkg.api.Scenario(pkg.dists.ShiftedExp(3.0, 1.0),
                              pkg.dists.Scaling("data"), N)
        ctl = pkg.ctl.RedundancyController(
            sc, config=pkg.controller.ControllerConfig(
                boot_samples=36, refit_samples=48, loss_forget=0.99,
                quarantine_weight=6.0, loss_refresh_outcomes=96),
            **pkg.kw())
        steps = []
        for x, lost in _storm_stream(seed=2):
            pol = ctl.policy
            active = [w for w in range(N) if w not in ctl.quarantined]
            t = np.where(lost, np.nan, x)
            t[[w for w in range(N) if w not in active[:pol.n]]] = np.nan
            ctl.observe(t, losses=lost)
            steps.append((ctl.policy.n, ctl.policy.k, ctl.quarantined))
        logs.append((steps, pkg.report.decision_log_from_control_events(
            ctl.events), [(e.quarantined, e.loss) for e in ctl.events]))
    ref, got = logs
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert [q for q, _ in got[2]] == [q for q, _ in ref[2]]
    assert [dataclasses.astuple(m) for _, m in got[2]] == \
        [dataclasses.astuple(m) for _, m in ref[2]]
    assert any(q for q, _ in ref[2])          # the storm was quarantined


# --------------------------------------------------------------------------
# The load-aware controller's logic, on one injected curve
# --------------------------------------------------------------------------

def _stand_in_curve(self, scenario, unit):
    """A deterministic load-aware curve: a pure function of the committed
    arrival model and the plan scenario (split time n/k, inflated by the
    model's effective dispersion, against a redundancy cost that grows
    with the load)."""
    self._co_curve = None
    self._tail_curve = None
    rate = self.arrival_model.rate * unit
    burst = self.arrival_model.effective_dispersion()
    m = float(scenario.dist.mean())
    return {k: scenario.n / k * m * max(burst, 1.0) + 40.0 * rate * k * m
            for k in scenario.legal_ks()}


@pytest.mark.parametrize("script", sorted(QUEUED))
def test_load_aware_logic_equals_reference_on_injected_curve(monkeypatch,
                                                             script):
    """Arrival estimation (rate, dispersion, the arrival model chosen),
    the load CUSUM, hysteresis and the commits, with the surface replaced
    by one stand-in in both packages."""
    regimes = QUEUED[script]
    tables, arrivals = _tables(regimes, seed=9), _arrivals(regimes, seed=9)
    out = []
    for pkg in _pkgs():
        monkeypatch.setattr(pkg.controller.RedundancyController,
                            "_load_aware_curve", _stand_in_curve)
        obj = pkg.api.LoadAwareLatency(num_jobs=50, backend="cached",
                                       preempt=False, **pkg.kw())
        ctl = pkg.ctl.RedundancyController(
            pkg.api.Scenario(pkg.dist(PRIOR), pkg.dists.Scaling("server"),
                             N), objective=obj, **pkg.kw())
        res = pkg.ctl.replay(pkg.trace(regimes, tables, arrivals), ctl,
                             preempt=False, **pkg.kw())
        out.append((res, pkg.report.decision_log_from_control_events(
            res.events)))
    (ref, ref_log), (got, got_log) = out
    assert got_log == ref_log
    assert sum(e.kind == "load" for e in ref.events) >= 2
    np.testing.assert_array_equal(got.policy_k, ref.policy_k)
    assert [dataclasses.astuple(e.arrival) for e in got.events] == \
        [dataclasses.astuple(e.arrival) for e in ref.events]
    assert [(e.cached, e.warm, e.fallback) for e in got.events] == \
        [(e.cached, e.warm, e.fallback) for e in ref.events]
    if script == "burst_flip":          # the MMPP model was chosen and used
        assert any(isinstance(e.arrival.process(), pscen.MMPPArrivals)
                   for e in got.events)


def _load_aware_replay(trace, num_jobs=150):
    obj = papi.LoadAwareLatency(num_jobs=num_jobs, reps=2, backend="cached",
                                preempt=False, device=CPU)
    ctl = pctl.RedundancyController(
        papi.Scenario(pdists.BiModal(10.0, 0.3), SERVER, N), objective=obj,
        device=CPU)
    return pctl.replay(trace, ctl, preempt=False, device=CPU)


def test_load_aware_replay_on_the_engine_is_cached_warm_and_repeatable():
    """The port's real load-aware replay on the CPU: deterministic under
    replay, through the surface cache, warm after the first surface of
    each family, and no oracle fallback."""
    port = _Pkg("repro_torch")
    trace = port.trace(RATE_FLIP, _tables(RATE_FLIP, seed=9),
                       _arrivals(RATE_FLIP, seed=9))
    fallbacks = REGISTRY.counter("controller.surface_fallbacks")
    fb0 = fallbacks.value
    psc.reset_surface_cache_stats()
    res = _load_aware_replay(trace)
    again = _load_aware_replay(trace)
    np.testing.assert_array_equal(res.policy_k, again.policy_k)
    assert pctl.ReplayResult is type(res)
    assert any(e.cached for e in res.events)
    assert not any(e.fallback for e in res.events + again.events)
    assert fallbacks.value == fb0
    seen = set()
    for e in res.events:
        key = (e.hedged, e.model.family, type(e.arrival.process()).__name__)
        if key in seen:
            assert e.warm, e
        seen.add(key)
    assert sum(e.warm for e in res.events) >= 1
    assert all(e.warm for e in again.events)       # every key seen before


def _gate_burst_flip():
    """``benchmarks/control_loop.py``'s burst_flip regimes at full size
    (600 steps a regime), as both packages spell them."""
    return [(("ShiftedExp", 1.0, 10.0), 600, a) for _, _, a in BURST_FLIP]


def test_burst_flip_gate_trace_real_controllers_equal_reference(capsys):
    """The port's own burst_flip trace at the gate's size (n 24, seed 0,
    drawn on the host), injected into the JAX package: both packages'
    REAL load-aware controllers, each re-planning on its own package's
    Monte-Carlo surfaces (``LoadAwareLatency(num_jobs=600, reps=2,
    backend="cached", preempt=False)``), replay it.  The static costs and
    the oracle's k are equal bit for bit, and the decisions coincide, so
    the regrets are equal: where the port's regret misses the gate on
    this trace, the reference's controller misses it by the same
    amount."""
    n = 24
    port = _Pkg("repro_torch")
    regs = tuple(pscen.Regime(port.dist(d), steps,
                              arrivals=getattr(pscen, a[0])(*a[1:]))
                 for d, steps, a in _gate_burst_flip())
    drawn = pscen.sample_regime_trace(regs, SERVER, n, seed=0, device=CPU)
    tables = [{s: t[s] for s in drawn.s_values} for t in drawn.tables]
    out = []
    for pkg in _pkgs():
        trace = pkg.trace(_gate_burst_flip(), tables, drawn.arrivals, n=n)
        obj = pkg.api.LoadAwareLatency(num_jobs=600, reps=2,
                                       backend="cached", preempt=False,
                                       **pkg.kw())
        ctl = pkg.ctl.RedundancyController(
            pkg.api.Scenario(pkg.dist(PRIOR), pkg.dists.Scaling("server"),
                             n), objective=obj, **pkg.kw())
        res = pkg.ctl.replay(trace, ctl, preempt=False, **pkg.kw())
        out.append((res, pkg.report.decision_log_from_control_events(
            res.events)))
    (ref, ref_log), (got, got_log) = out
    for k in ref.ks:
        np.testing.assert_array_equal(got.static_cost[k], ref.static_cost[k])
    assert got.oracle_k == ref.oracle_k
    assert not any(e.fallback for e in got.events + ref.events)
    assert got_log == ref_log
    np.testing.assert_array_equal(got.policy_k, ref.policy_k)
    assert got.regret == ref.regret
    with capsys.disabled():
        print(f"\n  burst_flip gate trace (n {n}, seed 0, host): regret "
              f"port {got.regret:.4%}, JAX package {ref.regret:.4%}; "
              f"oracle k {ref.oracle_k}; {len(ref_log)} logged commits")


def test_load_aware_fallback_keeps_the_objectives_device(monkeypatch):
    """A surface that raises goes to the oracle ON THE OBJECTIVE'S DEVICE
    and is counted (the reference's graceful degradation, kept)."""
    port = _Pkg("repro_torch")
    from repro_torch.runtime import cluster
    seen = []
    real = cluster.resolve_sweep_backend

    def spy(backend):
        run = real(backend)

        def wrapped(sc, **kw):
            seen.append((backend, kw.get("device")))
            if backend == "cached":
                raise RuntimeError("planted engine fault")
            return run(sc, **kw)
        return wrapped

    monkeypatch.setattr(cluster, "resolve_sweep_backend", spy)
    trace = port.trace(RATE_FLIP, _tables(RATE_FLIP, seed=9),
                       _arrivals(RATE_FLIP, seed=9))
    fallbacks = REGISTRY.counter("controller.surface_fallbacks")
    fb0 = fallbacks.value
    res = _load_aware_replay(trace, num_jobs=60)
    assert seen and all(d == CPU for _, d in seen)
    assert {b for b, _ in seen} == {"cached", "oracle"}
    assert any(e.fallback for e in res.events)
    assert fallbacks.value > fb0


# --------------------------------------------------------------------------
# The port's own trace draws (the reference's TestRegimeTrace, ported)
# --------------------------------------------------------------------------

def _port_regimes():
    return [pscen.Regime(pdists.ShiftedExp(1.0, 10.0), 400),
            pscen.Regime(pdists.BiModal(1e4, 5e-4), 400),
            pscen.Regime(pdists.Pareto(1.0, 2.5), 400)]


class TestRegimeTrace:
    def test_shapes_boundaries_and_regime_index(self):
        tr = pscen.sample_regime_trace(_port_regimes(), SERVER, N, seed=0,
                                       device=CPU)
        assert tr.num_steps == 1200
        assert tr.boundaries() == [(0, 400), (400, 800), (800, 1200)]
        idx = tr.regime_index()
        assert idx.shape == (1200,)
        assert (idx[:400] == 0).all() and (idx[800:] == 2).all()
        assert tr.times(1).shape == (1200, N)
        assert tr.times(1).dtype == np.float64

    def test_crn_discipline_shares_base_noise_across_task_sizes(self):
        tr = pscen.sample_regime_trace(
            [pscen.Regime(pdists.ShiftedExp(1.0, 10.0), 50)], SERVER, N,
            seed=3, device=CPU)
        z1 = tr.times(1) - 1.0
        for s in (2, 3, 6, 12):
            np.testing.assert_allclose(tr.times(s) - 1.0, s * z1,
                                       rtol=1e-12)

    def test_deterministic_given_seed(self):
        a = pscen.sample_regime_trace(_port_regimes(), SERVER, N, seed=7,
                                      device=CPU)
        b = pscen.sample_regime_trace(_port_regimes(), SERVER, N, seed=7,
                                      device=CPU)
        for r in range(3):
            for s in a.s_values:
                np.testing.assert_array_equal(a.tables[r][s], b.tables[r][s])
        c = pscen.sample_regime_trace(_port_regimes(), SERVER, N, seed=8,
                                      device=CPU)
        assert not np.array_equal(a.tables[0][1], c.tables[0][1])

    def test_fleet_change_applies_worker_speeds(self):
        slow = (1.0,) * 10 + (4.0, 4.0)
        base = pscen.sample_regime_trace(
            [pscen.Regime(pdists.ShiftedExp(1.0, 2.0), 80)], SERVER, N,
            seed=1, device=CPU)
        het = pscen.sample_regime_trace(
            [pscen.Regime(pdists.ShiftedExp(1.0, 2.0), 80,
                          worker_speeds=slow)], SERVER, N, seed=1,
            device=CPU)
        np.testing.assert_allclose(het.times(1),
                                   base.times(1) * np.asarray(slow),
                                   rtol=1e-12)

    def test_additive_tables_are_cu_cumsums(self):
        tr = pscen.sample_regime_trace(
            [pscen.Regime(pdists.BiModal(10.0, 0.3), 30)],
            pdists.Scaling.ADDITIVE, 6, seed=2, device=CPU)
        assert (tr.times(3) >= tr.times(2)).all()
        assert (tr.times(2) >= tr.times(1)).all()
        assert set(np.unique(tr.times(1))) <= {1.0, 10.0}

    def test_unknown_task_size_raises(self):
        tr = pscen.sample_regime_trace(
            [pscen.Regime(pdists.ShiftedExp(1.0, 1.0), 10)], SERVER, N,
            seed=0, s_values=[1, 2], device=CPU)
        with pytest.raises(ValueError, match="not sampled"):
            tr.times(6)

    def test_sexp_regime_delta_contract(self):
        with pytest.raises(ValueError, match="contradict"):
            pscen.Regime(pdists.ShiftedExp(2.0, 1.0), 10, delta=1.0)

    def test_arrivals_on_all_regimes_or_none(self):
        with pytest.raises(ValueError, match="every regime"):
            pscen.sample_regime_trace(
                [pscen.Regime(pdists.ShiftedExp(1.0, 1.0), 10),
                 pscen.Regime(pdists.ShiftedExp(1.0, 1.0), 10,
                              arrivals=pscen.PoissonArrivals(0.1))],
                SERVER, N, device=CPU)

    def test_arrivals_leave_service_tables_unchanged(self):
        """The arrival keys are disjoint from the service keys."""
        plain = pscen.sample_regime_trace(
            [pscen.Regime(pdists.ShiftedExp(1.0, 10.0), 60)], SERVER, N,
            seed=4, device=CPU)
        queued = pscen.sample_regime_trace(
            [pscen.Regime(pdists.ShiftedExp(1.0, 10.0), 60,
                          arrivals=pscen.PoissonArrivals(0.05))], SERVER, N,
            seed=4, device=CPU)
        np.testing.assert_array_equal(plain.times(1), queued.times(1))
        assert np.all(np.diff(queued.arrivals) >= 0)


@pytest.mark.parametrize("spec,scaling,rtol", [
    (("ShiftedExp", 1.0, 10.0), "server", 0.05),
    (("BiModal", 10.0, 0.3), "server", 0.05),
    (("Pareto", 1.0, 2.5), "server", 0.12),
    (("ShiftedExp", 1.0, 10.0), "data", 0.05),
    (("BiModal", 10.0, 0.3), "additive", 0.05),
])
def test_trace_means_match_the_law(spec, scaling, rtol):
    """Per-regime means of every sampled task size against the closed
    form, at ``tests/test_conformance.py``'s Monte-Carlo tolerances."""
    port = _Pkg("repro_torch")
    dist = port.dist(spec)
    sc = pdists.Scaling(scaling)
    tr = pscen.sample_regime_trace([pscen.Regime(dist, 2000)], sc, 6,
                                   seed=11, device=CPU)
    d = dist.shift
    for s in tr.s_values:
        if sc is pdists.Scaling.SERVER_DEPENDENT:
            want = d + s * (dist.mean() - d)
        elif sc is pdists.Scaling.DATA_DEPENDENT:
            want = s * d + (dist.mean() - d)
        else:
            want = s * dist.mean()
        assert tr.times(s).mean() == pytest.approx(want, rel=rtol), s


@pytest.mark.parametrize("proc,rtol", [
    (pscen.PoissonArrivals(0.03), 0.05),
    (pscen.DeterministicArrivals(0.5), 0.05),
    # dwells of ~20 arrivals at gap means 64 and 2.6: the mean of 20000
    # gaps has a ~4 % standard error, so a 3-sigma band
    (pscen.MMPPArrivals(0.03, slow=0.2, burst=5.0), 0.12)])
def test_trace_arrival_rate_matches_the_process(proc, rtol):
    tr = pscen.sample_regime_trace(
        [pscen.Regime(pdists.ShiftedExp(1.0, 1.0), 20_000, arrivals=proc)],
        SERVER, 1, seed=2, s_values=[1], device=CPU)
    gaps = np.diff(np.concatenate([[0.0], tr.arrivals]))
    assert gaps.mean() == pytest.approx(1.0 / proc.rate, rel=rtol)
    if isinstance(proc, pscen.DeterministicArrivals):
        np.testing.assert_allclose(gaps, 2.0, rtol=1e-6)


def test_gaps_chunk_is_the_uniform_transform():
    """``gaps_chunk`` = the row-keyed uniforms through
    ``gaps_from_uniform`` (what the traces call with float64 uniforms)."""
    from repro_torch.core import threefry
    key = threefry.key(5, CPU)
    for proc in (pscen.PoissonArrivals(0.3), pscen.MMPPArrivals(0.3),
                 pscen.DeterministicArrivals(0.3)):
        g, st = proc.gaps_chunk(key, 10, 64)
        u = threefry.uniform(pscen.job_row_keys(key, 10, 64),
                             proc.uniforms_per_job)
        g2, st2 = proc.gaps_from_uniform(u)
        torch.testing.assert_close(g, g2, rtol=0, atol=0)
        assert int(st) == int(st2)


# --------------------------------------------------------------------------
# Module parity on the same input streams
# --------------------------------------------------------------------------

def _cu_stream(seed, n=4000):
    rng = np.random.default_rng(seed)
    return np.concatenate([1.0 + rng.exponential(2.0, n // 2),
                           np.where(rng.random(n // 2) < 0.2, 10.0, 1.0)])


@pytest.mark.parametrize("name", ["ShiftedExpEstimator", "ParetoEstimator",
                                  "BiModalEstimator"])
def test_estimators_fit_the_same_parameters(name):
    x = _cu_stream(3)
    fits = []
    for pkg in _pkgs():
        est = getattr(pkg.ctl, name)()
        trail = []
        for i in range(0, x.size, 24):
            est.update(x[i:i + 24])
            if est.ready:
                trail.append(dataclasses.astuple(est.dist()))
        fits.append((trail, est.weight))
    assert fits[0] == fits[1] and fits[0][0]


def test_online_selector_scores_and_window_fit_are_equal():
    x = _cu_stream(4)
    out = []
    for pkg in _pkgs():
        sel = pkg.ctl.OnlineSelector()
        trail = []
        for i in range(0, x.size, 24):
            sel.update(x[i:i + 24])
            best = sel.best()
            trail.append((sel.scores(), None if best is None else (
                best.family, dataclasses.astuple(best.dist), best.scale,
                best.num_samples)))
        fw = pkg.ctl.fit_window(x[-500:])
        out.append((trail, fw.family, dataclasses.astuple(fw.dist),
                    fw.scale))
    assert out[0] == out[1]


def _arrival_instants(seed, bursty=False):
    """300 Poisson gaps of mean 30, then 300 more: a tenfold rate flip,
    or (``bursty``) MMPP trains at the same mean rate, burst_flip's
    shape."""
    rng = np.random.default_rng(seed)
    second = _mmpp_gaps(rng, 1 / 30.0, 300, 0.2, 5.0) if bursty \
        else rng.exponential(3.0, 300)
    return np.cumsum(np.concatenate([rng.exponential(30.0, 300), second]))


@pytest.mark.parametrize("bursty", [False, True], ids=["rate", "burst"])
def test_arrival_loss_and_sojourn_estimators_are_equal(bursty):
    t = _arrival_instants(5, bursty)
    rng = np.random.default_rng(6)
    lost = rng.random(600) < np.r_[np.full(300, 0.02), np.full(300, 0.3)]
    out = []
    for pkg in _pkgs():
        arr, loss, soj = (pkg.ctl.ArrivalEstimator(),
                          pkg.ctl.LossRateEstimator(),
                          pkg.ctl.SojournEstimator())
        trail = []
        for i, ts in enumerate(t):
            arr.observe(ts)
            loss.observe(lost[i:i + 1])
            soj.observe(ts, ts + 5.0 + (i % 7))
            if arr.ready and loss.ready and soj.ready:
                trail.append((dataclasses.astuple(arr.model()),
                              dataclasses.astuple(loss.model()),
                              dataclasses.astuple(soj.model())))
        out.append(trail)
    assert out[0] == out[1] and out[0]
    if bursty:                       # the estimate reached the MMPP model
        assert any(d[1] > 1.0 and isinstance(
            pctl.ArrivalModel(*d).process(), pscen.MMPPArrivals)
            for d, _, _ in out[1])


def _alarm_steps(det, stream, feed):
    steps = []
    for i, batch in enumerate(stream):
        ev = feed(det, batch, i)
        if ev is not None:
            steps.append((i, ev.kind, ev.at, ev.start, ev.stat))
    return steps


@pytest.mark.parametrize("bursty", [False, True], ids=["rate", "burst"])
def test_detectors_alarm_at_the_same_step(bursty):
    rng = np.random.default_rng(7)
    x = (1.0 + np.r_[rng.exponential(2.0, 3000),
                     rng.exponential(8.0, 3000)]).reshape(-1, 24)
    gaps = np.diff(_arrival_instants(8, bursty)).reshape(-1, 1)
    rng = np.random.default_rng(9)
    losses = (rng.random((200, 12)) <
              np.r_[np.full(100, 0.02), np.full(100, 0.4)][:, None])
    sojourn = np.r_[np.full(80, 10.0), np.full(80, 40.0)]
    out = []
    for pkg in _pkgs():
        fm = pkg.ctl.FittedModel(pkg.dists.ShiftedExp(1.0, 2.0),
                                 "shifted_exp", 1.0, 500.0)
        drift = pkg.ctl.DriftDetector()
        drift.rebase(fm, at=0)
        load = pkg.ctl.LoadDriftDetector()
        load.rebase(pkg.ctl.ArrivalModel(rate=1 / 30.0, dispersion=1.0,
                                          num_gaps=100), at=0)
        fail = pkg.ctl.FailureDriftDetector()
        fail.rebase(0.02, at=0)
        soj = pkg.ctl.SojournDriftDetector()
        soj.rebase(10.0, at=0)
        out.append((
            _alarm_steps(drift, x, lambda d, b, i: d.update(b, at=24 * i)),
            _alarm_steps(load, gaps, lambda d, b, i: d.update(b, at=i)),
            _alarm_steps(fail, losses, lambda d, b, i: d.update(b, at=i)),
            _alarm_steps(soj, sojourn, lambda d, b, i: d.update(b, at=i))))
    assert out[0] == out[1]
    assert all(out[0]), out[0]              # every channel alarmed


def test_telemetry_stats_are_equal():
    tels = []
    for pkg in _pkgs():
        rng = np.random.default_rng(10)
        tel = pkg.telemetry.Telemetry(window=256, min_samples=8)
        t = 0.0
        for step in range(60):
            row = 1.0 + rng.exponential(2.0, 8) * np.r_[np.ones(7), 3.0]
            tel.record_step(row)
            tel.record_worker_times(row)
            t += 4.0 + step % 3
            tel.record_job(t, t + 2.5 + step % 5)
            lost = np.arange(8) == step % 8
            tel.record_outcomes(~lost, lost & (step % 4 == 0))
            tel.record_retries(step % 2)
        tels.append(tel)
    ref, got = tels
    for stat in ("straggle_stats", "arrival_stats", "fleet_health",
                 "sojourn_stats", "worker_speed_stats"):
        a, b = getattr(ref, stat)(), getattr(got, stat)()
        assert dataclasses.astuple(a) == dataclasses.astuple(b), stat
    fa, fb = ref.fit(), got.fit()
    assert fa[1] == fb[1] and dataclasses.astuple(fa[0]) == \
        dataclasses.astuple(fb[0])
    assert isinstance(Telemetry().straggle_stats(), InsufficientTelemetry)


def test_slo_monitor_state_is_equal():
    rng = np.random.default_rng(12)
    lat = np.r_[rng.exponential(10.0, 400), rng.exponential(60.0, 200)]
    states = []
    for pkg in _pkgs():
        mon = pkg.slo.SLOMonitor(target=40.0, quantile=0.99, fast_window=32,
                                 slow_window=128)
        alarms = [a.at for a in map(mon.observe, lat) if a is not None]
        states.append((mon.state(), alarms))
    assert states[0] == states[1] and states[0][1]


def _events_jsonl(path):
    """One trace's worth of events, written as the recorder exports."""
    rows = [
        dict(ts=0.0, kind="mark", name="regime", fields=[["regime", 0]]),
        dict(ts=0.1, kind="drift_alarm", name="load",
             fields=[["channel", "load"], ["alarm_kind", "burst_up"],
                     ["at", 87], ["start", 80], ["stat", 23.6],
                     ["threshold", 18.0]]),
        dict(ts=0.2, kind="commit", name="load",
             fields=[["at", 1260], ["trigger", "burst_up"], ["old_k", 2],
                     ["new_k", 12], ["old_n", 12], ["new_n", 12],
                     ["switched", True], ["replan_ms", 111.2],
                     ["family", "shifted_exp"], ["hedged", False],
                     ["cached", True], ["warm", True], ["metric", "mean"],
                     ["fallback", False], ["quarantined", []],
                     ["assignment", None]]),
        dict(ts=0.3, kind="slo_alarm", name="slo_burn",
             fields=[["at", 300], ["burn_fast", 6.0], ["burn_slow", 4.5],
                     ["threshold", 4.0], ["target", 40.0],
                     ["quantile_est", 70.0]]),
        dict(ts=0.35, kind="mark", name="slo",
             fields=[["target", 40.0], ["count", 600]]),
        dict(ts=0.4, kind="sweep", name="cached", dur=0.05,
             fields=[["n", 12], ["device", "cpu"]]),
        dict(ts=0.5, kind="sweep", name="cached", dur=0.07,
             fields=[["n", 12], ["device", "cuda"]]),
        dict(ts=0.6, kind="sweep", name="cached", dur=0.06,
             fields=[["n", 12], ["device", "cuda"]]),
    ]
    for r in rows:
        r["fields"] = dict(r["fields"])
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return path


def _section(text, title):
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith(title))
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("==")), len(lines))
    return lines[start:end]


def test_report_commit_and_slo_sections_equal_reference(tmp_path):
    path = _events_jsonl(tmp_path / "trace.jsonl")
    texts, logs = [], []
    for pkg in _pkgs():
        events = pkg.report.load_trace(str(path))
        texts.append(pkg.report.render_report(events))
        logs.append(pkg.report.decision_log(events))
    for title in ("== committed decisions", "== SLO", "== decision log",
                  "== drift alarms"):
        assert _section(texts[1], title) == _section(texts[0], title), title
    assert logs[0] == logs[1] == [(1260, "load", 2, 12, None, "burst_up")]


def test_report_prints_each_engines_calls_by_device(tmp_path, capsys):
    """Where the reference counts compiles, the port names the devices
    its engine calls ran on — from the CLI as from the library."""
    path = _events_jsonl(tmp_path / "trace.jsonl")
    text = preport.render_report(preport.load_trace(str(path)))
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith("cached:"))
    assert line.strip().startswith("cached: 3 calls")
    assert line.endswith("(1 on cpu, 2 on cuda)")
    assert "compiles" not in text
    assert preport.main([str(path)]) == 0
    assert "(1 on cpu, 2 on cuda)" in capsys.readouterr().out
    assert preport.main([str(path), "--decisions"]) == 0
    assert capsys.readouterr().out.strip() == \
        "(1260, 'load', 2, 12, None, 'burst_up')"


def test_cached_surface_names_its_device_on_the_trace():
    sc = papi.Scenario(pdists.ShiftedExp(1.0, 4.0), SERVER, 6)
    with precorder.recording() as rec:
        psc.cached_sweep(sc, [0.02], num_jobs=40, device=CPU)
    sweeps = [e for e in rec.events() if e.kind == "sweep"]
    assert [e.name for e in sweeps] == ["cached"]
    assert sweeps[0].field_dict()["device"] == CPU


def test_queue_step_with_fixed_k_matches_the_lane_engine():
    """The controller's float64 twin of the lane step against the port's
    float32 lanes on dyadic inputs (every value exact in both)."""
    rng = np.random.default_rng(13)
    n, jobs = 6, 80
    A = np.cumsum(rng.integers(1, 8, jobs)).astype(np.float64)
    S = rng.integers(1, 16, (jobs, n)).astype(np.float64)
    trace = pscen.RegimeTrace(
        regimes=(pscen.Regime(pdists.ShiftedExp(1.0, 1.0), jobs,
                              arrivals=pscen.PoissonArrivals(1.0)),),
        scaling=SERVER, n=n, seed=0, s_values=(1,), tables=({1: S},),
        arrivals=A)
    for k in (1, 2, 3, 6):
        lanes = _static_queue_costs(trace, (k,), {n // k: S}, "batched",
                                    False, 0.0, device=CPU)
        F, lat = np.zeros(n), []
        for t in range(jobs):
            F, c = _queue_step(F, A[t], S[t], k, False, 0.0)
            lat.append(c)
        np.testing.assert_array_equal(lanes[k], np.asarray(lat))


# --------------------------------------------------------------------------
# The device guard
# --------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["AdaptivePlanner", "load_aware",
                                   "replay", "sample_regime_trace"])
def test_entry_points_raise_without_cuda_unless_cpu_requested(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    sc = papi.Scenario(pdists.BiModal(10.0, 0.3), SERVER, N)
    regimes = [pscen.Regime(pdists.ShiftedExp(1.0, 10.0), 30,
                            arrivals=pscen.PoissonArrivals(0.01))]
    calls = {
        "AdaptivePlanner": (lambda: papi.AdaptivePlanner(sc),
                            lambda: papi.AdaptivePlanner(sc, device=CPU)),
        "load_aware": (
            lambda: pctl.RedundancyController(sc, objective="load_aware"),
            lambda: pctl.RedundancyController(sc, objective="load_aware",
                                              device=CPU)),
        "replay": (
            lambda: pctl.replay(pscen.sample_regime_trace(
                regimes, SERVER, N, device=CPU),
                pctl.RedundancyController(sc, device=CPU)),
            lambda: pctl.replay(pscen.sample_regime_trace(
                regimes, SERVER, N, device=CPU),
                pctl.RedundancyController(sc, device=CPU), device=CPU)),
        "sample_regime_trace": (
            lambda: pscen.sample_regime_trace(regimes, SERVER, N),
            lambda: pscen.sample_regime_trace(regimes, SERVER, N,
                                              device=CPU)),
    }
    default, on_cpu = calls[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default()
    assert on_cpu() is not None


def test_adaptive_planner_on_the_cpu_and_its_string_mode():
    ap = papi.AdaptivePlanner(papi.Scenario(pdists.BiModal(10.0, 0.3),
                                            SERVER, N),
                              objective="load_aware", device=CPU)
    obj = ap.controller.load_objective
    assert (obj.num_jobs, obj.reps, obj.backend, obj.device) == \
        (600, 2, "cached", CPU)
    assert ap.controller.planner.objective.device == CPU
    assert "AdaptivePlanner" in papi.__all__
    assert "TrainerActuator" in pctl.__all__      # ported with training
    rng = np.random.default_rng(1)
    events = [ap.observe(1.0 + rng.exponential(2.0, N)) for _ in range(20)]
    assert ap.model is not None and ap.events
    assert [e for e in events if e is not None] == ap.events
    hedge = pcontroller.HedgedServeActuator()
    assert ap.attach(hedge) is ap and hedge in ap.controller.actuators


# --------------------------------------------------------------------------
# The example twins, on the CPU at smoke size
# --------------------------------------------------------------------------

def _example(name):
    return runpy.run_path(str(ROOT / "examples" / name))["main"]


def test_example_adaptive_load_twin(tmp_path, capsys):
    path = tmp_path / "trace.jsonl"
    assert _example("torch_adaptive_load.py")(
        ["--steps", "40", "--device", CPU, "--trace", str(path)]) == 0
    out = capsys.readouterr().out
    assert "decision log verified" in out and "[cached surface]" in out
    events = precorder.parse_jsonl(str(path))
    assert {e.field_dict()["device"] for e in events
            if e.kind == "sweep"} == {CPU}


def test_example_serve_slo_twin(capsys):
    assert _example("torch_serve_slo.py")(["--smoke", "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "committed plans (p99 objective)" in out
    assert "source: plan" in out


def test_example_fault_tolerance_twin_equals_reference(capsys):
    """Host numpy end to end: the twin prints what the reference prints."""
    assert _example("torch_fault_tolerance.py")(
        ["--steps", "30", "--device", CPU]) == 0
    got = capsys.readouterr().out
    _ref("repro.control")
    import sys
    argv, sys.argv = sys.argv, ["fault_tolerance.py", "--steps", "30"]
    try:
        assert _example("fault_tolerance.py")() == 0
    finally:
        sys.argv = argv
    assert got == capsys.readouterr().out
    assert "quarantined=[3, 7, 11]" in got


def test_example_serve_hedged_twin(capsys):
    assert _example("torch_serve_hedged.py")(["--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "fitted service model: pareto" in out
    assert "r=4:" in out


# --------------------------------------------------------------------------
# On the card: the card's traces and static lanes equal the host's
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("scaling", ["server", "data", "additive"])
def test_card_trace_equals_host_trace(cuda, scaling):
    regimes = [
        pscen.Regime(pdists.ShiftedExp(1.0, 10.0), 200,
                     arrivals=pscen.PoissonArrivals(0.03)),
        pscen.Regime(pdists.Pareto(1.0, 1.2), 200,
                     arrivals=pscen.MMPPArrivals(0.03, slow=0.2, burst=5.0)),
        pscen.Regime(pdists.BiModal(10.0, 0.3), 200,
                     arrivals=pscen.DeterministicArrivals(0.1))]
    a, b = (pscen.sample_regime_trace(regimes, pdists.Scaling(scaling), 12,
                                      seed=3, device=d) for d in (cuda, CPU))
    for ta, tb in zip(a.tables, b.tables):
        for s in a.s_values:
            np.testing.assert_array_equal(ta[s], tb[s])
    np.testing.assert_array_equal(a.arrivals, b.arrivals)


@pytest.mark.gpu
def test_card_static_lanes_equal_host_lanes(cuda):
    trace = pscen.sample_regime_trace(
        [pscen.Regime(pdists.ShiftedExp(1.0, 10.0), 300,
                      arrivals=pscen.PoissonArrivals(0.03))], SERVER, 12,
        seed=1, device=CPU)
    times = {s: trace.times(s) for s in trace.s_values}
    ks = (1, 2, 3, 4, 6, 12)
    card, host = (_static_queue_costs(trace, ks, times, "batched", False,
                                      0.0, device=d) for d in (cuda, CPU))
    for k in ks:
        np.testing.assert_array_equal(card[k], host[k])


@pytest.mark.gpu
def test_card_mmpp_surface_is_distributed_as_the_hosts(cuda):
    """The cached load-aware surface under burst_flip's committed MMPP
    model (n 24, 600 jobs, 2 reps), over 16 seeds on the card and on the
    host: each device's draws are another sample of the same law, so the
    per-k means agree within 3 standard errors of their difference and
    both rank k 24 ahead of k 12."""
    sc = papi.Scenario(pdists.ShiftedExp(1.0, 10.0), SERVER, 24,
                       arrivals=pscen.MMPPArrivals(0.0428, slow=0.2372,
                                                   burst=4.2162))
    curves = {}
    for dev in (CPU, cuda):
        curves[dev] = np.array([[
            c[12], c[24]] for c in (papi.LoadAwareLatency(
                num_jobs=600, reps=2, backend="cached", preempt=False,
                seed=seed, arrival_rate=0.0428, device=dev).curve(
                    sc, [12, 24]) for seed in range(16))])
    host, card = curves[CPU], curves[cuda]
    se = np.sqrt(host.var(0, ddof=1) / 16 + card.var(0, ddof=1) / 16)
    gain = {dev: 1.0 - c[:, 1] / c[:, 0] for dev, c in curves.items()}
    print(f"\n  MMPP surface, 16 seeds: mean k 12 / 24 host {host.mean(0)}, "
          f"card {card.mean(0)}, standard error {se}; seed 0 host "
          f"{host[0]}, card {card[0]}; k 24's gain >= 10 % at "
          + ", ".join(f"{int((g >= 0.10).sum())}/16 seeds ({dev})"
                      for dev, g in gain.items()))
    assert np.all(np.abs(host.mean(0) - card.mean(0)) <= 3 * se)
    assert host.mean(0)[1] < host.mean(0)[0] and \
        card.mean(0)[1] < card.mean(0)[0]
