"""The port's load-aware queueing path against the JAX package.

Three kinds of check, strongest first:

  1. EXACT, on injected inputs: the same numpy (service, arrival) arrays
     and, for failure cells, the same (crash, recovery) schedule go through
     the reference's ``runtime.cluster.simulate`` and the port's, on the
     CPU.  Plain and grouped lanes give the reference's float32 latencies
     bit for bit; failure lanes are held to rtol 1e-6 (XLA may contract a
     multiply-add in ``retry.delay`` that torch does not; on these cells
     it does not, and the latencies come out equal too).  The oracles are
     float64 numpy in both packages and agree bitwise.
  2. ``summarize_sweep`` bitwise on the same cubes.
  3. Statistical: the port's own draws (torch generators cannot replay
     threefry streams) against the reference's sweep, at the tolerances
     of ``tests/test_cluster_batched.py``.

The JAX package is imported inside the tests that compare with it, so the
card's test (marked ``gpu``) also runs on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch import api as papi
from repro_torch.assign import strategies as pa
from repro_torch.assign.surface import co_sweep
from repro_torch.core.distributions import BiModal, Pareto, Scaling, ShiftedExp
from repro_torch.core.policy import Policy, RetryPolicy
from repro_torch.core.scenario import (DeterministicArrivals, FailureModel,
                                       MMPPArrivals, PoissonArrivals,
                                       Scenario, arrival_gap,
                                       sample_task_matrix)
from repro_torch.obs import recorder
from repro_torch.runtime import cluster_batched as pcb
from repro_torch.runtime.cluster import (ClusterConfig, latency_vs_redundancy,
                                         optimal_k_vs_load, simulate)

CPU = "cpu"
JOBS, N = 300, 6
RETRY = dict(max_attempts=3, backoff_base=0.5, backoff_mult=2.0)
SEMANTICS = [(True, 0.0), (True, 1.5), (False, 0.0)]


def _ref(name):
    pytest.importorskip("jax")
    return pytest.importorskip(name)


def _injected(seed=42, jobs=JOBS, n=N, events=4):
    """(svc, arrivals, crash, recovery) as numpy float64, from a seed."""
    rng = np.random.default_rng(seed)
    svc = 1.0 + rng.exponential(4.0, size=(jobs, n))
    arr = np.cumsum(rng.exponential(1 / 0.07, size=jobs))
    up = rng.exponential(60.0, (n, events))
    down = rng.exponential(8.0, (n, events))
    crash = np.cumsum(up + np.pad(down[:, :-1], ((0, 0), (1, 0))), axis=1)
    return svc, arr, crash, crash + down


def _assignment(mod, name):
    """The same placement strategy from either package."""
    return {None: None,
            "groups2": lambda: mod.ReplicationGroups(g=2),
            "round_robin": lambda: mod.RoundRobin(),
            "speed_aware": lambda: mod.SpeedAware(speeds=(1, 2, 3, 1, 2, 3)),
            "random": lambda: mod.RandomGroups(seed=3)}[name]() \
        if name else None


def _both(backend, preempt, oh, assignment=None, retry=None, failure=False,
          k=2, seed=42):
    """The same injected cell through the reference and the port."""
    rc = _ref("repro.runtime.cluster")
    rd = _ref("repro.core.distributions")
    ra = _ref("repro.assign.strategies")
    rp = _ref("repro.core.policy")
    svc, arr, crash, rec = _injected(seed)
    kw = dict(crash_times=crash, recovery_times=rec) if failure else {}
    common = dict(n_workers=N, k=k, arrival_rate=0.07, num_jobs=JOBS,
                  preempt=preempt, cancel_overhead=oh, seed=0)
    ref = rc.simulate(
        rc.ClusterConfig(**common, assignment=_assignment(ra, assignment),
                         retry=None if retry is None
                         else rp.RetryPolicy(**retry)),
        rd.ShiftedExp(1.0, 4.0), rd.Scaling.SERVER_DEPENDENT,
        backend=backend, service_times=svc, arrival_times=arr, **kw)
    port = simulate(
        ClusterConfig(**common, assignment=_assignment(pa, assignment),
                      retry=None if retry is None else RetryPolicy(**retry)),
        ShiftedExp(1.0, 4.0), Scaling.SERVER_DEPENDENT, backend=backend,
        service_times=svc, arrival_times=arr, device=CPU, **kw)
    return ref, port


# --------------------------------------------------------------------------
# 1. Exact on injected inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("assignment", [None, "groups2", "round_robin",
                                        "speed_aware", "random"])
@pytest.mark.parametrize("preempt,oh", SEMANTICS)
def test_batched_lanes_exact_on_injected_inputs(assignment, preempt, oh):
    ref, port = _both("batched", preempt, oh, assignment)
    np.testing.assert_array_equal(port.latencies, ref.latencies)
    assert port.latencies.dtype == ref.latencies.dtype
    np.testing.assert_allclose(port.utilization, ref.utilization, rtol=1e-5)
    np.testing.assert_allclose(port.wasted_frac, ref.wasted_frac, rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(port.throughput, ref.throughput, rtol=1e-12)
    assert port.job_failed is None


@pytest.mark.parametrize("assignment", [None, "groups2", "random"])
@pytest.mark.parametrize("preempt,oh", SEMANTICS)
@pytest.mark.parametrize("retry,k", [(RETRY, 2),
                                     (dict(max_attempts=2, timeout=9.0), 6)],
                         ids=["crash_retry", "crash_timeout"])
def test_failure_lanes_on_injected_schedule(assignment, preempt, oh, retry,
                                            k):
    """k = 6 of 6 under a killing timeout: a task longer than the timeout
    loses both attempts, so about half the jobs fail."""
    ref, port = _both("batched", preempt, oh, assignment, retry=retry,
                      failure=True, k=k)
    np.testing.assert_allclose(port.latencies, ref.latencies, rtol=1e-6)
    np.testing.assert_array_equal(port.job_failed, ref.job_failed)
    np.testing.assert_allclose(port.utilization, ref.utilization, rtol=1e-5)
    np.testing.assert_allclose(port.wasted_frac, ref.wasted_frac, rtol=1e-5)
    assert k < N or 0.2 < port.failure_rate < 0.9


@pytest.mark.parametrize("assignment", [None, "groups2", "random"])
@pytest.mark.parametrize("preempt,oh", SEMANTICS)
@pytest.mark.parametrize("failure", [False, True])
def test_oracle_bitwise_on_injected_inputs(assignment, preempt, oh, failure):
    ref, port = _both("oracle", preempt, oh, assignment,
                      retry=RETRY if failure else None, failure=failure)
    np.testing.assert_array_equal(port.latencies, ref.latencies)
    assert port.utilization == ref.utilization
    assert port.wasted_frac == ref.wasted_frac
    assert port.throughput == ref.throughput
    if failure:
        np.testing.assert_array_equal(port.job_failed, ref.job_failed)


def test_oracle_legacy_poisson_stream_is_shared():
    """``cfg.arrivals is None`` draws numpy's Poisson stream in both
    packages; with the task times injected, the oracles agree bitwise."""
    rc = _ref("repro.runtime.cluster")
    rd = _ref("repro.core.distributions")
    svc = _injected()[0]
    common = dict(n_workers=N, k=3, arrival_rate=0.06, num_jobs=JOBS, seed=5)
    ref = rc.simulate(rc.ClusterConfig(**common), rd.ShiftedExp(1.0, 4.0),
                      rd.Scaling.SERVER_DEPENDENT, service_times=svc)
    port = simulate(ClusterConfig(**common), ShiftedExp(1.0, 4.0),
                    Scaling.SERVER_DEPENDENT, service_times=svc, device=CPU)
    np.testing.assert_array_equal(port.latencies, ref.latencies)


@pytest.mark.parametrize("backend", ["oracle", "batched"])
def test_purge_window_blocks_arrivals_and_is_busy(backend):
    """Hand-computed (``tests/test_cluster_batched.py``): n=2, k=1,
    cancel_overhead=2.  Job 0 completes at t=1 and worker 1 is blocked
    until t=3, so job 1 (t=1.5) finishes at 3.5; busy 8.5, wasted 7.0."""
    svc = np.array([[1.0, 10.0], [5.0, 0.5]])
    arr = np.array([0.0, 1.5])
    cfg = ClusterConfig(n_workers=2, k=1, arrival_rate=1.0, num_jobs=2,
                        preempt=True, cancel_overhead=2.0, seed=0)
    r = simulate(cfg, ShiftedExp(0.0, 1.0), Scaling.SERVER_DEPENDENT,
                 backend=backend, service_times=svc, arrival_times=arr,
                 device=CPU)
    np.testing.assert_allclose(r.latencies, [1.0, 2.0], atol=1e-5)
    np.testing.assert_allclose(r.utilization, 8.5 / (2 * 3.5), atol=1e-5)
    np.testing.assert_allclose(r.wasted_frac, 7.0 / 8.5, atol=1e-5)


@pytest.mark.parametrize("backend,busy,waste", [("oracle", 6.1, 4.0),
                                               ("batched", 8.1, 6.0)])
def test_no_preempt_remnants_run_out(backend, busy, waste):
    """Hand-computed no-preempt trace (``tests/test_cluster_batched.py``):
    equal latencies; busy/waste differ only by the trace-boundary rule
    (the oracle drops the last job's remnant, the lanes count it)."""
    svc = np.array([[1.0, 4.0], [1.0, 1.0], [2.0, 0.1]])
    arr = np.array([0.0, 0.5, 6.0])
    cfg = ClusterConfig(n_workers=2, k=1, arrival_rate=1.0, num_jobs=3,
                        preempt=False, seed=0)
    r = simulate(cfg, ShiftedExp(0.0, 1.0), Scaling.SERVER_DEPENDENT,
                 backend=backend, service_times=svc, arrival_times=arr,
                 device=CPU)
    np.testing.assert_allclose(r.latencies, [1.0, 1.5, 0.1], atol=1e-5)
    np.testing.assert_allclose(r.utilization, busy / (2 * 6.1), atol=1e-5)
    np.testing.assert_allclose(r.wasted_frac, waste / busy, atol=1e-5)


def test_grouped_g1_is_bit_equal_to_the_ungrouped_lane():
    """One group of every worker with r = k is the all-workers rule: the
    masked-sort selection must give the ungrouped lane's latencies."""
    svc, arr, _, _ = _injected(7)
    base = dict(n_workers=N, k=3, arrival_rate=0.07, num_jobs=JOBS, seed=0)
    out = [simulate(ClusterConfig(**base, assignment=a),
                    ShiftedExp(1.0, 4.0), Scaling.SERVER_DEPENDENT,
                    backend="batched", service_times=svc,
                    arrival_times=arr, device=CPU)
           for a in (None, pa.ReplicationGroups(g=1))]
    np.testing.assert_array_equal(out[0].latencies, out[1].latencies)
    assert out[0].utilization == out[1].utilization


# --------------------------------------------------------------------------
# 2. summarize_sweep bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_ok", [False, True])
def test_summarize_sweep_bitwise(with_ok):
    rcb = _ref("repro.runtime.cluster_batched")
    rng = np.random.default_rng(3)
    R, L, K, J, n = 2, 3, 4, 200, 8
    lat = rng.exponential(5.0, (R, L, K, J)).astype(np.float32)
    busy = rng.uniform(100, 200, (R, L, K)).astype(np.float32)
    wasted = (busy * rng.uniform(0, 0.5, (R, L, K))).astype(np.float32)
    a_last = rng.uniform(1000, 2000, (R, L)).astype(np.float32)
    ok = horizon = None
    if with_ok:
        ok = rng.uniform(size=(R, L, K, J)) > 0.1
        ok[:, 0, 0] = False                      # an all-failed cell -> inf
        horizon = (a_last[:, :, None] + lat.max(-1)).astype(np.float32)
    args = (lat, busy, wasted, a_last, [0.1, 0.2, 0.3], [1, 2, 4, 8], 20,
            R, J, n)
    ref = rcb.summarize_sweep(*args, ok=ok, horizon=horizon)
    port = pcb.summarize_sweep(*args, ok=ok, horizon=horizon)
    for m in ("mean", "p50", "p95", "p99", "utilization", "wasted_frac",
              "throughput") + (("failure_rate",) if with_ok else ()):
        np.testing.assert_array_equal(port.metric(m), ref.metric(m), m)
    assert port.kstar() == {float(k): (v if isinstance(v, int) else v)
                            for k, v in ref.kstar().items()}


# --------------------------------------------------------------------------
# 3. Statistical: the port's own draws against the reference's sweep
# --------------------------------------------------------------------------

GRID = [
    (("ShiftedExp", 1.0, 5.0), "SERVER_DEPENDENT", None, 0.012, True, 0.0),
    (("ShiftedExp", 1.0, 2.0), "ADDITIVE", None, 0.03, True, 0.0),
    (("Pareto", 1.0, 2.2), "SERVER_DEPENDENT", None, 0.04, True, 0.0),
    (("Pareto", 1.0, 2.2), "DATA_DEPENDENT", 0.5, 0.05, True, 0.0),
    (("BiModal", 10.0, 0.3), "ADDITIVE", None, 0.05, True, 0.0),
    (("BiModal", 5.0, 0.2), "SERVER_DEPENDENT", None, 0.04, False, 0.0),
    (("ShiftedExp", 1.0, 5.0), "SERVER_DEPENDENT", None, 0.012, True, 1.0),
]
PORT_DISTS = {"ShiftedExp": ShiftedExp, "Pareto": Pareto, "BiModal": BiModal}


def _close(bs, rs):
    """``tests/test_cluster_batched.py``'s distributional tolerances."""
    assert abs(bs["mean"] - rs["mean"]) / rs["mean"] < 0.15, (bs, rs)
    assert abs(bs["p95"] - rs["p95"]) / rs["p95"] < 0.35, (bs, rs)
    assert abs(bs["utilization"] - rs["utilization"]) < 0.05, (bs, rs)
    assert abs(bs["wasted_frac"] - rs["wasted_frac"]) < 0.05, (bs, rs)


@pytest.mark.parametrize("dist,scaling,delta,lam,preempt,oh", GRID)
def test_sweep_distributional_parity(dist, scaling, delta, lam, preempt, oh):
    rcb = _ref("repro.runtime.cluster_batched")
    rd = _ref("repro.core.distributions")
    rs = _ref("repro.core.scenario")
    family, *params = dist
    kw = dict(loads=[lam], num_jobs=1000, reps=4, preempt=preempt,
              cancel_overhead=oh, seed=7, warmup=100)
    ref = rcb.sweep(rs.Scenario(getattr(rd, family)(*params),
                                getattr(rd.Scaling, scaling), 8,
                                delta=delta), **kw)
    port = pcb.sweep(Scenario(PORT_DISTS[family](*params),
                              getattr(Scaling, scaling), 8, delta=delta),
                     device=CPU, **kw)
    assert port.ks == ref.ks
    for i in range(len(port.ks)):
        _close(port.summary(0, i), ref.summary(0, i))


@pytest.mark.parametrize("grouped", [False, True])
def test_failure_sweep_distributional_parity(grouped):
    """Crash-restart lanes on the port's own draws; the grouped case adds
    random placement (g 2), backoff jitter and three loads."""
    rcb = _ref("repro.runtime.cluster_batched")
    rd = _ref("repro.core.distributions")
    rs = _ref("repro.core.scenario")
    rp = _ref("repro.core.policy")
    ra = _ref("repro.assign.strategies")
    n, fm, retry = 6, (60.0, 6.0), RETRY
    kw = dict(loads=[0.02], num_jobs=800, reps=4, seed=3, warmup=80)
    rkw, pkw = {}, {}
    if grouped:
        n, fm, retry = 8, (40.0, 8.0), dict(max_attempts=2, jitter=0.5)
        kw = dict(loads=[0.01, 0.03, 0.05], ks=[2, 4, 8], num_jobs=600,
                  reps=3, seed=2, warmup=60, preempt=False)
        rkw = dict(assignment=ra.RandomGroups(g=2))
        pkw = dict(assignment=pa.RandomGroups(g=2))
    ref = rcb.sweep(rs.Scenario(rd.ShiftedExp(1.0, 3.0),
                                rd.Scaling.SERVER_DEPENDENT, n,
                                failures=rs.FailureModel(*fm)),
                    retry=rp.RetryPolicy(**retry), **kw, **rkw)
    port = pcb.sweep(Scenario(ShiftedExp(1.0, 3.0), Scaling.SERVER_DEPENDENT,
                              n, failures=FailureModel(*fm)),
                     retry=RetryPolicy(**retry), device=CPU, **kw, **pkw)
    for li in range(len(port.loads)):
        for i in range(len(port.ks)):
            _close(port.summary(li, i), ref.summary(li, i))
            assert abs(port.failure_rate[li, i]
                       - ref.failure_rate[li, i]) < 0.05


def test_co_sweep_distributional_parity():
    ra = _ref("repro.assign.surface")
    rst = _ref("repro.assign.strategies")
    rd = _ref("repro.core.distributions")
    rs = _ref("repro.core.scenario")
    speeds = (3.0, 3.0) + (1.0,) * 4
    kw = dict(num_jobs=800, reps=2, preempt=False, seed=0, warmup=80)
    ref = ra.co_sweep(rs.Scenario(rd.ShiftedExp(1.0, 1.25),
                                  rd.Scaling.SERVER_DEPENDENT, 6,
                                  worker_speeds=speeds), [0.02],
                      [rst.AllWorkers(), rst.RoundRobin(),
                       rst.RandomGroups()], **kw)
    port = co_sweep(Scenario(ShiftedExp(1.0, 1.25), Scaling.SERVER_DEPENDENT,
                             6, worker_speeds=speeds), [0.02],
                    [pa.AllWorkers(), pa.RoundRobin(), pa.RandomGroups()],
                    device=CPU, **kw)
    assert port.ks == ref.ks
    for a in range(3):
        for i in range(len(port.ks)):
            _close(port.sweeps[a].summary(0, i), ref.sweeps[a].summary(0, i))


def test_kstar_vs_load_agrees_where_the_margin_is_wide():
    """Data-dependent S-Exp(5, 1) on n=8: k=8 leads k=4 by ~2.9 time units
    (one job alone: 7.72 against 10.64), at both loads."""
    rapi = _ref("repro.api")
    rd = _ref("repro.core.distributions")
    loads = [0.01, 0.05]
    ref = rapi.Planner().kstar_vs_load(
        rapi.Scenario(rd.ShiftedExp(5.0, 1.0), rd.Scaling.DATA_DEPENDENT, 8),
        loads, rapi.LoadAwareLatency(num_jobs=600, reps=2))
    port = papi.Planner().kstar_vs_load(
        papi.Scenario(ShiftedExp(5.0, 1.0), Scaling.DATA_DEPENDENT, 8),
        loads, papi.LoadAwareLatency(num_jobs=600, reps=2, device=CPU))
    assert port == ref == {0.01: 8, 0.05: 8}


def test_entry_points_on_the_host():
    """The dispatchers, the oracle surface and the co-planners run end to
    end on ``device='cpu'`` and agree with each other."""
    d = ShiftedExp(1.0, 3.0)
    kb = optimal_k_vs_load(d, Scaling.SERVER_DEPENDENT, 6, [0.02, 0.06],
                           num_jobs=300, device=CPU)
    assert set(kb) == {0.02, 0.06} and all(6 % k == 0 for k in kb.values())
    curve = latency_vs_redundancy(d, Scaling.SERVER_DEPENDENT, 6, 0.02,
                                  num_jobs=300, backend="oracle", device=CPU)
    assert sorted(curve) == [1, 2, 3, 6]
    sc = Scenario(d, Scaling.SERVER_DEPENDENT, 6)
    obj = papi.LoadAwareLatency(arrival_rate=0.05, num_jobs=300, seed=4,
                                warmup=30, backend="oracle", device=CPU)
    surf = obj.surface(sc, [0.05])
    for j, k in enumerate(surf.ks):
        cfg = ClusterConfig(6, k, 0.05, num_jobs=300, seed=4, warmup=30)
        direct = simulate(cfg, d, sc.scaling, device=CPU).summary()
        assert surf.summary(0, j) == pytest.approx(direct)
    law = papi.LoadAwareLatency(arrival_rate=0.05, num_jobs=300, reps=2,
                                device=CPU)
    plan = papi.Planner(law).co_plan(sc, [pa.AllWorkers(), pa.RoundRobin()])
    assert plan.k in surf.ks and plan.policy.assignment == plan.assignment
    co = papi.Planner(law).co_kstar_vs_load(sc, [0.02, 0.05],
                                            [pa.AllWorkers(), pa.RoundRobin()])
    assert set(co) == {0.02, 0.05}


def test_one_engine_call_per_surface_and_a_sweep_event():
    sc = Scenario(ShiftedExp(1.0, 3.0), Scaling.SERVER_DEPENDENT, 6)
    before = pcb.sweep_compile_count()
    with recorder.recording() as rec:
        sw = pcb.sweep(sc, loads=[0.01, 0.03, 0.05], num_jobs=200, reps=2,
                       device=CPU)
    assert pcb.sweep_compile_count() == before + 1
    assert sw.mean.shape == (3, len(sw.ks))
    (ev,) = rec.events("sweep")
    assert ev.name == "batched" and dict(ev.fields)["lanes"] == 3 * 4
    again = pcb.sweep(sc, loads=[0.01, 0.03, 0.05], num_jobs=200, reps=2,
                      device=CPU)
    np.testing.assert_array_equal(again.mean, sw.mean)      # seeded, CRN


# --------------------------------------------------------------------------
# Samplers
# --------------------------------------------------------------------------

def test_deterministic_arrivals_equal_the_reference_bitwise():
    rs = _ref("repro.core.scenario")
    jax = pytest.importorskip("jax")
    for rate in (2.0, 0.07, 1.0 / 3.0):
        ref = np.asarray(rs.DeterministicArrivals(rate=1.0).times(
            jax.random.PRNGKey(0), 4000, rate))
        port = DeterministicArrivals(rate=1.0).times(
            torch.Generator().manual_seed(0), 4000, rate).numpy()
        np.testing.assert_array_equal(port, ref)


def _gaps(process, rate, jobs=200_000, seed=1):
    t = process.times(torch.Generator().manual_seed(seed), jobs, rate)
    assert t.dtype == torch.float32 and t.shape == (jobs,)
    return np.diff(t.double().numpy(), prepend=0.0)


def test_poisson_and_mmpp_gaps():
    """Mean gap 1/r within five standard errors; MMPP burstier."""
    rate = 0.5
    poisson = _gaps(PoissonArrivals(rate=1.0), rate)
    mmpp = _gaps(MMPPArrivals(rate=1.0, slow=0.2, burst=5.0, switch=0.02),
                 rate)
    for g, batch in ((poisson, 1), (mmpp, 2000)):
        # MMPP gaps are correlated in runs: its standard error uses block
        # means of 2000 gaps (dwell time ~1/switch = 50 arrivals)
        blocks = g[: g.size // batch * batch].reshape(-1, batch).mean(1)
        se = blocks.std() / np.sqrt(blocks.size)
        assert abs(g.mean() - 1.0 / rate) < 5.0 * se, (g.mean(), se)
    cv = lambda g: g.std() / g.mean()                       # noqa: E731
    assert abs(cv(poisson) - 1.0) < 0.02
    assert cv(mmpp) > cv(poisson) + 0.2


def test_arrivals_sweep_rate_over_one_draw():
    """A (L, 1) rate tensor sweeps loads over ONE draw: every load row is
    the same gaps divided by its rate."""
    rates = torch.tensor([[0.5], [2.0]])
    t = PoissonArrivals(rate=1.0).times(torch.Generator().manual_seed(2),
                                        50, rates, batch=(3, 1))
    assert t.shape == (3, 2, 50)
    np.testing.assert_allclose((t[:, 0] * 0.5).numpy(),
                               (t[:, 1] * 2.0).numpy(), rtol=1e-5)


def test_failure_schedule_shape_order_and_means():
    fm = FailureModel(mttf=20.0, mttr=3.0, max_events=400)
    crash, rec = fm.schedule(torch.Generator().manual_seed(4), 50)
    c, r = crash.double().numpy(), rec.double().numpy()
    assert c.shape == r.shape == (50, 400)
    assert np.all(np.diff(c, axis=1) > 0) and np.all(r >= c)
    assert np.all(c[:, 1:] >= r[:, :-1])
    up = c - np.pad(r[:, :-1], ((0, 0), (1, 0)))
    down = r - c
    for x, mean in ((up, 20.0), (down, 3.0)):
        assert abs(x.mean() - mean) < 5.0 * x.std() / np.sqrt(x.size)
    batched = fm.schedule(torch.Generator().manual_seed(4), 5, batch=(3,))
    assert batched[0].shape == (3, 5, 400)


@pytest.mark.parametrize("last,ts", [(0.0, 1.5), (1.7e9, 1.7e9 - 100.0),
                                     (5.0, 5.0 - 1e-7), (2.0, 1.0),
                                     (1.0, float("nan"))])
def test_arrival_gap_matches_the_reference(last, ts):
    rs = _ref("repro.core.scenario")
    try:
        ref = rs.arrival_gap(last, ts)
    except ValueError:
        with pytest.raises(ValueError):
            arrival_gap(last, ts)
    else:
        assert arrival_gap(last, ts) == ref


def test_sample_task_matrix_speeds_and_row_keys():
    gen = lambda: torch.Generator().manual_seed(9)          # noqa: E731
    base = sample_task_matrix(ShiftedExp(1.0, 2.0), Scaling.SERVER_DEPENDENT,
                              4, 2, 100, gen())
    slow = sample_task_matrix(ShiftedExp(1.0, 2.0), Scaling.SERVER_DEPENDENT,
                              4, 2, 100, gen(), worker_speeds=(1, 1, 2, 3))
    assert base.shape == (100, 4)
    np.testing.assert_array_equal(slow.numpy(),
                                  (base * torch.tensor([1., 1., 2., 3.])
                                   ).numpy())
    with pytest.raises(NotImplementedError, match="fleet"):
        sample_task_matrix(ShiftedExp(1.0, 2.0), Scaling.SERVER_DEPENDENT,
                           4, 2, 100, gen(), start_job=0)


# --------------------------------------------------------------------------
# Repairs, device default, slices not ported yet
# --------------------------------------------------------------------------

def test_policy_assignment_is_validated_as_in_the_reference():
    rp = _ref("repro.core.policy")
    with pytest.raises(TypeError, match="Assignment"):
        rp.Policy(n=12, k=4, assignment="x")
    with pytest.raises(TypeError, match="Assignment"):
        Policy(n=12, k=4, assignment="x")
    with pytest.raises(ValueError, match="divide"):
        Policy(n=12, k=4, assignment=pa.ReplicationGroups(g=3))
    assert Policy(n=12, k=4, assignment=pa.RoundRobin(g=2)).k == 4


def test_placements_carry_across():
    rp = _ref("repro.core.policy")
    ra = _ref("repro.assign.strategies")
    from repro_torch.convert import to_port
    for ref, port in ((ra.RoundRobin(g=2), pa.RoundRobin(g=2)),
                      (ra.SpeedAware(g=3, speeds=(1.0, 2.0) * 6),
                       pa.SpeedAware(g=3, speeds=(1.0, 2.0) * 6)),
                      (ra.RandomGroups(seed=4), pa.RandomGroups(seed=4)),
                      (ra.AllWorkers(), pa.AllWorkers())):
        policy = to_port(rp.Policy(n=12, k=6, assignment=ref), CPU)
        assert policy.assignment == port
        np.testing.assert_array_equal(
            pa.group_ids_matrix(policy.assignment, 12, 6, 5)[2],
            ra.group_ids_matrix(ref, 12, 6, 5)[2])


def test_infeasible_lives_in_the_engine_and_the_api():
    from repro_torch.api import Infeasible, InfeasibleSurfaceError
    assert Infeasible is pcb.Infeasible
    assert InfeasibleSurfaceError is pcb.InfeasibleSurfaceError
    assert not Infeasible(load=0.1, metric="mean")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    sc = Scenario(ShiftedExp(1.0, 3.0), Scaling.SERVER_DEPENDENT, 6)
    for call in (lambda: papi.LoadAwareLatency().surface(sc, [0.02]),
                 lambda: pcb.sweep(sc, [0.02], num_jobs=50),
                 lambda: co_sweep(sc, [0.02], [pa.AllWorkers()]),
                 lambda: simulate(ClusterConfig(6, 2, 0.02, num_jobs=50),
                                  sc.dist, sc.scaling)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cached_fleet_and_chunked_knobs_name_the_next_slice():
    sc = Scenario(ShiftedExp(1.0, 3.0), Scaling.SERVER_DEPENDENT, 6)
    for call in (
            lambda: papi.LoadAwareLatency(backend="cached",
                                          device=CPU).surface(sc, [0.02]),
            lambda: papi.LoadAwareLatency(chunk_size=64,
                                          device=CPU).surface(sc, [0.02]),
            lambda: optimal_k_vs_load(sc.dist, sc.scaling, 6, [0.02],
                                      backend="fleet", device=CPU),
            lambda: pcb.sweep(sc, [0.02], stream=True, device=CPU),
            lambda: co_sweep(sc, [0.02], [pa.AllWorkers()],
                             backend="cached", device=CPU),
            lambda: co_sweep(sc, [0.02], [pa.AllWorkers()], shard=2,
                             device=CPU)):
        with pytest.raises(NotImplementedError, match="next slice"):
            call()


# --------------------------------------------------------------------------
# On the card: the same injected draws on the card and on the host
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["plain", "failure", "grouped"])
def test_card_lanes_equal_host_lanes(cuda, cell):
    """Phase 6's check of ``chip_smoke.py`` at test size: the same
    injected (A, S) — and schedule — on the card and on the host give
    equal latencies; busy sums differ only in summation order."""
    svc, arr, crash, rec = _injected(11, jobs=600, n=12)
    kw = dict(crash_times=crash, recovery_times=rec) \
        if cell == "failure" else {}
    cfg = ClusterConfig(
        12, 6, 0.07, num_jobs=600,
        retry=RetryPolicy(**RETRY) if cell == "failure" else None,
        assignment=pa.ReplicationGroups(g=2) if cell == "grouped" else None)
    out = [simulate(cfg, ShiftedExp(1.0, 4.0), Scaling.SERVER_DEPENDENT,
                    backend="batched", service_times=svc, arrival_times=arr,
                    device=dev, **kw) for dev in (cuda, CPU)]
    np.testing.assert_array_equal(out[0].latencies, out[1].latencies)
    np.testing.assert_allclose(out[0].utilization, out[1].utilization,
                               rtol=1e-5)
    np.testing.assert_allclose(out[0].wasted_frac, out[1].wasted_frac,
                               rtol=1e-5, atol=1e-12)
    oracle = simulate(cfg, ShiftedExp(1.0, 4.0), Scaling.SERVER_DEPENDENT,
                      backend="oracle", service_times=svc, arrival_times=arr,
                      device=cuda, **kw)
    np.testing.assert_allclose(out[0].latencies, oracle.latencies,
                               rtol=1e-3, atol=2e-2)
    assert abs(out[0].utilization - oracle.utilization) < 2e-3
    assert abs(out[0].wasted_frac - oracle.wasted_frac) < 2e-3
