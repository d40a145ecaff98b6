"""The port's chunked fleet engine against the JAX package.

Three kinds of check, strongest first:

  1. EXACT across packages, on the CPU: the streaming state machines
     (Welford merge, Algorithm-R reservoir) on the same numpy chunks, the
     radix bisection, the lane bundles, ``summarize_fleet`` on the same
     raw arrays, ``StreamHist``, the Threefry fold-in, and a whole
     ``fleet_sweep`` on a cell whose draws are degenerate (S-Exp with no
     noise, dyadic worker speeds, clockwork arrivals), so both packages
     walk one sample path: latencies, busy, wasted, horizon and quantiles
     bit for bit at chunk sizes 1, 7 and 64.
  2. EXACT within the port: chunk == slice for every row-keyed draw, the
     dyadic Bi-Modal cell across chunkings, ``shard=1`` against the
     unsharded path, and (on the card) card against host.
  3. Statistical, at ``tests/test_fleet.py``'s tolerances: continuous and
     failure lanes across chunkings, the fleet engine against the
     monolithic engine and against the reference's fleet engine in law,
     streaming quantiles against exact ones.

The JAX package is imported inside the tests that compare with it.
"""
import numpy as np
import pytest
import torch

from repro_torch import api as papi
from repro_torch.assign import strategies as pa
from repro_torch.assign.surface import co_sweep
from repro_torch.core import threefry
from repro_torch.core.distributions import (BiModal, Pareto, Scaling,
                                            ShiftedExp)
from repro_torch.core.policy import RetryPolicy
from repro_torch.core.scenario import (DeterministicArrivals, FailureModel,
                                       MMPPArrivals, PoissonArrivals,
                                       Scenario, job_row_keys,
                                       sample_task_matrix)
from repro_torch.obs import REGISTRY, StreamHist, metrics, recorder
from repro_torch.runtime import cluster_batched as pcb
from repro_torch.runtime import fleet as pf
from repro_torch.runtime import streamstats as pss
from repro_torch.runtime import surface_cache as psc

CPU = "cpu"
SERVER = Scaling.SERVER_DEPENDENT
DATA = Scaling.DATA_DEPENDENT
METRICS = ("mean", "p50", "p95", "p99", "utilization", "wasted_frac",
           "throughput")
#: dyadic speeds: every task time and sum stays exactly representable
SPEEDS = (1.0, 2.0, 0.5, 1.0, 4.0, 0.25, 1.0, 2.0)


def _ref(name):
    pytest.importorskip("jax")
    return pytest.importorskip(name)


def _raw(pkg, sc, loads, ks, num_jobs, chunk, *, reps=1, seed=3, retry=None,
         assignment=None, stream=False, reservoir=64, shard=None,
         preempt=True, device=CPU):
    """``run_fleet`` through either package's own argument resolution."""
    cb, fl = pkg
    ks_r, loads_r, warm, arrivals, speeds = cb.validate_sweep_args(
        sc, loads, ks, num_jobs, reps, None)
    failures, retry_r = cb.resolve_failure_args(sc, retry)
    lanes = fl.build_fleet_lanes(assignment, sc.n, ks_r, sc.worker_speeds)
    kw = {} if device is None else {"device": device}
    return fl.run_fleet(sc, loads_r, lanes, num_jobs=num_jobs, reps=reps,
                        preempt=preempt, cancel_overhead=0.0, seed=seed,
                        warmup=warm, arrivals=arrivals, speeds=speeds,
                        failures=failures, retry=retry_r, chunk=chunk,
                        stream=stream, reservoir=reservoir, shard=shard,
                        **kw)


PORT = (pcb, pf)


def _reference():
    return (_ref("repro.runtime.cluster_batched"),
            _ref("repro.runtime.fleet"))


# ==========================================================================
# 1. exact across packages
# ==========================================================================

def _stream_chunks(seed, lanes, R, sizes):
    rng = np.random.default_rng(seed)
    for m in sizes:
        vals = rng.exponential(3.0, (lanes, m)).astype(np.float32)
        w = rng.random((lanes, m)) < 0.8
        u = rng.random(m).astype(np.float32)
        yield vals, w, u


@pytest.mark.parametrize("R,sizes", [(16, (5, 40, 3, 64, 64)),
                                     (4, (1, 30, 30)),
                                     (256, (64, 64, 7))])
def test_streaming_state_machines_match_the_reference(R, sizes):
    """Same (res, cnt, vals, w, u) chunks through both packages: the
    reservoir bit for bit (including chunks where many items draw one
    slot, and R smaller than a chunk), Welford to 1e-6 relative."""
    rss = _ref("repro.runtime.streamstats")
    import jax.numpy as jnp
    lanes = 3
    res_r = rss.reservoir_init(lanes, R)
    st_r = rss.welford_init(lanes)
    res_p = pss.reservoir_init(lanes, R, CPU)
    st_p = pss.welford_init(lanes, CPU)
    for vals, w, u in _stream_chunks(R, lanes, R, sizes):
        res_r, _ = rss.reservoir_update_chunk(res_r, st_r[0], jnp.asarray(vals),
                                              jnp.asarray(w), jnp.asarray(u))
        st_r = rss.welford_merge_chunk(st_r, jnp.asarray(vals),
                                       jnp.asarray(w))
        tv, tw = torch.from_numpy(vals), torch.from_numpy(w)
        res_p, cnt_after = pss.reservoir_update_chunk(
            res_p, st_p[0], tv, tw, torch.from_numpy(u))
        st_p = pss.welford_merge_chunk(st_p, tv, tw)
        np.testing.assert_array_equal(cnt_after.numpy(), np.asarray(st_r[0]))
        np.testing.assert_array_equal(res_p.numpy(), np.asarray(res_r))
    np.testing.assert_array_equal(st_p[0].numpy(), np.asarray(st_r[0]))
    np.testing.assert_allclose(st_p[1].numpy(), np.asarray(st_r[1]),
                               rtol=1e-6)
    np.testing.assert_allclose(st_p[2].numpy(), np.asarray(st_r[2]),
                               rtol=1e-6)
    cnt = np.asarray(st_r[0])[None]
    for a, b in zip(pss.welford_finalize_host(cnt, st_p[1].numpy()[None],
                                              st_p[2].numpy()[None]),
                    rss.welford_finalize_host(cnt, np.asarray(st_r[1])[None],
                                              np.asarray(st_r[2])[None])):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for a, b in zip(pss.reservoir_values_host(res_p.numpy()[None], cnt),
                    rss.reservoir_values_host(np.asarray(res_r)[None], cnt)):
        np.testing.assert_array_equal(a, b)


def test_reservoir_many_writers_one_slot_takes_the_last():
    """u = 0 sends every overflow item to slot 0: the last writer's value
    stays, as in the item-by-item loop."""
    res = torch.zeros((1, 2))
    vals = torch.arange(1.0, 7.0)[None]
    w = torch.ones((1, 6), dtype=torch.bool)
    out, cnt = pss.reservoir_update_chunk(res, torch.zeros(1, dtype=torch.int64),
                                          vals, w, torch.zeros(6))
    np.testing.assert_array_equal(out.numpy(), [[6.0, 2.0]])
    assert int(cnt) == 6


def test_kth_bisect_bitwise_with_ties_and_inf():
    rf = _ref("repro.runtime.fleet")
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    nat = rng.exponential(2.0, (6, 40)).astype(np.float32)
    nat[0, :10] = nat[0, 10]                     # ties
    nat[1, 5:] = np.inf                          # +inf tail
    nat[2] = 0.0                                 # all zero
    nat[3, ::2] = np.float32(1.5)
    ks = np.array([1, 7, 40, 11, 20, 35])
    got = pf._kth_bisect(torch.from_numpy(nat), torch.from_numpy(ks))
    ref = np.asarray(jax.vmap(rf._kth_bisect)(jnp.asarray(nat),
                                              jnp.asarray(ks)))
    srt = pcb._kth_sort(torch.from_numpy(nat),
                        torch.from_numpy(ks - 1)[:, None])[:, 0]
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), srt.numpy())


def test_default_chunk_and_lane_bundles_match_the_reference():
    rf = _ref("repro.runtime.fleet")
    ra = _ref("repro.assign.strategies")
    for j in (1, 100, 512, 513, 600, 999, 12345, 10 ** 5, 10 ** 6):
        assert pf.default_chunk(j) == rf.default_chunk(j)
    speeds = (1.0, 3.0) * 6
    for ref_a, port_a in ((None, None),
                          (ra.ReplicationGroups(), pa.ReplicationGroups()),
                          (ra.RoundRobin(g=2), pa.RoundRobin(g=2)),
                          (ra.SpeedAware(g=3), pa.SpeedAware(g=3))):
        ks = [6, 12] if ref_a is not None else [1, 3, 12]
        _same_lanes(pf.build_fleet_lanes(port_a, 12, ks, speeds),
                    rf.build_fleet_lanes(ref_a, 12, ks, speeds))
    _same_lanes(pf.co_fleet_lanes([pa.AllWorkers(), pa.ReplicationGroups()],
                                  12, [3, 12]),
                rf.co_fleet_lanes([ra.AllWorkers(), ra.ReplicationGroups()],
                                  12, [3, 12]))


def _same_lanes(a, b):
    for f in ("k", "s", "r", "gid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert getattr(a, f).dtype == getattr(b, f).dtype
    for f in ("grouped", "groups", "signature"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("failure", [False, True])
def test_summarize_fleet_bitwise_on_the_same_raw(stream, failure):
    rcb, rf = _reference()
    rs = _ref("repro.core.scenario")
    rd = _ref("repro.core.distributions")
    rp = _ref("repro.core.policy")
    sc = rs.Scenario(rd.ShiftedExp(1.0, 2.0), rd.Scaling.SERVER_DEPENDENT,
                     12, failures=rs.FailureModel(60.0, 5.0, 16)
                     if failure else None)
    raw = _raw((rcb, rf), sc, [0.1, 0.2], [3, 12], 120, 32, reps=2,
               stream=stream, reservoir=64, device=None,
               retry=rp.RetryPolicy(max_attempts=2) if failure else None)
    fields = {f: getattr(raw, f) for f in pf.FleetRaw.__dataclass_fields__}
    port = pf.summarize_fleet(pf.FleetRaw(**fields), [3, 12])
    ref = rf.summarize_fleet(raw, [3, 12])
    for m in METRICS:
        np.testing.assert_array_equal(port.metric(m), ref.metric(m), m)
    if failure:
        np.testing.assert_array_equal(port.failure_rate, ref.failure_rate)
    cut = pf.trim_raw_loads(pf.FleetRaw(**fields), 1)
    assert cut.loads == (0.1,) and cut.busy.shape[1] == 1


def test_stream_hist_matches_the_reference():
    rm = _ref("repro.obs.metrics")
    rng = np.random.default_rng(0)
    xs = rng.pareto(1.5, 700)
    a, b = StreamHist(capacity=64, seed=11), rm.StreamHist(capacity=64,
                                                           seed=11)
    for x in xs:
        a.update(x)
        b.update(x)
    np.testing.assert_array_equal(a.values(), b.values())
    assert a.snapshot() == b.snapshot()
    a.reset()
    assert a.count == 0 and a.snapshot()["min"] is None


def test_metrics_registry_matches_the_reference_contract():
    rm = _ref("repro.obs.metrics")
    for reg in (metrics.MetricsRegistry(), rm.MetricsRegistry()):
        reg.counter("c").inc(3)
        reg.gauge("g").set(2)
        h = reg.hist("h", capacity=8)
        for x in range(20):
            h.update(x)
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("c")
    a, b = metrics.MetricsRegistry(), rm.MetricsRegistry()
    for reg in (a, b):
        reg.counter("c").inc(3)
        for x in range(20):
            reg.hist("h", capacity=8).update(x)
    assert a.snapshot() == b.snapshot()
    assert a.names() == b.names() == ["c", "h"]
    a.reset()
    assert a.snapshot()["c"] == 0
    assert "surface_cache.misses" in REGISTRY.names()


def test_threefry_fold_in_is_jax_fold_in():
    import jax
    import jax.numpy as jnp
    key = jax.random.PRNGKey(123)
    idx = jnp.arange(5, 9, dtype=jnp.uint32)
    ref = np.asarray(jax.vmap(lambda i: jax.random.fold_in(key, i))(idx))
    got = job_row_keys(threefry.key(123, CPU), 5, 4)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def _degenerate_pair(scaling, assignment):
    """(port, reference) scenarios whose every draw is degenerate: S-Exp
    with no noise, dyadic speeds, clockwork arrivals."""
    rs = _ref("repro.core.scenario")
    rd = _ref("repro.core.distributions")
    ra = _ref("repro.assign.strategies")
    port = Scenario(ShiftedExp(1.0, 0.0), scaling, 8, worker_speeds=SPEEDS,
                    arrivals=DeterministicArrivals(rate=1.0))
    ref = rs.Scenario(rd.ShiftedExp(1.0, 0.0), rd.Scaling(scaling.value), 8,
                      worker_speeds=SPEEDS,
                      arrivals=rs.DeterministicArrivals(rate=1.0))
    ra_ = None if assignment is None else ra.ReplicationGroups()
    pa_ = None if assignment is None else pa.ReplicationGroups()
    return port, ref, pa_, ra_


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("scaling", [SERVER, DATA])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("stream", [False, True])
def test_degenerate_fleet_sweep_is_the_reference_bitwise(chunk, scaling,
                                                         grouped, stream):
    rcb, rf = _reference()
    sp, sr, ap, ar = _degenerate_pair(scaling, True if grouped else None)
    ks = [2, 8] if grouped else [1, 2, 8]
    kw = dict(reps=2, stream=stream, reservoir=512)
    port = _raw(PORT, sp, [0.25, 0.5], ks, 90, chunk, assignment=ap, **kw)
    ref = _raw((rcb, rf), sr, [0.25, 0.5], ks, 90, chunk, assignment=ar,
               device=None, **kw)
    for f in ("busy", "wasted", "horizon", "a_last"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), f)
    if stream:
        np.testing.assert_array_equal(port.cnt, ref.cnt)
        np.testing.assert_array_equal(port.res, ref.res)
    else:
        np.testing.assert_array_equal(port.lat, ref.lat)
    ps, rsw = pf.summarize_fleet(port, ks), rf.summarize_fleet(ref, ks)
    for m in ("p50", "p95", "p99", "utilization", "wasted_frac",
              "throughput"):
        np.testing.assert_array_equal(ps.metric(m), rsw.metric(m), m)
    np.testing.assert_allclose(ps.mean, rsw.mean, rtol=1e-6)


# ==========================================================================
# 2. exact within the port: chunk == slice, chunkings, shards
# ==========================================================================

N, JOBS = 8, 60


def test_service_rows_chunk_equals_slice():
    key = threefry.key(7, CPU)
    for dist, scaling, s in ((ShiftedExp(1.0, 2.0), SERVER, 2),
                             (Pareto(1.0, 2.5), DATA, 2),
                             (BiModal(4.0, 0.25), Scaling.ADDITIVE, 3)):
        full = sample_task_matrix(dist, scaling, N, s, JOBS, key,
                                  delta=0.5 if scaling is DATA else None,
                                  start_job=0)
        for splits in ((0, 13, 27, 60), (0, 1, 60), (0, 60)):
            parts = [sample_task_matrix(
                dist, scaling, N, s, b - a, key,
                delta=0.5 if scaling is DATA else None, start_job=a)
                for a, b in zip(splits, splits[1:])]
            np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                          full.numpy())


@pytest.mark.parametrize("proc", [
    PoissonArrivals(rate=1.0),
    DeterministicArrivals(rate=1.0),
    MMPPArrivals(rate=1.0, slow=0.25, burst=4.0, switch=0.2),
])
def test_gaps_chunk_equals_slice(proc):
    """Gaps of [0, N) in one call == any chunking with the state carried,
    MMPP's modulating-chain parity included."""
    key = threefry.key(9, CPU)
    full, _ = proc.gaps_chunk(key, 0, JOBS, rate=0.37)
    for splits in ((0, 7, 20, 41, 60), (0, 59, 60)):
        state = proc.arrival_state0(CPU)
        parts = []
        for a, b in zip(splits, splits[1:]):
            g, state = proc.gaps_chunk(key, a, b - a, rate=0.37, state=state)
            parts.append(g)
        np.testing.assert_array_equal(torch.cat(parts).numpy(), full.numpy())


def test_gaps_chunk_independent_of_total_length():
    key = threefry.key(2, CPU)
    g30, _ = PoissonArrivals(rate=1.0).gaps_chunk(key, 0, 30)
    g60, _ = PoissonArrivals(rate=1.0).gaps_chunk(key, 0, 60)
    np.testing.assert_array_equal(g60[:30].numpy(), g30.numpy())


def test_schedule_chunk_matches_one_call():
    fm = FailureModel(mttf=50.0, mttr=5.0, max_events=12)
    key = threefry.key(4, CPU)
    c_full, r_full, _ = fm.schedule_chunk(key, N, 0, 12)
    state, cs, rs = None, [], []
    for a, b in ((0, 5), (5, 6), (6, 12)):
        c, r, state = fm.schedule_chunk(key, N, a, b - a, state=state)
        cs.append(c)
        rs.append(r)
    np.testing.assert_allclose(torch.cat(cs, 1).numpy(), c_full.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(torch.cat(rs, 1).numpy(), r_full.numpy(),
                               rtol=1e-6)
    assert (r_full >= c_full).all() and (c_full[:, 1:] >= r_full[:, :-1]).all()


@pytest.mark.parametrize("dist,mean", [
    (ShiftedExp(1.0, 2.0), 3.0), (Pareto(1.0, 2.5), 5.0 / 3.0),
    (BiModal(4.0, 0.25), 1.75)])
def test_from_uniform_laws(dist, mean):
    u = threefry.uniform(threefry.key(0, CPU)[None], 200_000)[0]
    x = dist.from_uniform(u)
    assert float(x.mean()) == pytest.approx(mean, rel=0.02)
    assert float(x.min()) >= (dist.shift if mean != 5.0 / 3.0 else 1.0)
    z = dist.noise_from_uniform(u)
    assert float(z.mean()) == pytest.approx(mean - dist.shift, rel=0.03)


def test_uniform_grid_and_exponential():
    u = threefry.uniform(threefry.key(1, CPU)[None], 100_000)[0]
    assert u.dtype == torch.float32 and 0.0 <= float(u.min())
    assert float(u.max()) < 1.0
    assert torch.equal(u, torch.floor(u * 2 ** 24) / 2 ** 24)
    e = -torch.log1p(-u)
    assert float(e.mean()) == pytest.approx(1.0, rel=0.02)


def _dyadic():
    return Scenario(BiModal(4.0, 0.25), SERVER, 12,
                    arrivals=DeterministicArrivals(rate=1.0))


def test_dyadic_bitwise_across_chunkings():
    raws = {c: _raw(PORT, _dyadic(), [0.25], [1, 3, 12], 60, c, reps=2)
            for c in (1, 7, 64)}
    for c in (1, 7):
        np.testing.assert_array_equal(raws[c].lat, raws[64].lat)
        np.testing.assert_array_equal(raws[c].busy, raws[64].busy)


def test_grouped_lanes_bitwise_across_chunkings():
    raws = {c: _raw(PORT, _dyadic(), [0.25], [3, 12], 48, c,
                    assignment=pa.ReplicationGroups())
            for c in (1, 7, 64)}
    for c in (1, 7):
        np.testing.assert_array_equal(raws[c].lat, raws[64].lat)


def test_shard_one_is_the_unsharded_path():
    sc = Scenario(ShiftedExp(1.0, 2.0), SERVER, 12)
    kw = dict(loads=[0.05, 0.2], ks=[1, 3, 12], num_jobs=50, reps=1, seed=3,
              chunk_size=16, device=CPU)
    un = pf.fleet_sweep(sc, **kw)
    sh = pf.fleet_sweep(sc, **kw, shard=1)
    for m in METRICS:
        np.testing.assert_array_equal(sh.metric(m), un.metric(m), m)
    with pytest.raises(ValueError, match="shard"):
        pf.fleet_sweep(sc, [0.1], ks=[3], num_jobs=20, chunk_size=8,
                       shard=2, device=CPU)


# ==========================================================================
# 3. statistical: chunkings, engines, streaming
# ==========================================================================

def test_continuous_tolerance_across_chunkings():
    sc = Scenario(ShiftedExp(1.0, 2.0), SERVER, 12)
    sws = {c: pf.fleet_sweep(sc, [0.05, 0.2], ks=[1, 3, 12], num_jobs=60,
                             reps=2, seed=3, chunk_size=c, device=CPU)
           for c in (1, 7, 64)}
    for c in (1, 7):
        for m in METRICS:
            np.testing.assert_allclose(sws[c].metric(m), sws[64].metric(m),
                                       rtol=2e-5, atol=1e-5,
                                       err_msg=f"{c}/{m}")


@pytest.mark.parametrize("preempt", [True, False])
def test_failure_lanes_across_chunkings(preempt):
    sc = Scenario(ShiftedExp(1.0, 2.0), SERVER, 12,
                  failures=FailureModel(mttf=80.0, mttr=4.0, max_events=16))
    retry = RetryPolicy(max_attempts=3, backoff_base=0.5, jitter=0.3)
    sws = {c: pf.fleet_sweep(sc, [0.2], ks=[3, 12], num_jobs=60, reps=2,
                             seed=5, retry=retry, chunk_size=c,
                             preempt=preempt, device=CPU)
           for c in (7, 64)}
    for m in METRICS + ("failure_rate",):
        np.testing.assert_allclose(sws[7].metric(m), sws[64].metric(m),
                                   rtol=1e-4, atol=1e-5, err_msg=m)


def test_grouped_failure_lanes_run_and_stream_equals_exact():
    sc = Scenario(ShiftedExp(1.0, 2.0), SERVER, 12,
                  failures=FailureModel(mttf=60.0, mttr=5.0, max_events=16))
    kw = dict(loads=[0.2], ks=[6, 12], num_jobs=150, reps=2, seed=7,
              retry=RetryPolicy(max_attempts=2, jitter=0.2), chunk_size=32,
              assignment=pa.ReplicationGroups(), device=CPU)
    ex = pf.fleet_sweep(sc, **kw)
    st = pf.fleet_sweep(sc, **kw, stream=True, reservoir=4096)
    np.testing.assert_array_equal(st.failure_rate, ex.failure_rate)
    np.testing.assert_array_equal(st.p99, ex.p99)
    np.testing.assert_allclose(st.mean, ex.mean, rtol=1e-5)
    assert np.isfinite(ex.mean).all() and (ex.failure_rate < 1).all()


def test_matches_monolithic_and_reference_fleet_in_law():
    """Different draws (row keys against generators, threefry words laid
    out differently from JAX's) -> agreement in law at 5 %."""
    rf = _ref("repro.runtime.fleet")
    rs = _ref("repro.core.scenario")
    rd = _ref("repro.core.distributions")
    sc = Scenario(ShiftedExp(1.0, 2.0), SERVER, 12)
    kw = dict(loads=[0.05], ks=[3], num_jobs=3000, reps=2, seed=5)
    mono = pcb.sweep(sc, **kw, device=CPU)
    chnk = pf.fleet_sweep(sc, **kw, chunk_size=256, stream=True, device=CPU)
    ref = rf.fleet_sweep(rs.Scenario(rd.ShiftedExp(1.0, 2.0),
                                     rd.Scaling.SERVER_DEPENDENT, 12),
                         **kw, chunk_size=256, stream=True)
    for other in (mono, ref):
        assert chnk.mean[0, 0] == pytest.approx(other.mean[0, 0], rel=0.05)
        assert chnk.utilization[0, 0] == pytest.approx(
            other.utilization[0, 0], rel=0.05)


def test_stream_equals_exact_when_reservoir_holds_all():
    sc = Scenario(ShiftedExp(1.0, 2.0), SERVER, 12)
    kw = dict(loads=[0.05, 0.2], ks=[1, 3, 12], num_jobs=300, reps=2,
              seed=3, chunk_size=64, device=CPU)
    ex = pf.fleet_sweep(sc, **kw)
    st = pf.fleet_sweep(sc, **kw, stream=True, reservoir=4096)
    for m in ("p50", "p95", "p99", "utilization", "wasted_frac",
              "throughput"):
        np.testing.assert_array_equal(st.metric(m), ex.metric(m), m)
    np.testing.assert_allclose(st.mean, ex.mean, rtol=1e-5)


def test_small_reservoir_is_an_estimate():
    sc = Scenario(ShiftedExp(1.0, 2.0), SERVER, 12)
    kw = dict(loads=[0.1], ks=[3], num_jobs=2000, reps=1, seed=3,
              chunk_size=128, device=CPU)
    ex = pf.fleet_sweep(sc, **kw)
    st = pf.fleet_sweep(sc, **kw, stream=True, reservoir=256)
    assert st.p50[0, 0] == pytest.approx(ex.p50[0, 0], rel=0.15)
    assert st.p95[0, 0] == pytest.approx(ex.p95[0, 0], rel=0.25)
    np.testing.assert_allclose(st.mean, ex.mean, rtol=1e-5)


def test_additive_and_mmpp_cells_run():
    sc = Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, 12,
                  arrivals=MMPPArrivals(rate=1.0, slow=0.2, burst=5.0,
                                        switch=0.02))
    sw = pf.fleet_sweep(sc, [0.01, 0.06], num_jobs=200, seed=0, chunk_size=48,
                        device=CPU)
    assert sw.mean.shape == (2, 6) and np.isfinite(sw.mean).all()
    assert all(12 % k == 0 for k in sw.kstar().values())


# ==========================================================================
# wiring: dispatch, cache, co-optimizer, validation, trace
# ==========================================================================

def _sc():
    return Scenario(ShiftedExp(1.0, 2.0), SERVER, 12)


def test_sweep_dispatches_on_chunk_knobs():
    kw = dict(loads=[0.1], ks=[3], num_jobs=40, reps=1, seed=1, device=CPU)
    a = pcb.sweep(_sc(), **kw, chunk_size=16)
    b = pf.fleet_sweep(_sc(), **kw, chunk_size=16)
    np.testing.assert_array_equal(a.mean, b.mean)


def test_cached_equals_uncached_and_counts_one_key():
    kw = dict(ks=[1, 3], num_jobs=40, reps=1, seed=1, device=CPU)
    for extra in ({}, {"chunk_size": 16}):
        c1 = psc.cached_sweep(_sc(), [0.1, 0.2, 0.3], **kw, **extra)
        run = pf.fleet_sweep if extra else pcb.sweep
        u1 = run(_sc(), [0.1, 0.2, 0.3], **kw, **extra)
        for m in METRICS:
            np.testing.assert_array_equal(c1.metric(m), u1.metric(m), m)
        misses0 = psc.surface_cache_stats()["misses"]
        hits0 = psc.surface_cache_stats()["hits"]
        psc.cached_sweep(_sc(), [0.11, 0.19, 0.27, 0.3], **kw, **extra)
        assert psc.surface_cache_stats()["misses"] == misses0
        assert psc.surface_cache_stats()["hits"] == hits0 + 1
    assert psc.load_bucket(3) == 4 and psc.load_bucket(1) == 1
    with pytest.raises(ValueError, match="bucket"):
        psc.load_bucket(129)
    hist = REGISTRY.hist("surface_cache.compile_ms")
    assert hist.count >= 2
    psc.reset_surface_cache_stats()
    assert psc.surface_cache_stats()["hits"] == 0
    assert psc.surface_cache_stats()["entries"] >= 2


def test_cache_keys_match_the_reference():
    """Both packages key the same calls the same way: the same
    hit/miss sequence over a run of re-plans."""
    rsc = _ref("repro.runtime.surface_cache")
    rs = _ref("repro.core.scenario")
    rd = _ref("repro.core.distributions")
    ref_sc = rs.Scenario(rd.ShiftedExp(1.0, 2.0),
                         rd.Scaling.SERVER_DEPENDENT, 12)
    calls = [([0.1], {}), ([0.2], {}), ([0.1, 0.2], {}), ([0.3], {}),
             ([0.1], {"chunk_size": 8}), ([0.2], {"chunk_size": 8}),
             ([0.1], {"chunk_size": 8, "stream": True})]
    seen = []
    for mod, sc, extra in ((psc, _sc(), {"device": CPU}),
                           (rsc, ref_sc, {})):
        mod.reset_surface_cache_stats()
        m0 = mod.surface_cache_stats()["misses"]
        out = []
        for loads, kw in calls:
            mod.cached_sweep(sc, loads, ks=[3, 12], num_jobs=32,
                             seed=len(out), **kw, **extra)
            out.append(mod.surface_cache_stats()["misses"] - m0)
        seen.append(out)
    assert seen[0] == seen[1]


def test_cached_calls_land_on_the_recorder():
    with recorder.recording() as rec:
        psc.cached_sweep(_sc(), [0.1], ks=[3], num_jobs=24, seed=77,
                         reps=3, device=CPU)
        pf.fleet_sweep(_sc(), [0.1], ks=[3], num_jobs=24, reps=2,
                       chunk_size=8, device=CPU)
    kinds = [e.kind for e in rec.events()]
    assert "cache_miss" in kinds or "cache_hit" in kinds
    fleet = [e for e in rec.events() if e.kind == "sweep" and e.name == "fleet"]
    assert len(fleet) == 2
    fields = dict(fleet[0].fields)
    assert fields["device"] == "cpu" and fields["num_chunks"] == 3
    assert {"rep", "reps", "n", "lanes", "chunk", "jobs", "stream",
            "rss_mb"} <= set(fields)


def test_co_sweep_chunked_matches_per_assignment():
    assigns = [pa.AllWorkers(), pa.ReplicationGroups()]
    for backend in ("batched", "cached"):
        surf = co_sweep(_sc(), [0.05, 0.2], assigns, ks=[3, 12], num_jobs=40,
                        reps=1, seed=2, chunk_size=16, backend=backend,
                        device=CPU)
        for a in assigns:
            ref = pf.fleet_sweep(_sc(), [0.05, 0.2], ks=[3, 12], num_jobs=40,
                                 reps=1, seed=2, chunk_size=16, assignment=a,
                                 device=CPU)
            np.testing.assert_allclose(surf.sweep_for(a).mean, ref.mean,
                                       rtol=1e-6)


def test_co_sweep_cached_equals_batched():
    assigns = [pa.AllWorkers(), pa.RoundRobin(g=2)]
    kw = dict(ks=[6, 12], num_jobs=40, reps=1, seed=2, device=CPU)
    a = co_sweep(_sc(), [0.05, 0.1, 0.2], assigns, backend="batched", **kw)
    b = co_sweep(_sc(), [0.05, 0.1, 0.2], assigns, backend="cached", **kw)
    for sa, sb in zip(a.sweeps, b.sweeps):
        for m in METRICS:
            np.testing.assert_array_equal(sa.metric(m), sb.metric(m), m)


def test_random_groups_and_bad_knobs_rejected():
    with pytest.raises(ValueError, match="per job"):
        pf.fleet_sweep(_sc(), [0.1], ks=[3], num_jobs=20, chunk_size=8,
                       assignment=pa.RandomGroups(), device=CPU)
    with pytest.raises(ValueError, match="chunk_size"):
        pf.fleet_sweep(_sc(), [0.1], ks=[3], num_jobs=20, chunk_size=0,
                       device=CPU)
    with pytest.raises(ValueError, match="reservoir"):
        pf.fleet_sweep(_sc(), [0.1], ks=[3], num_jobs=20, chunk_size=8,
                       stream=True, reservoir=0, device=CPU)
    with pytest.raises(ValueError, match="backend"):
        papi.LoadAwareLatency(backend="oracle", stream=True)


def test_one_configuration_per_shape():
    kw = dict(ks=[1, 3], num_jobs=40, reps=2, seed=1, chunk_size=16,
              device=CPU)
    pf.fleet_sweep(_sc(), [0.1, 0.2], **kw)
    before = pf.fleet_compile_count()
    pf.fleet_sweep(_sc(), [0.11, 0.19], **{**kw, "seed": 9})
    assert pf.fleet_compile_count() == before
    pf.fleet_sweep(_sc(), [0.11, 0.19], **{**kw, "chunk_size": 17})
    assert pf.fleet_compile_count() == before + 1


def test_co_lanes_signature_and_slice_guard():
    lanes = pf.co_fleet_lanes([pa.AllWorkers(), pa.ReplicationGroups()], 12,
                              [3, 12])
    assert lanes.grouped and lanes.k.size == 4
    assert len(lanes.signature) == 2
    raw = _raw(PORT, _sc(), [0.1], [1, 3], 30, 8)
    with pytest.raises(ValueError, match="kslice"):
        pf.summarize_fleet(raw, [1, 3], kslice=slice(0, 1))


def test_load_aware_objective_takes_the_fleet_knobs():
    obj = papi.LoadAwareLatency(num_jobs=300, chunk_size=64, stream=True,
                                metric="p99", device=CPU)
    kmap = papi.Planner().kstar_vs_load(_sc(), [0.05, 0.2], obj)
    assert set(kmap) == {0.05, 0.2} and all(12 % k == 0
                                            for k in kmap.values())
    cached = papi.LoadAwareLatency(num_jobs=300, backend="cached", device=CPU)
    plan = papi.Planner(cached).co_plan(
        _sc(), [pa.AllWorkers(), pa.ReplicationGroups()], objective=cached)
    assert plan.k in _sc().legal_ks() and np.isfinite(plan.expected_time)


# ==========================================================================
# On the card: the same row-keyed draws on the card and on the host
# ==========================================================================

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_card_dyadic_cell_equals_host_bitwise(cuda, chunk):
    raws = [_raw(PORT, _dyadic(), [0.25], [1, 3, 12], 60, chunk, reps=2,
                 device=d) for d in (cuda, CPU)]
    for f in ("lat", "busy", "wasted", "horizon"):
        np.testing.assert_array_equal(getattr(raws[0], f),
                                      getattr(raws[1], f), f)


@pytest.mark.gpu
@pytest.mark.parametrize("failure", [False, True])
def test_card_continuous_cells_equal_host_to_float32(cuda, failure):
    """Same bits on both devices; only the transcendental transforms
    (log1p) and summation orders may differ by float32 rounding."""
    sc = Scenario(ShiftedExp(1.0, 2.0), SERVER, 12,
                  failures=FailureModel(80.0, 4.0, 16) if failure else None)
    kw = dict(loads=[0.05, 0.2], ks=[1, 3, 12], num_jobs=120, reps=2,
              seed=3, chunk_size=32,
              retry=RetryPolicy(3, 0.5, jitter=0.3) if failure else None)
    card, host = (pf.fleet_sweep(sc, **kw, device=d) for d in (cuda, CPU))
    for m in METRICS + (("failure_rate",) if failure else ()):
        np.testing.assert_allclose(card.metric(m), host.metric(m),
                                   rtol=1e-4, atol=1e-5, err_msg=m)
