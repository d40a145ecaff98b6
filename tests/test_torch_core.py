"""The port's host-side core against the JAX package's, on the same inputs.

The numpy modules (``batched``, ``order_stats``, ``expectations``,
``coding``'s code constructions, the analytic parts of ``distributions``)
are copies and must agree bit for bit.  The planner must return the same
``Plan`` on the paper's nine (family x scaling) cells; the only
non-bitwise cell is the quantile/FR objective under Pareto-additive
scaling, whose task tail is a Monte-Carlo estimate drawn from a different
generator (threefry in the reference, PyTorch's here).
"""
import dataclasses
import warnings

import numpy as np
import pytest

import repro.api as ref_api
import repro.core.batched as ref_batched
import repro.core.coding as ref_coding
import repro.core.distributions as ref_dists
import repro.core.expectations as ref_expect
import repro.core.order_stats as ref_osl
import repro.core.planner as ref_planner
import repro.core.scenario as ref_scenario
from repro.runtime.straggler import fr_expected_completion as ref_fr

import repro_torch.api as api
import repro_torch.core.batched as batched
import repro_torch.core.coding as coding
import repro_torch.core.distributions as dists
import repro_torch.core.expectations as expect
import repro_torch.core.order_stats as osl
import repro_torch.core.planner as planner
from repro_torch.convert import to_port
from repro_torch.runtime.straggler import fr_expected_completion

CPU = "cpu"
KS12 = [1, 2, 3, 4, 6, 12]
S12 = [12, 6, 4, 3, 2, 1]

# the paper's nine (family x scaling) cells, as in tests/test_api.py
NINE_CELLS = [
    ("sexp_server", ("ShiftedExp", 1.0, 5.0), "server", None),
    ("sexp_data", ("ShiftedExp", 5.0, 5.0), "data", None),
    ("sexp_additive", ("ShiftedExp", 1.0, 10.0), "additive", None),
    ("pareto_server", ("Pareto", 1.0, 2.0), "server", None),
    ("pareto_data", ("Pareto", 1.0, 3.0), "data", 5.0),
    ("pareto_additive", ("Pareto", 1.0, 3.0), "additive", None),
    ("bimodal_server", ("BiModal", 10.0, 0.3), "server", None),
    ("bimodal_data", ("BiModal", 10.0, 0.3), "data", 5.0),
    ("bimodal_additive", ("BiModal", 10.0, 0.3), "additive", None),
]
CELL_IDS = [c[0] for c in NINE_CELLS]
EXACT_CELLS = [c for c in NINE_CELLS if c[0] != "pareto_additive"]


def _ref_scenario(spec, scaling, n, delta, **kw):
    fam, a, b = spec
    return ref_scenario.Scenario(getattr(ref_dists, fam)(a, b),
                                 ref_dists.Scaling(scaling), n, delta=delta,
                                 **kw)


def _same(a, b):
    """Bitwise equality of nested results (floats compared by value, arrays
    by dtype, shape and every element)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b, equal_nan=True)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b or (a != a and b != b)


def _survival(t):
    return np.exp(-np.asarray(t, dtype=np.float64) / 2.0)


# (module name, function, args): each runs in both packages; a function
# that returns a survival function is compared on a grid of times
NUMPY_CALLS = [
    ("batched", "divisors", (720,)),
    ("batched", "leggauss", (64,)),
    ("batched", "harmonic_numbers", (50,)),
    ("batched", "binom_lt_curves", (12, KS12, np.linspace(0.0, 1.0, 7))),
    ("batched", "batched_order_stat_survival", (_survival, KS12, 12)),
    ("batched", "expected_order_stats", (_survival, KS12, 12)),
    ("batched", "exponential_order_stat_curve", (KS12, 12, 2.0)),
    ("batched", "pareto_order_stat_curve", (KS12, 12, 1.0, 3.0)),
    ("batched", "bimodal_straggle_curve", (KS12, 12, 0.3)),
    ("batched", "bimodal_sum_order_stat_curve", (KS12, 12, S12, 10.0, 0.3)),
    ("batched", "erlang_order_stat_curve", (KS12, 12, S12, 5.0)),
    ("order_stats", "harmonic", (30,)),
    ("order_stats", "exponential_order_stat", (3, 12, 2.0)),
    ("order_stats", "erlang_order_stat_exact", (3, 6, 2, 1.5)),
    ("order_stats", "erlang_survival", (np.linspace(0.0, 10.0, 11), 3, 2.0)),
    ("order_stats", "erlang_order_stat", (4, 12, 3, 2.0)),
    ("order_stats", "pareto_order_stat", (5, 12, 1.0, 3.0)),
    ("order_stats", "gamma_ratio_approx", (10.0, 0.5, 1.0)),
    ("order_stats", "bimodal_straggle_prob", (4, 12, 0.3)),
    ("order_stats", "bimodal_order_stat", (4, 12, 10.0, 0.3)),
    ("order_stats", "bimodal_sum_pmf", (3, 10.0, 0.3)),
    ("order_stats", "bimodal_sum_order_stat", (4, 12, 3, 10.0, 0.3)),
    ("order_stats", "birthday_expectation", (12, 2)),
    ("order_stats", "birthday_asymptotic", (12, 2)),
    ("order_stats", "order_stat_survival", (_survival, 3, 12)),
    ("order_stats", "expected_order_stat", (_survival, 3, 12)),
    ("expectations", "sexp_additive", (3, 12, 1.0, 2.0, True)),
    ("expectations", "pareto_data_dependent_approx", (4, 12, 1.0, 3.0, 5.0)),
    ("expectations", "pareto_additive_mc", (4, 12, 1.0, 3.0, 5000, 3)),
    ("expectations", "pareto_replication_lower_bound", (12, 1.0, 5.0)),
    ("expectations", "bimodal_server_dependent_lln", (0.5, 10.0, 0.3)),
    ("expectations", "bimodal_data_dependent_lln", (0.5, 10.0, 0.3, 5.0)),
    ("expectations", "replication_additive_sexp", (12, 1.0, 2.0)),
    ("coding", "mds_generator", (12, 1)),
    ("coding", "mds_generator", (12, 6)),
    ("coding", "mds_generator", (12, 12)),
    ("coding", "mds_generator", (8, 3)),
    ("coding", "task_size_linear", (4, 12)),
    ("coding", "task_size_gradient", (9, 12)),
]
_PKGS = {"batched": (batched, ref_batched), "order_stats": (osl, ref_osl),
         "expectations": (expect, ref_expect), "coding": (coding, ref_coding)}


@pytest.mark.parametrize("mod,fn,args", NUMPY_CALLS,
                         ids=[f"{m}.{f}-{i}" for i, (m, f, _)
                              in enumerate(NUMPY_CALLS)])
def test_numpy_function_bitwise(mod, fn, args):
    port, ref = _PKGS[mod]
    out, ref_out = getattr(port, fn)(*args), getattr(ref, fn)(*args)
    if callable(out):
        t = np.linspace(0.0, 20.0, 9)
        out, ref_out = out(t), ref_out(t)
    assert _same(out, ref_out)


@pytest.mark.parametrize("name,spec,scaling,delta", NINE_CELLS, ids=CELL_IDS)
def test_completion_curve_and_scalar_bitwise(name, spec, scaling, delta):
    sc = _ref_scenario(spec, scaling, 12, delta)
    port_sc = to_port(sc, CPU)
    kw = dict(delta=delta, mc_trials=5000)
    assert _same(expect.completion_curve(port_sc.dist, port_sc.scaling, 12,
                                         **kw),
                 ref_expect.completion_curve(sc.dist, sc.scaling, 12, **kw))
    assert _same(
        expect.expected_completion_time(port_sc.dist, port_sc.scaling, 3, 12,
                                        **kw),
        ref_expect.expected_completion_time(sc.dist, sc.scaling, 3, 12, **kw))


@pytest.mark.parametrize("family", ["ShiftedExp", "Pareto", "BiModal"])
def test_distribution_analytics_bitwise(family):
    rng = np.random.default_rng(11)
    params = {"ShiftedExp": (1.0, 5.0), "Pareto": (1.0, 3.0),
              "BiModal": (10.0, 0.3)}[family]
    ref_d = getattr(ref_dists, family)(*params)
    port_d = to_port(ref_d, CPU)
    assert type(port_d) is getattr(dists, family)
    x = np.concatenate([rng.uniform(0.0, 20.0, 64), [1.0, 10.0]])
    assert _same(port_d.tail(x), ref_d.tail(x))
    assert _same(port_d.logpdf(x), ref_d.logpdf(x))
    assert port_d.mean() == ref_d.mean() and port_d.shift == ref_d.shift


def test_fits_and_selection_bitwise():
    rng = np.random.default_rng(5)
    windows = [1.0 + rng.exponential(4.0, 400),
               rng.pareto(3.0, 400) + 1.0,
               np.where(rng.random(400) < 0.2, 10.0, 1.0)
               * rng.uniform(0.95, 1.05, 400)]
    for x in windows:
        for fam in dists.FAMILIES:
            assert dataclasses.asdict(dists.fit_service_time(x, fam)) == \
                dataclasses.asdict(ref_dists.fit_service_time(x, fam))
        assert dists.bimodal_low_mode(x) == ref_dists.bimodal_low_mode(x)
        assert dists.sample_resolution(x) == ref_dists.sample_resolution(x)
        d, fam = dists.select_service_time(x, device=CPU)
        rd, rfam = ref_dists.select_service_time(x)
        assert fam == rfam and to_port(rd, CPU) == d
        assert dists.service_loglik(d, x) == ref_dists.service_loglik(rd, x)


def test_coding_constructions_bitwise():
    rng = np.random.default_rng(3)
    G = coding.mds_generator(12, 6)
    surv = sorted(rng.choice(12, 6, replace=False).tolist())
    assert _same(coding.decode_matrix(G, surv),
                 ref_coding.decode_matrix(G, surv))
    code, ref_code = (coding.fractional_repetition_code(12, 3),
                      ref_coding.fractional_repetition_code(12, 3))
    assert (code.k, code.num_groups) == (ref_code.k, ref_code.num_groups)
    assert _same(code.assignment(), ref_code.assignment())
    alive = rng.random(12) < 0.7
    alive[::3] = True                       # every group has a finisher
    assert _same(coding.gc_decode_weights(code, alive),
                 ref_coding.gc_decode_weights(ref_code, alive))


# --------------------------------------------------------------------------
# The planner: the same Plan on the nine cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,spec,scaling,delta", NINE_CELLS, ids=CELL_IDS)
def test_mean_plan_bitwise_n12(name, spec, scaling, delta):
    mc_trials = 20_000 if name == "pareto_additive" else 100_000
    sc = _ref_scenario(spec, scaling, 12, delta)
    ref = ref_api.Planner().plan(sc, ref_api.MeanCompletionTime(
        mc_trials=mc_trials))
    port = api.Planner().plan(to_port(sc, CPU), api.MeanCompletionTime(
        mc_trials=mc_trials, device=CPU))
    assert port == to_port(ref, CPU)          # every field, curve bit-for-bit
    assert port.policy == to_port(ref.policy, CPU)


@pytest.mark.parametrize("name,spec,scaling,delta", NINE_CELLS, ids=CELL_IDS)
def test_mean_plan_bitwise_n720(name, spec, scaling, delta):
    kw, mc_trials = {}, 100_000
    if name == "pareto_additive":             # MC cost ~ trials * n * s
        kw, mc_trials = dict(candidate_ks=(240, 360, 720)), 4000
    sc = _ref_scenario(spec, scaling, 720, delta, **kw)
    ref = ref_api.Planner().plan(sc, ref_api.MeanCompletionTime(
        mc_trials=mc_trials))
    port = api.Planner().plan(to_port(sc, CPU), api.MeanCompletionTime(
        mc_trials=mc_trials, device=CPU))
    assert port == to_port(ref, CPU)


@pytest.mark.parametrize("name,spec,scaling,delta", EXACT_CELLS,
                         ids=[c[0] for c in EXACT_CELLS])
def test_quantile_and_fr_bitwise(name, spec, scaling, delta):
    sc = _ref_scenario(spec, scaling, 12, delta)
    port_sc = to_port(sc, CPU)
    for ref_obj, port_obj in [
            (ref_api.QuantileCompletionTime(0.99),
             api.QuantileCompletionTime(0.99, device=CPU)),
            (ref_api.FRCompletionTime(), api.FRCompletionTime(device=CPU))]:
        ref = ref_api.Planner(ref_obj).plan(sc)
        assert api.Planner(port_obj).plan(port_sc) == to_port(ref, CPU)


def test_pareto_additive_tail_objectives_statistical():
    """Quantile and FR objectives on Pareto(1, 3) x additive, whose task
    tail is a 200k-draw Monte-Carlo estimate in both packages, from
    different generators.

    Tolerance: 15% relative per k.  The hardest point is the p99 of the
    maximum of 12 single-CU tasks (k = 12): the task tail there is
    1 - 0.99^(1/12) = 8.4e-4, about 168 of 200k draws, so each estimate's
    survival has a relative standard error of 1/sqrt(168) = 7.7% and its
    quantile, through the Pareto tail's slope alpha = 3, 2.6%.  The
    difference of two independent estimates has sigma 3.6%; 15% is four
    sigma.  The FR objective integrates the same tail and is tighter.
    """
    sc = _ref_scenario(("Pareto", 1.0, 3.0), "additive", 12, None)
    port_sc = to_port(sc, CPU)
    q = api.Planner(api.QuantileCompletionTime(0.99, device=CPU)).curve(
        port_sc)
    rq = ref_api.Planner(ref_api.QuantileCompletionTime(0.99)).curve(sc)
    for k in KS12:
        assert abs(q[k] - rq[k]) <= 0.15 * rq[k], (k, q[k], rq[k])
    # k = 12 is a single Pareto CU per task: the exact p99 of the maximum
    exact = (1.0 - 0.99 ** (1.0 / 12)) ** (-1.0 / 3.0)
    assert abs(rq[12] - exact) <= 0.15 * exact
    assert abs(q[12] - exact) <= 0.15 * exact
    for c in S12:
        port = fr_expected_completion(port_sc.dist, port_sc.scaling, 12, c,
                                      device=CPU)
        ref = ref_fr(sc.dist, sc.scaling, 12, c)
        assert abs(port - ref) <= 0.15 * ref, (c, port, ref)


def test_theorem_kstar_matches():
    for _, spec, scaling, delta in NINE_CELLS:
        sc = _ref_scenario(spec, scaling, 12, delta)
        port_sc = to_port(sc, CPU)
        assert planner.theorem_kstar(port_sc.dist, port_sc.scaling, 12,
                                     delta) == \
            ref_planner.theorem_kstar(sc.dist, sc.scaling, 12, delta)


def test_deprecated_shims_warn_and_delegate():
    d = dists.BiModal(10.0, 0.3)
    sc = api.Scenario(d, dists.Scaling.SERVER_DEPENDENT, 12)
    with pytest.warns(DeprecationWarning):
        old = planner.plan(d, dists.Scaling.SERVER_DEPENDENT, 12, device=CPU)
    assert old == api.Planner(api.MeanCompletionTime(device=CPU)).plan(sc)
    with pytest.warns(DeprecationWarning):
        grid = planner.plan_grid([d], dists.Scaling.SERVER_DEPENDENT, 12,
                                 device=CPU)
    assert grid == [old]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = ref_planner.plan(ref_dists.BiModal(10.0, 0.3),
                               ref_dists.Scaling.SERVER_DEPENDENT, 12)
    assert old == to_port(ref, CPU)


def test_infeasible_surface_raises():
    sc = api.Scenario(dists.ShiftedExp(1.0, 5.0),
                      dists.Scaling.SERVER_DEPENDENT, 12)
    with pytest.raises(api.InfeasibleSurfaceError):
        api.Planner._finalize(sc, {k: float("inf") for k in KS12})
    assert not api.Infeasible(load=0.1, metric="mean")
    # a finite cell is still chosen when others are infinite
    curve = {k: float("inf") for k in KS12}
    curve[4] = 3.0
    assert api.Planner._finalize(sc, curve).k == 4


def test_planner_raises_without_cuda_unless_cpu_requested():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    sc = api.Scenario(dists.ShiftedExp(1.0, 5.0),
                      dists.Scaling.SERVER_DEPENDENT, 12)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.Planner().plan(sc)
    assert api.Planner(api.MeanCompletionTime(device=CPU)).plan(sc).k == 1


def test_to_port_carries_records_and_arrays():
    import repro.core.scenario as rs
    import torch
    sc = rs.Scenario(ref_dists.Pareto(1.0, 3.0), ref_dists.Scaling.DATA_DEPENDENT,
                     12, delta=5.0, candidate_ks=(2, 4), max_task_size=6,
                     worker_speeds=tuple(np.linspace(1.0, 2.0, 12)),
                     arrivals=rs.MMPPArrivals(0.5, switch=0.1),
                     failures=rs.FailureModel(100.0, 5.0))
    port = to_port(sc, CPU)
    assert port.legal_ks() == sc.legal_ks() and port.delta == 5.0
    assert type(port.arrivals).__name__ == "MMPPArrivals"
    assert dataclasses.asdict(port.arrivals) == dataclasses.asdict(sc.arrivals)
    assert to_port(dataclasses.asdict(sc), CPU) == port
    assert type(to_port(rs.PoissonArrivals(2.0), CPU)).__name__ == \
        "PoissonArrivals"
    with pytest.raises(ValueError, match="Poisson or deterministic"):
        to_port({"rate": 2.0}, CPU)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4), dtype=np.float32)
    t = to_port(a, CPU)
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
    import jax.numpy as jnp
    b = to_port(jnp.asarray(a).astype(jnp.bfloat16), CPU)
    assert b.dtype == torch.bfloat16
    assert np.array_equal(b.float().numpy(),
                          np.asarray(jnp.asarray(a).astype(jnp.bfloat16),
                                     np.float32))
