"""The port's samplers and Monte-Carlo simulator.

PyTorch's generators cannot reproduce the reference's threefry streams, so
the simulator is held exactly where both packages are fed the same numpy
matrices, and statistically against the closed forms on its own draws.
The JAX package is imported inside the tests that compare with it, so the
card's tests (marked ``gpu``) also run on a machine without JAX.
Every statistical bound below is five standard errors of the quantity
compared, with the standard error estimated from the same draws (or
from the model, where the draws are too few to show a rare atom).
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.api import MeanCompletionTime, Planner, Scenario
from repro_torch.core import expectations, simulator
from repro_torch.core.batched import bimodal_straggle_curve
from repro_torch.core.distributions import BiModal, Pareto, Scaling, ShiftedExp
from repro_torch.core.scenario import task_survival
from repro_torch.runtime.straggler import StragglerSim

CPU = "cpu"
KS12 = [1, 2, 3, 4, 6, 12]
TRIALS = 40_000
Z = 5.0

CELLS = [
    ("sexp_server", ShiftedExp(1.0, 5.0), Scaling.SERVER_DEPENDENT, None),
    ("sexp_data", ShiftedExp(5.0, 5.0), Scaling.DATA_DEPENDENT, None),
    ("sexp_additive", ShiftedExp(1.0, 10.0), Scaling.ADDITIVE, None),
    ("pareto_server", Pareto(1.0, 3.0), Scaling.SERVER_DEPENDENT, None),
    ("pareto_data", Pareto(1.0, 3.0), Scaling.DATA_DEPENDENT, 5.0),
    ("pareto_additive", Pareto(1.0, 3.0), Scaling.ADDITIVE, None),
    ("bimodal_server", BiModal(10.0, 0.3), Scaling.SERVER_DEPENDENT, None),
    ("bimodal_data", BiModal(10.0, 0.3), Scaling.DATA_DEPENDENT, 5.0),
    ("bimodal_additive", BiModal(10.0, 0.3), Scaling.ADDITIVE, None),
]
IDS = [c[0] for c in CELLS]


@pytest.mark.parametrize("k", KS12)
@pytest.mark.parametrize("ties", [False, True])
def test_job_completion_times_exact_on_injected_matrix(k, ties):
    jnp = pytest.importorskip("jax.numpy")
    ref_sim = pytest.importorskip("repro.core.simulator")
    rng = np.random.default_rng(100 + k)
    T = rng.exponential(3.0, (257, 12)).astype(np.float32)
    if ties:                                     # Bi-Modal-like atoms
        T = np.where(T > 3.0, 10.0, 1.0).astype(np.float32)
    port = simulator.job_completion_times(torch.from_numpy(T), k).numpy()
    ref = np.asarray(ref_sim.job_completion_times(jnp.asarray(T), k))
    assert port.dtype == ref.dtype and np.array_equal(port, ref)


def _job_means(dist, scaling, delta, seed):
    """Per-k mean and standard error of Y_{k:12} from sample_task_times."""
    gen = torch.Generator(device=CPU).manual_seed(seed)
    out = {}
    for k in KS12:
        t = simulator.sample_task_times(dist, gen, TRIALS, 12, 12 // k,
                                        scaling, delta=delta)
        assert t.shape == (TRIALS, 12) and t.dtype == torch.float32
        y = simulator.job_completion_times(t, k).double()
        out[k] = (float(y.mean()), float(y.std()) / TRIALS ** 0.5)
    return out


@pytest.mark.parametrize("name,dist,scaling,delta", CELLS, ids=IDS)
def test_sampling_and_mc_curve_match_closed_form(name, dist, scaling, delta):
    """sample_task_times, job_completion_times and completion_curve_mc
    against E[Y_{k:n}] from the analytic engine.  Pareto-additive has no
    closed form: its reference is the analytic engine's own 100k-trial
    numpy Monte-Carlo, whose standard error is counted too."""
    exact = expectations.completion_curve(dist, scaling, 12, delta=delta)
    means = _job_means(dist, scaling, delta, seed=1)
    curve = simulator.completion_curve_mc(dist, scaling, 12, trials=TRIALS,
                                          seed=2, delta=delta, device=CPU)
    for k in KS12:
        mean, se = means[k]
        if name == "pareto_additive":            # both sides are MC
            se *= (1.0 + TRIALS / 100_000) ** 0.5
        if name in ("bimodal_server", "bimodal_data"):
            # Y_{k:n} takes two values; at small k the straggle probability
            # (1.5e-5 at k = 2) is too rare for the sample to estimate its
            # spread, so take the model's
            p = float(bimodal_straggle_curve([k], 12, dist.eps)[0])
            span = (dist.B - 1.0) * (12 // k if name == "bimodal_server" else 1)
            se = max(se, span * (p * (1.0 - p) / TRIALS) ** 0.5)
        bound = Z * se + 1e-6 * (1.0 + abs(exact[k]))   # + float32 rounding
        assert abs(mean - exact[k]) <= bound, (k, mean, exact[k], se)
        assert abs(curve[k] - exact[k]) <= bound, (k, curve[k], exact[k], se)


def test_expected_completion_mc_and_grid():
    d = BiModal(10.0, 0.3)
    exact = expectations.completion_curve(d, Scaling.SERVER_DEPENDENT, 12)
    mc = simulator.expected_completion_mc(d, Scaling.SERVER_DEPENDENT, 4, 12,
                                          trials=TRIALS, device=CPU)
    # Y_{4:12} / s is Bernoulli on {1, 10}: sd <= 4.5 * s = 13.5
    assert abs(mc - exact[4]) <= Z * 13.5 / TRIALS ** 0.5
    dists = [BiModal(10.0, e) for e in (0.1, 0.5, 0.9)]
    grid = simulator.completion_curves_grid_mc(
        dists, Scaling.SERVER_DEPENDENT, 12, trials=TRIALS, device=CPU)
    assert grid.shape == (3, len(KS12))
    for row, dd in zip(grid, dists):
        ex = expectations.completion_curve(dd, Scaling.SERVER_DEPENDENT, 12)
        for j, k in enumerate(KS12):
            sd = 4.5 * (12 // k)                # half the {s, 10 s} span
            assert abs(row[j] - ex[k]) <= Z * sd / TRIALS ** 0.5
    swept = Planner(MeanCompletionTime(mc=True, trials=TRIALS, device=CPU)
                    ).sweep([Scenario(dd, Scaling.SERVER_DEPENDENT, 12)
                             for dd in dists])
    assert [p.curve for p in swept] == [dict(zip(KS12, map(float, r)))
                                        for r in grid]


def test_curve_counter_and_crn_reproducibility():
    d = ShiftedExp(1.0, 5.0)
    before = simulator.curve_compile_count()
    a = simulator.completion_curve_mc(d, Scaling.ADDITIVE, 12, trials=2000,
                                      seed=9, device=CPU)
    b = simulator.completion_curve_mc(d, Scaling.ADDITIVE, 12, trials=2000,
                                      seed=9, device=CPU)
    assert a == b                               # same seed, same device
    assert simulator.curve_compile_count() == before + 2
    with pytest.raises(ValueError):
        simulator.completion_curve_mc(d, Scaling.ADDITIVE, 12, ks=[5],
                                      device=CPU)


@pytest.mark.parametrize("dist", [ShiftedExp(2.0, 0.0), ShiftedExp(1.0, 3.0),
                                  Pareto(2.0, 1.5), BiModal(7.0, 0.25)],
                         ids=["sexp_w0", "sexp", "pareto", "bimodal"])
def test_cu_samplers(dist):
    gen = torch.Generator(device=CPU).manual_seed(4)
    x = dist.sample(gen, (200_000,))
    assert x.dtype == torch.float32 and x.shape == (200_000,)
    if isinstance(dist, BiModal):
        assert set(torch.unique(x).tolist()) == {1.0, 7.0}
        frac = float((x == 7.0).double().mean())
        assert abs(frac - 0.25) <= Z * (0.25 * 0.75 / 200_000) ** 0.5
        return
    lo = dist.delta if isinstance(dist, ShiftedExp) else dist.lam
    assert float(x.min()) >= lo
    if isinstance(dist, Pareto):                # clamp at U >= 2^-24
        assert float(x.max()) <= dist.lam * 2.0 ** (24 / dist.alpha) * 1.0001
        return
    se = float(x.double().std()) / 200_000 ** 0.5
    assert abs(float(x.double().mean()) - dist.mean()) <= Z * se + 1e-6
    # survival at a few points against the closed form
    xs = np.array([1.5, 3.0, 6.0])
    emp = simulator.empirical_survival(x.numpy(), xs)
    assert np.allclose(emp, dist.tail(xs), atol=Z * 0.5 / 200_000 ** 0.5)


def test_straggler_mask_and_sim():
    gen = torch.Generator(device=CPU).manual_seed(0)
    masks = torch.stack([simulator.straggler_mask(gen, 12, 0.2)
                         for _ in range(4000)])
    assert masks.dtype == torch.bool
    frac = float(masks.double().mean())
    assert abs(frac - 0.8) <= Z * (0.16 / masks.numel()) ** 0.5
    sim = StragglerSim(BiModal(10.0, 0.3), Scaling.ADDITIVE, 12, 3,
                       seed=5, device=CPU)
    assert np.array_equal(sim.sample_times(7), sim.sample_times(7))
    assert not np.array_equal(sim.sample_times(7), sim.sample_times(8))
    assert set(np.unique(sim.sample_times(1))) <= {3.0, 12.0, 21.0, 30.0}
    assert sim.alive_fn(5.0)(1).dtype == bool


def test_empirical_survival_matches_reference():
    ref_sim = pytest.importorskip("repro.core.simulator")
    x = np.random.default_rng(2).exponential(2.0, 1000)
    xs = np.linspace(0.0, 8.0, 17)
    assert np.array_equal(simulator.empirical_survival(x, xs),
                          ref_sim.empirical_survival(x, xs))


def test_pareto_additive_survival_reference_statistical():
    """task_survival's 200k-draw Pareto-additive tail against the
    reference's at the same points.  Bound: five standard errors of the
    difference of two independent empirical survivals."""
    ref_dists = pytest.importorskip("repro.core.distributions")
    from repro.core.scenario import task_survival as ref_task_survival
    jax_d = ref_dists.Pareto(1.0, 3.0)
    t = np.array([2.0, 3.0, 4.0, 6.0, 10.0])
    for s in (1, 3, 6):
        port = task_survival(Pareto(1.0, 3.0), Scaling.ADDITIVE, s, t,
                             device=CPU)
        ref = ref_task_survival(jax_d, ref_dists.Scaling.ADDITIVE, s, t)
        se = np.sqrt(2.0 * np.maximum(ref * (1.0 - ref), 1e-6) / 200_000)
        assert np.all(np.abs(port - ref) <= Z * se), (s, port, ref)


# --------------------------------------------------------------------------
# Without a card, the default device raises: nothing falls back to the CPU
# --------------------------------------------------------------------------

NO_CPU_CALLS = {
    "completion_curve_mc": lambda: simulator.completion_curve_mc(
        ShiftedExp(1.0, 5.0), Scaling.SERVER_DEPENDENT, 12, trials=10),
    "expected_completion_mc": lambda: simulator.expected_completion_mc(
        ShiftedExp(1.0, 5.0), Scaling.SERVER_DEPENDENT, 2, 12, trials=10),
    "grid_mc": lambda: simulator.completion_curves_grid_mc(
        [BiModal(10.0, 0.3)], Scaling.SERVER_DEPENDENT, 12, trials=10),
    "planner_mean": lambda: Planner().plan(
        Scenario(ShiftedExp(1.0, 5.0), Scaling.SERVER_DEPENDENT, 12)),
    "pareto_additive_survival": lambda: task_survival(
        Pareto(1.0, 2.5), Scaling.ADDITIVE, 2, np.array([3.0])),
    "straggler_sim": lambda: StragglerSim(
        BiModal(10.0, 0.3), Scaling.ADDITIVE, 12, 2).sample_times(0),
    "to_port_array": lambda: convert.to_port(np.zeros(3, np.float32)),
}


@pytest.mark.parametrize("name", sorted(NO_CPU_CALLS))
def test_default_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NO_CPU_CALLS[name]()


# --------------------------------------------------------------------------
# On the card: the same samplers with a CUDA generator
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name,dist,scaling,delta", CELLS, ids=IDS)
def test_mc_curve_on_card_matches_closed_form(cuda, name, dist, scaling,
                                              delta):
    """completion_curve_mc on the card, 100k trials, against the closed
    form at five standard errors (taken from CPU draws of the same law)."""
    exact = expectations.completion_curve(dist, scaling, 12, delta=delta)
    means = _job_means(dist, scaling, delta, seed=3)
    curve = simulator.completion_curve_mc(dist, scaling, 12, seed=4,
                                          delta=delta, device=cuda)
    for k in KS12:
        se = means[k][1] * (TRIALS / 100_000) ** 0.5
        if name == "pareto_additive":
            se *= 2.0 ** 0.5
        if name in ("bimodal_server", "bimodal_data"):
            p = float(bimodal_straggle_curve([k], 12, dist.eps)[0])
            span = (dist.B - 1.0) * (12 // k if name == "bimodal_server" else 1)
            se = max(se, span * (p * (1.0 - p) / 100_000) ** 0.5)
        bound = Z * se + 1e-6 * (1.0 + abs(exact[k]))
        assert abs(curve[k] - exact[k]) <= bound, (k, curve[k], exact[k])


@pytest.mark.gpu
def test_samplers_and_planner_draws_land_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for dist in (ShiftedExp(1.0, 3.0), Pareto(1.0, 3.0), BiModal(10.0, 0.3)):
        t = simulator.sample_task_times(dist, gen, 8, 12, 3,
                                        Scaling.ADDITIVE)
        assert t.device.type == "cuda" and t.dtype == torch.float32
    assert simulator.straggler_mask(gen, 12, 0.2).device.type == "cuda"
    sim = StragglerSim(BiModal(10.0, 0.3), Scaling.ADDITIVE, 12, 3)
    assert np.array_equal(sim.sample_times(2), sim.sample_times(2))
    surv = task_survival(Pareto(1.0, 3.0), Scaling.ADDITIVE, 3,
                         np.array([3.0, 5.0]))
    cpu = task_survival(Pareto(1.0, 3.0), Scaling.ADDITIVE, 3,
                        np.array([3.0, 5.0]), device="cpu")
    assert np.all(np.abs(surv - cpu) <= Z * np.sqrt(
        2.0 * cpu * (1.0 - cpu) / 200_000))
    plan = Planner().plan(Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, 12))
    assert plan.k == Planner(MeanCompletionTime(device="cpu")).plan(
        Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, 12)).k
