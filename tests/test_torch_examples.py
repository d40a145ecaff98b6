"""The example twins of the port (``examples/torch_*.py``) on the CPU at a
smoke size, against the JAX package's examples and API.

Where the reference computes analytically in numpy (the planner), the
twin's plan lines equal the reference's.  Where it samples, the twin is
held statistically at ``tests/test_conformance.py``'s tolerances: a
Monte-Carlo mean within 5 % of the closed form (12 % for Pareto,
``TestLoadZeroClosedFormLimit``), and a queueing surface within 12 % of
the reference's at the same size, cell for cell where the queue is
stable (utilization < 0.7; ``TestSweepSurfaceParity``'s band).
"""
import runpy
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
MC_RTOL, PARETO_RTOL, SURFACE_RTOL, STABLE = 0.05, 0.12, 0.12, 0.7


def _twin(name: str):
    return runpy.run_path(str(EXAMPLES / f"torch_{name}.py"),
                          run_name="twin")["main"]


def test_quickstart_twin_plans_as_the_reference(capsys):
    pytest.importorskip("jax")
    err = _twin("quickstart")(["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    runpy.run_path(str(EXAMPLES / "quickstart.py"), run_name="ref")
    theirs = capsys.readouterr().out.splitlines()
    # section 1: the four plans and the tail line, character for character
    assert ours[:8] == theirs[:8]
    (mc_line,) = [line for line in ours if "closed-form" in line]
    cf, mc = float(mc_line.split()[2]), float(mc_line.split()[4])
    assert mc == pytest.approx(cf, rel=MC_RTOL)
    assert err < 1e-3


def test_coded_matvec_twin_plans_as_the_reference_and_decodes(capsys):
    """The planner's k* line is the reference's ``plan``; the measured
    E[T] by k (20,000 trials) within MC_RTOL of the reference's closed
    form (PARETO_RTOL for Pareto); the coded job decodes (the twin's own
    assert, then "OK")."""
    pytest.importorskip("jax")
    from repro.api import Planner, Scenario
    from repro.core import completion_curve
    twin = runpy.run_path(str(EXAMPLES / "torch_coded_matvec.py"),
                          run_name="twin")
    curves = twin["main"](["--device", "cpu", "--trials", "20000"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    for name, (dist, scaling) in twin["MODELS"].items():
        ref = _ref_model(dist, scaling)
        k = Planner().plan(Scenario(*ref, twin["N"])).k
        assert f"planner says k* = {k} " in out.split(f"{name}:")[1], name
        exact = completion_curve(*ref, twin["N"], ks=list(twin["KS"]))
        rtol = PARETO_RTOL if type(dist).__name__ == "Pareto" else MC_RTOL
        for kk, v in curves[name].items():
            assert v == pytest.approx(exact[kk], rel=rtol), (name, kk)


def _ref_model(dist, scaling):
    """The reference's (distribution, scaling) for a port pair."""
    from repro.core import distributions as rd
    return getattr(rd, type(dist).__name__)(**vars(dist)), \
        getattr(rd.Scaling, scaling.name)


def test_load_sweep_twin_matches_reference_surfaces(capsys):
    pytest.importorskip("jax")
    from repro.api import LoadAwareLatency, Scenario
    from repro.core import BiModal, Scaling
    kw = dict(num_jobs=600, reps=4, seed=0)
    surfaces = _twin("load_sweep")(["--device", "cpu", "--num-jobs", "600",
                                    "--reps", "4"])
    out = capsys.readouterr().out
    twin = runpy.run_path(str(EXAMPLES / "torch_load_sweep.py"),
                          run_name="twin")
    ref = LoadAwareLatency(**kw).surface(
        Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, twin["N"]),
        twin["LOADS"])
    ours = surfaces["poisson"]
    assert ours.ks == ref.ks and list(ours.loads) == list(ref.loads)
    stable = np.asarray(ref.utilization) < STABLE
    assert stable.sum() >= 12
    np.testing.assert_allclose(np.asarray(ours.mean)[stable],
                               np.asarray(ref.mean)[stable],
                               rtol=SURFACE_RTOL)
    assert ours.kstar() == ref.kstar()
    assert f"k* map: {ref.kstar()}" in out
    assert "(load -> 0 recovers the paper's single-job k* = 6)" in out


def test_assignment_twin_matches_reference_placements(capsys):
    pytest.importorskip("jax")
    from repro import api as rapi
    from repro.core import Scaling, ShiftedExp
    out = _twin("assignment")(["--device", "cpu", "--num-jobs", "600",
                               "--reps", "2"])
    capsys.readouterr()
    dist = ShiftedExp(1.0, 1.25)
    speeds = (3.0,) * 4 + (1.0,) * 8
    lam_max = 1.0 / (dist.mean() * 12)
    kw = dict(num_jobs=600, reps=2, preempt=False, seed=0)
    sc_k4 = rapi.Scenario(dist, Scaling.SERVER_DEPENDENT, 12,
                          worker_speeds=speeds, candidate_ks=(4,))
    for label, a in [("all-workers fan-out", rapi.AllWorkers()),
                     ("round-robin groups", rapi.RoundRobin(g=4)),
                     ("random groups", rapi.RandomGroups(g=4)),
                     ("speed-aware packing", rapi.SpeedAware(g=4)),
                     ("contiguous blocks", rapi.ReplicationGroups(g=4))]:
        ref = rapi.LoadAwareLatency(assignment=a, **kw).surface(
            sc_k4, [0.1 * lam_max]).mean[0, 0]
        assert out["order"][label] == pytest.approx(float(ref),
                                                    rel=SURFACE_RTOL), label
    sc = rapi.Scenario(dist, Scaling.SERVER_DEPENDENT, 12,
                       worker_speeds=speeds)
    ref_plan = rapi.Planner(rapi.LoadAwareLatency(**kw)).co_plan(
        sc, [rapi.AllWorkers(), rapi.RoundRobin(), rapi.RandomGroups(),
             rapi.SpeedAware()],
        objective=rapi.LoadAwareLatency(arrival_rate=0.5 * lam_max, **kw))
    plan = out["plan"]
    assert sorted(plan.curve) == sorted(ref_plan.curve)
    for k, v in ref_plan.curve.items():
        assert plan.curve[k] == pytest.approx(v, rel=SURFACE_RTOL), k
    # the twin's k* costs, on the reference's curve, within the band of
    # the reference's own minimum
    assert ref_plan.curve[plan.k] <= (1 + SURFACE_RTOL) * min(
        ref_plan.curve.values())
