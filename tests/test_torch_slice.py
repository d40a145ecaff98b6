"""The port's main path end to end on the CPU, against the JAX package's.

At quickstart size (A 1200 x 256, n = 12) and for the three scenarios of
examples/coded_matvec.py: the same plan, the same injected task times
give the same fastest-k survivors, and the decoded blocks agree within
1e-4 of the reference's, relative to their max.  Both decode through the
float32 inverse of a k x k Chebyshev-Vandermonde submatrix, whose
rounding the quickstart measures at ~1.1e-4 against the exact product, so
the two packages' decodes are compared with each other at 1e-4 and with
A @ x at the quickstart's own 1e-3.
"""
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core.coding as ref_coding
import repro.core.distributions as ref_dists
import repro.core.simulator as ref_sim
from repro.kernels.coded_matmul import coded_matmul as ref_coded_matmul

from repro_torch.api import MeanCompletionTime, Planner
from repro_torch.convert import to_port
from repro_torch.core.coding import decode_blocks, mds_generator
from repro_torch.core.simulator import job_completion_times
from repro_torch.kernels.coded_matmul import coded_matmul

N_WORKERS, M, D = 12, 1200, 256
SCENARIOS = {
    "sexp_server": (ref_dists.ShiftedExp(1.0, 5.0), "server"),
    "pareto_server": (ref_dists.Pareto(1.0, 2.0), "server"),
    "bimodal_additive": (ref_dists.BiModal(10.0, 0.3), "additive"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("width", [1, 7])
def test_coded_job_matches_reference(name, width):
    jnp = pytest.importorskip("jax.numpy")
    dist, scaling = SCENARIOS[name]
    ref_sc = ref_api.Scenario(dist, ref_dists.Scaling(scaling), N_WORKERS)

    # 1. the plan
    ref_plan = ref_api.Planner().plan(ref_sc)
    plan = Planner(MeanCompletionTime(device="cpu")).plan(
        to_port(ref_sc, "cpu"))
    assert plan == to_port(ref_plan, "cpu")
    k = plan.k

    # 2. the job's data and its task times, drawn once with numpy
    rng = np.random.default_rng(sum(map(ord, name)) + width)
    A = rng.standard_normal((M, D), dtype=np.float32)
    X = rng.standard_normal((D, width), dtype=np.float32)
    times = rng.exponential(2.0, (1, N_WORKERS)).astype(np.float32)
    G = mds_generator(N_WORKERS, k)

    # 3. encode and multiply: n coded tasks
    blocks = A.reshape(k, M // k, D)
    ref_coded = np.asarray(ref_coded_matmul(
        jnp.asarray(G), jnp.asarray(blocks), jnp.asarray(X),
        use_kernel=False))
    coded = coded_matmul(*(torch.from_numpy(a) for a in (G, blocks, X)))
    np.testing.assert_allclose(coded.numpy(), ref_coded, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref_coded).max()))

    # 4. who finishes first: the k-th order statistic and the survivors
    t_port = torch.from_numpy(times)
    assert float(job_completion_times(t_port, k)[0]) == float(
        ref_sim.job_completion_times(jnp.asarray(times), k)[0])
    survivors = sorted(torch.argsort(t_port[0])[:k].tolist())
    ref_survivors = sorted(np.argsort(times[0])[:k].tolist())
    assert survivors == ref_survivors

    # 5. decode from the k finishers
    rec = decode_blocks(G, survivors, coded[survivors])
    ref_rec = np.asarray(ref_coding.decode_blocks(
        G, ref_survivors, jnp.asarray(ref_coded[ref_survivors])))
    scale = float(np.abs(ref_rec).max())
    assert float(np.abs(rec.numpy() - ref_rec).max()) <= 1e-4 * scale
    full = (A @ X).reshape(k, M // k, width)
    assert float(np.abs(rec.numpy() - full).max()) <= \
        1e-3 * float(np.abs(full).max())
