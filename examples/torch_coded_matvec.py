"""The paper's exemplar system end to end on the PyTorch port (Fig. 1 +
Fig. 2): a master dispatches MDS-coded mat-vec tasks to n workers, sweeps
the full diversity/parallelism knob k, and measures completion time under
three service-time models, then runs the coded job once through the
coded-matmul kernel.

    PYTHONPATH=src python examples/torch_coded_matvec.py               # card
    PYTHONPATH=src python examples/torch_coded_matvec.py --device cpu

The twin of ``examples/coded_matvec.py``: the draws come from seeded
``torch.Generator``s on ``--device``; the product is
``kernels.coded_matmul`` (the CUDA kernel on the card, its plain version
on the CPU, where the reference runs its Pallas kernel in interpret
mode); the planner's k* is host numpy, the reference's.
"""
import argparse

import torch

from repro_torch._device import generator
from repro_torch.api import MeanCompletionTime, Planner, Scenario
from repro_torch.core import (BiModal, Pareto, Scaling, ShiftedExp,
                              decode_blocks, mds_generator)
from repro_torch.core.simulator import (job_completion_times,
                                        sample_task_times)
from repro_torch.kernels.coded_matmul import coded_matmul

N = 12
M, D, V = 1536, 512, 128       # job: A (M x D) @ X (D x V)
KS = (1, 2, 3, 4, 6, 12)
MODELS = {
    "S-Exp(1,5) server-dep": (ShiftedExp(1.0, 5.0), Scaling.SERVER_DEPENDENT),
    "Pareto(1,2) server-dep": (Pareto(1.0, 2.0), Scaling.SERVER_DEPENDENT),
    "BiModal(10,.3) additive": (BiModal(10.0, 0.3), Scaling.ADDITIVE),
}


def run_system(dist, scaling, k: int, gen, trials: int) -> float:
    """Mean job completion time over ``trials`` coded executions: the
    any-k barrier completes at the k-th order statistic."""
    times = sample_task_times(dist, gen, trials, N, N // k, scaling)
    return float(job_completion_times(times, k).mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the draws and the job run (default cuda; "
                         "cpu for the host)")
    ap.add_argument("--trials", type=int, default=200,
                    help="coded executions a (model, k) point")
    args = ap.parse_args(argv)
    dev = args.device
    A = torch.randn((M, D), generator=generator(0, dev), device=dev)
    X = torch.randn((D, V), generator=generator(1, dev), device=dev)
    planner = Planner(MeanCompletionTime(device=dev))

    print("job: A(%d x %d) @ X(%d x %d) on n=%d workers" % (M, D, D, V, N))
    curves = {}
    for i, (name, (dist, scaling)) in enumerate(MODELS.items()):
        curve = {k: run_system(dist, scaling, k,
                               generator(100 * i + k, dev), args.trials)
                 for k in KS}
        kbest = min(curve, key=curve.get)
        p = planner.plan(Scenario(dist, scaling, N))
        curves[name] = curve
        print(f"\n{name}:")
        print("  measured E[T] by k: " +
              " ".join(f"k={k}:{v:.2f}" for k, v in curve.items()))
        print(f"  measured best k = {kbest}; planner says k* = {p.k} "
              f"({p.strategy})")

    # execute the coded job once, through the coded-matmul kernel
    k = 6
    G = torch.from_numpy(mds_generator(N, k)).to(dev)
    blocks = A.reshape(k, M // k, D)
    coded = coded_matmul(G, blocks, X)                     # (n, M/k, V)
    ref = torch.einsum("ij,jmd->imd", G,
                       torch.einsum("kmd,dv->kmv", blocks, X))
    print(f"\ncoded-matmul kernel vs encode-then-multiply: max rel err "
          f"{float((coded - ref).abs().max() / ref.abs().max()):.2e}")
    survivors = [0, 2, 3, 7, 9, 11]
    rec = decode_blocks(G.cpu().numpy(), survivors, coded[survivors])
    full = torch.einsum("kmd,dv->kmv", blocks, X)
    err = float((rec - full).abs().max() / full.abs().max())
    print(f"decoded from workers {survivors}: rel err {err:.2e}")
    assert err < 1e-4
    print("OK")
    return curves


if __name__ == "__main__":
    main()
