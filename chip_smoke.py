"""Run the PyTorch/CUDA port's main path once on an NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, none of whose failures is caught (any fault exits non-zero):

1. Device: require CUDA, print the card's name and power limit, turn TF32
   off for matrix products and convolutions.
2. Build: compile every kernel of the path from its CUDA sources (nvcc).
3. Kernel against plain version on the card: ``coded_matmul`` over the
   test grid (n, k) x {fp32, bf16} at (M, K, N) = (256, 256, 128), and at
   the paper-matvec shapes (A 12288 x 8192 fp32, n = 12, every k | 12,
   N in {1, 128}), with the kernel's, the plain version's and one
   ``torch.einsum``'s times beside the least time the card could take.
4. Main path: for the three scenarios of examples/coded_matvec.py at
   n = 12, plan k*, estimate the k-curve by Monte-Carlo on the card, sample
   the workers' task times on the card, run the coded job at the
   paper-matvec size through the kernel at k* as a mat-vec (N = 1) and
   with a batch of N = 128 right-hand sides, decode from the fastest k*
   workers and hold the result to A @ X.  The kernel's launch count is
   zeroed before each job and read after it.
5. One JSON line listing every kernel of the path with its launches and
   times; the last line is the device record.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/coded_matmul/csrc/coded_matmul.cu"
REPLACES = "src/repro/kernels/coded_matmul/kernel.py:52"

# Published H100 SXM peaks at the 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12,        # fp32 outside tensor cores
                  torch.bfloat16: 989e12}      # bf16 tensor cores, dense
SMALL_GRID = [(4, 2), (6, 3), (8, 8), (5, 1)]  # tests/test_kernels.py:15
SMALL_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# At the paper-matvec shape both sides sum K = 8192 fp32 products, in
# another order (cuBLAS's blocking against the kernel's lane-strided sums
# and shuffle tree, or its 16-deep tiles), and the plain version encodes
# before the product while the kernel encodes after it.  Rounding grows
# like 2^-24 * sqrt(K) of the partial sums, ~1e-6 of max|C| for random
# data, with a worst case of K * 2^-24 = 4.9e-4; 1e-4 sits between.
MAIN_TOL = 1e-4
DECODE_TOL = 1e-3                              # examples/quickstart.py:86
MAIN_WIDTHS = (1, 128)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def device_phase() -> str:
    phase("1. device")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs an NVIDIA card: "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def build_phase() -> None:
    phase("2. build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    results = _build.build()
    for r in results.values():
        print(f"built {r.name} in {r.seconds:.2f} s -> "
              f"{r.path.relative_to(ROOT)}")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())
    print(f"build phase {time.perf_counter() - t0:.2f} s")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(G, A, X) -> tuple:
    """(bound_ms, bound_by): each input read once, the output written
    once, against 2*k*M*K*N + 2*n*k*M*N operations (the product with the
    k source blocks, then the encode) at the inputs' peak rate."""
    n, k = G.shape
    _, M, K = A.shape
    N = X.shape[1]
    es = A.element_size()
    nbytes = G.numel() * G.element_size() + (A.numel() + X.numel()
                                             + n * M * N) * es
    ops = 2.0 * k * M * K * N + 2.0 * n * k * M * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[A.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(G, A, X, tol: float, reps: int) -> dict:
    """The kernel against its plain version on the same inputs, then the
    times of the kernel, the plain version and one einsum, measured in
    turns (plain, kernel, einsum, einsum, kernel, plain)."""
    from repro_torch.kernels.coded_matmul import coded_matmul, coded_matmul_ref
    out = coded_matmul(G, A, X)
    ref = coded_matmul_ref(G, A, X)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype == A.dtype
    diff = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    max_abs = float(diff.max())
    ok = bool((diff <= tol * ref.float().abs() + tol * scale).all())
    assert torch.isfinite(out.float()).all()
    del out, ref
    fns = {"plain": lambda: coded_matmul_ref(G, A, X),
           "kernel": lambda: coded_matmul(G, A, X),
           "library": lambda: torch.einsum("ij,jmk,kn->imn", G, A, X)}
    times = {name: [] for name in fns}
    for name in ["plain", "kernel", "library", "library", "kernel", "plain"]:
        times[name].append(time_ms(fns[name], reps))
    b_ms, b_by = bound(G, A, X)
    row = dict(max_abs_err=max_abs, rel_err=max_abs / scale, ok=ok,
               ms=sum(times["kernel"]) / 2, plain_ms=sum(times["plain"]) / 2,
               library_ms=sum(times["library"]) / 2, bound_ms=b_ms,
               bound_by=b_by)
    n, k = G.shape
    _, M, K = A.shape
    print(f"  n={n:2d} k={k:2d} M={M:5d} K={K} N={X.shape[1]:3d} "
          f"{str(A.dtype)[6:]:8s} max_abs_err={max_abs:.3e} "
          f"rel={row['rel_err']:.2e} (tol {tol:g}) "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
          f"einsum {row['library_ms']:.4f} ms  bound {b_ms:.4f} ms "
          f"({b_by})  {'ok' if ok else 'MISMATCH'}", flush=True)
    return row


def kernel_phase(cfg, seed: int) -> dict:
    from repro_torch.core.coding import mds_generator
    phase("3. kernel against plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, k in SMALL_GRID:
            G = torch.from_numpy(mds_generator(n, k)).cuda().to(dtype)
            A = torch.randn((k, 256, 256), generator=gen, device="cuda"
                            ).to(dtype)
            X = torch.randn((256, 128), generator=gen, device="cuda"
                            ).to(dtype)
            if not compare(G, A, X, SMALL_TOL[dtype], reps=20)["ok"]:
                failures.append((n, k, dtype))
    print(f"paper-matvec shapes: A {cfg.rows} x {cfg.cols} fp32, "
          f"n = {cfg.n_workers}")
    A_full = torch.randn((cfg.rows, cfg.cols), generator=gen, device="cuda")
    rows = {}
    n = cfg.n_workers
    for N in MAIN_WIDTHS:
        X = torch.randn((cfg.cols, N), generator=gen, device="cuda")
        for k in [d for d in range(1, n + 1) if n % d == 0]:
            G = torch.from_numpy(mds_generator(n, k)).cuda()
            A = A_full.view(k, cfg.rows // k, cfg.cols)
            row = compare(G, A, X, MAIN_TOL, reps=10)
            rows[(k, N)] = row
            if not row["ok"]:
                failures.append((n, k, N))
    del A_full
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{failures}")
    return rows


def main_path_phase(cfg, seed: int) -> dict:
    """The port's main path; returns {(k, N): launches}."""
    from repro_torch.api import Planner, Scenario
    from repro_torch.core import (BiModal, Pareto, Scaling, ShiftedExp,
                                  completion_curve_mc, decode_blocks,
                                  job_completion_times, mds_generator,
                                  sample_task_times)
    from repro_torch.kernels.coded_matmul import coded_matmul
    phase("4. main path")
    n = cfg.n_workers
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((cfg.rows, cfg.cols), generator=gen, device="cuda")
    Xs = {N: torch.randn((cfg.cols, N), generator=gen, device="cuda")
          for N in MAIN_WIDTHS}
    fulls = {N: A @ X for N, X in Xs.items()}
    scenarios = [
        ("S-Exp(1,5) server-dep", ShiftedExp(1.0, 5.0),
         Scaling.SERVER_DEPENDENT),
        ("Pareto(1,2) server-dep", Pareto(1.0, 2.0), Scaling.SERVER_DEPENDENT),
        ("BiModal(10,.3) additive", BiModal(10.0, 0.3), Scaling.ADDITIVE),
    ]
    launches = {}
    for i, (label, dist, scaling) in enumerate(scenarios):
        t0 = time.perf_counter()
        plan = Planner().plan(Scenario(dist, scaling, n))
        k = plan.k
        t1 = time.perf_counter()
        mc = completion_curve_mc(dist, scaling, n, trials=100_000,
                                 seed=seed + i)
        t2 = time.perf_counter()
        again = completion_curve_mc(dist, scaling, n, trials=100_000,
                                    seed=seed + i)
        t3 = time.perf_counter()
        assert again == mc, "same seed, same card: the same curve"
        print(f"{label}: k* = {k} ({plan.strategy}); host clock: plan "
              f"{t1 - t0:.4f} s, MC curve {t2 - t1:.4f} s "
              f"(again, warm: {t3 - t2:.4f} s)")
        for kk in sorted(plan.curve):
            rel = abs(mc[kk] - plan.curve[kk]) / plan.curve[kk]
            print(f"  k={kk:2d}  analytic E[T] {plan.curve[kk]:9.4f}  "
                  f"MC (100k trials, card) {mc[kk]:9.4f}  rel diff {rel:.2e}")
            assert rel < 0.05, (label, kk, mc[kk], plan.curve[kk])
        task_gen = torch.Generator(device="cuda").manual_seed(
            seed * 1000 + i)
        times = sample_task_times(dist, task_gen, 1, n, n // k, scaling)
        assert times.device.type == "cuda" and times.shape == (1, n)
        done = float(job_completion_times(times, k)[0])
        survivors = sorted(torch.argsort(times[0])[:k].tolist())
        print(f"  task times {[round(v, 2) for v in times[0].tolist()]}; "
              f"fastest {k}: {survivors}, job done at t={done:.2f}")
        G = torch.from_numpy(mds_generator(n, k)).cuda()
        blocks = A.view(k, cfg.rows // k, cfg.cols)
        for N, X in Xs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coded_matmul.launches = 0
            coded = coded_matmul(G, blocks, X)
            launched = coded_matmul.launches
            launches[(k, N)] = launches.get((k, N), 0) + launched
            assert launched == 1, launched
            rec = decode_blocks(G, survivors, coded[survivors])
            full = fulls[N].view(k, cfg.rows // k, N)
            torch.cuda.synchronize()
            job_s = time.perf_counter() - t0
            assert rec.shape == full.shape and torch.isfinite(rec).all()
            err = float((rec - full).abs().max() / full.abs().max())
            print(f"  N={N:3d}: coded {tuple(coded.shape)}, decoded from "
                  f"{survivors}: rel err vs A @ X {err:.2e} "
                  f"(bound {DECODE_TOL:g}), kernel launches {launched}, "
                  f"encode+multiply+decode {job_s * 1e3:.3f} ms host clock")
            assert err < DECODE_TOL, (label, N, err)
    torch.cuda.synchronize()
    assert sum(launches.values()) > 0
    return launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    smi = device_phase()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import CONFIG
    build_phase()
    timed = kernel_phase(CONFIG, args.seed)
    launches = main_path_phase(CONFIG, args.seed)

    phase("5. kernels")
    kernels = []
    for (k, N), count in sorted(launches.items()):
        row = timed[(k, N)]
        kernels.append({
            "name": f"coded_matmul[n={CONFIG.n_workers},k={k},N={N}]",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": count, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
