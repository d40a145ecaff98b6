"""Run the PyTorch/CUDA port's main paths once on an NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, none of whose failures is caught (any fault exits non-zero):

1. Device: require CUDA, print the card's name and power limit, turn TF32
   off for matrix products and convolutions.
2. Build: compile every kernel from its CUDA sources (one nvcc per
   kernel, all at once): coded_matmul, flash_attention, ssd_scan.
3. Kernel against plain version on the card, each with the kernel's, the
   plain version's and (where one exists) one PyTorch call's times beside
   the least time the card could take, the achieved rate (TFLOP/s or
   GB/s, by what bounds it) and the bound's share of the kernel's time:
   - ``coded_matmul`` over the test grid (n, k) x {fp32, bf16} at
     (M, K, N) = (256, 256, 128), and at the paper-matvec shapes
     (A 12288 x 8192 fp32, n = 12, every k | 12, N in {1, 128});
   - ``flash_attention`` on the reference grid (B,Sq,Sk,H,KV,D) =
     (2,256,256,4,2,32) causal and not in fp32, (1,128,128,2,2,64) in
     bf16, a ragged S = 200, the bf16 schedule at D 16, 32 and 64 with
     ragged lengths and causal rows offset by Sk - Sq, and the qwen3-0.6b
     shapes of phase 5 (H 16, KV 8, D 128; B 2 x 64 tokens in fp32, B 2 x
     S 4096 in bf16), against ``F.scaled_dot_product_attention``; at the
     B 2 x S 4096 shape two planted faults must fail the tolerance;
   - ``ssd_scan`` on the reference grid (2,64,3,16,8) and (1,128,2,32,16)
     x chunk {4, 16, 64} and the mamba2-1.3b shape of phase 5's fp32 check
     (H 64, P 64, N 128; B 2 x 64 tokens) in fp32 (the SIMT schedule); the
     same grid with chunks 8 and 128 and a state width N = 40 in bf16 (the
     tensor-core schedule); and phase 5's timed shape (B 2 x S 4096, chunk
     256, bf16), where two planted faults must fail the tolerance and the
     profiler splits the call's time over its four CUDA kernels.
4. Coded mat-vec path: for the three scenarios of examples/coded_matvec.py
   at n = 12, plan k*, estimate the k-curve by Monte-Carlo on the card,
   sample the workers' task times on the card, run the coded job at the
   paper-matvec size through the kernel at k* as a mat-vec (N = 1) and
   with a batch of N = 128 right-hand sides, decode from the fastest k*
   workers and hold the result to A @ X.  The kernel's launch count is
   zeroed before each job and read after it.
5. Serving path at full width, for qwen3-0.6b and then mamba2-1.3b:
   parameters made on the card from a seeded generator; prefill logits
   (``api.forward``, fp32 compute, B 2, 64 tokens) against token-by-token
   ``api.decode_step``; a timed bf16 prefill at B 2 x S 4096 (first and
   warm call, CUDA events); the hedged serving loop at the reference's
   defaults (batch 4, prompt 32, gen 32, straggle pareto:0.05:1.8); one
   decode step of the loop's shape timed by CUDA events.  One more prefill
   and one more decode step run under ``torch.profiler`` for the device
   operations, device time by kernel group and the device's idle share.  The kernel's launch count is zeroed
   before each forward and read after it: one launch per layer.
6. Load-aware queueing path (no kernel of this repo lies on it: the lane
   engine is PyTorch operations in one loop over jobs), all on the card:
   - the ``benchmarks/cluster_sweep.py`` gate shape: S-Exp(1, 5)
     server-dependent, n = 120, all 16 legal k, loads lambda_max x {0.2,
     ..., 0.95}, 600 jobs, warmup 60, one replication; cells/s, ms per job
     step, device operations per job step, device-busy ms and idle share
     (``torch.profiler``), and the oracle's cells/s on three cells spread
     over k and load beside it;
   - the card against the host on one mid cell's injected numpy draws
     (k 12, load 0.5 lambda_max), plain, under crash-restart failures and
     grouped (g 2): equal latencies, utilization and wasted fraction within
     1e-5 relative, and the float64 oracle on the same arrays within the
     reference's tolerances;
   - ``examples/load_sweep.py``'s three k* x load surfaces at its size
     (Poisson, MMPP under p99, a fleet with two 3x-slow workers) beside the
     single-job k*;
   - ``Planner.co_plan`` at ``examples/assignment.py``'s candidates.
7. Fleet-scale queueing (the chunked engine; no kernel of this repo lies
   on it either), all on the card:
   - ``benchmarks/fleet_sweep.py``'s feasibility surface at full width:
     S-Exp(1, 5) server-dependent, n = 10^4, 10^5 jobs, k in {1, 10, 100,
     1000, 10^4}, loads lambda_max x {0.3, 0.8}, chunk 511, streaming
     statistics with a 4096-sample reservoir: wall seconds, jobs/s, ms per
     job step, peak device memory (under the JAX package's 4096 MB budget)
     and k* per load, the JAX package's own CPU point beside them; device
     operations per job step and the idle share from a profiled call of
     two chunks at the same width;
   - streaming p99 against exact (n = 120, 6000 jobs, seeds 1-8): every
     lane's error, averaged over the seeds, within 2 %;
   - chunked against monolithic throughput at n = 120 x 600 jobs;
   - card = host: a dyadic cell bit for bit at chunk sizes 1, 7 and 64, a
     continuous and a failure cell within float32 rounding;
   - the radix bisection against the sort on (10, 10^4) finishes: times
     and bitwise equality;
   - ``examples/fleet_scale.py``'s day/night MMPP k* map at n = 10^4.
8. One JSON line listing every kernel with its launches and times; the
   last line is the device record.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/coded_matmul/csrc/coded_matmul.cu"
REPLACES = "src/repro/kernels/coded_matmul/kernel.py:52"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:68"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:63"

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

# flash_attention: (B, Sq, Sk, H, KV, D), dtype, causal.  The reference grid
# and tolerances (tests/test_kernels.py:32-62), a ragged S, the bf16
# schedule at every head dim with ragged lengths and causal rows offset by
# Sk - Sq, and the shapes the serving path gives it: qwen3-0.6b at 64 tokens
# in fp32 (phase 5's prefill check) and at 4096 tokens in bf16 (phase 5's
# timed prefill).
FLASH_GRID = [((2, 256, 256, 4, 2, 32), torch.float32, True),
              ((2, 256, 256, 4, 2, 32), torch.float32, False),
              ((1, 128, 128, 2, 2, 64), torch.bfloat16, True),
              ((2, 200, 200, 4, 2, 32), torch.float32, True),
              ((2, 200, 200, 4, 2, 32), torch.float32, False),
              ((2, 64, 64, 16, 8, 128), torch.float32, True),
              ((2, 300, 300, 4, 2, 16), torch.bfloat16, True),
              ((2, 1, 64, 4, 2, 16), torch.bfloat16, True),
              ((2, 200, 200, 4, 2, 32), torch.bfloat16, False),
              ((2, 63, 200, 8, 1, 32), torch.bfloat16, True),
              ((2, 129, 129, 4, 2, 64), torch.bfloat16, True),
              ((2, 129, 129, 4, 2, 64), torch.bfloat16, False),
              ((2, 5, 70, 4, 4, 64), torch.bfloat16, True),
              ((2, 65, 130, 16, 8, 128), torch.bfloat16, True)]
FLASH_MAIN = ((2, 4096, 4096, 16, 8, 128), torch.bfloat16, True)
# |out - ref| <= atol + rtol |ref|, (atol, rtol) by dtype.  fp32: the
# reference's 2e-5 (tests/test_kernels.py:48).  bf16: both sides compute in
# fp32 and round the output once to bf16, so they differ by at most one
# bf16 step, 2^-7 |o| (under rtol 1e-2), plus fp32 summation-order noise
# (~1e-6, under atol 1e-3).  The atol stays well below the outputs' size at
# the main shape (|o| ~ 1.65 / sqrt(t) on row t, ~0.03 at t = 4096), so a
# fault that moves late rows by a fraction of their size fails; two planted
# faults at the main shape show that it does (``flash_compare``).
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 1e-2)}
# planted faults at the main shape, built from the plain version: the
# softmax scale halved, and KV tile [0, 64) dropped from rows >= 1024
FLASH_DROP_ROWS, FLASH_DROP_TILE = 1024, 64
# ssd_scan: (B, S, H, P, N) x chunk, the reference grid in fp32
# (tests/test_kernels.py:65-83, 2e-5 of max|y|), the mamba2-1.3b shape of
# phase 5's prefill check (64 tokens, one chunk, fp32), and of its timed
# prefill (bf16 x, B and C; dt and A fp32; 1e-2 of max|y|: the output is
# rounded to bf16, 2^-8 of each element).
SSD_GRID = [(shape, chunk) for shape in [(2, 64, 3, 16, 8), (1, 128, 2, 32, 16)]
            for chunk in (4, 16, 64)] + [((2, 64, 64, 64, 128), 64)]
# the bf16 schedule on the same grid, with chunks of 8 and 128 and N = 40
SSD_BF16_GRID = SSD_GRID + [((2, 64, 3, 16, 8), 8), ((1, 128, 2, 32, 16), 8),
                            ((1, 128, 2, 32, 16), 128), ((1, 128, 3, 32, 40), 8),
                            ((1, 128, 3, 32, 40), 64), ((1, 128, 3, 32, 40), 128)]
SSD_MAIN = ((2, 4096, 64, 64, 128), 256)
SSD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# planted faults at the main shape, built from the plain version: the state
# carried between chunks dropped, and chunk SSD_FAULT_CHUNK's C B^T taken
# from the chunk before it (what sharing C B^T across chunks could get wrong)
SSD_FAULT_CHUNK = 5
# prefill logits against token-by-token decode, fp32 compute
# (tests/test_models_smoke.py:114)
PREFILL_TOL = 2e-4
SERVE_ARCHS = ("qwen3-0.6b", "mamba2-1.3b")
# phase 6: the gate shape of benchmarks/cluster_sweep.py
QUEUE_N, QUEUE_JOBS, QUEUE_WARMUP = 120, 600, 60
QUEUE_FRACS = (0.2, 0.35, 0.5, 0.65, 0.8, 0.95)
# the card against the host: one mid cell, and a numpy crash-restart
# schedule (mean up time, mean down time, events per worker) that spans
# the cell's ~9e5 time units
QUEUE_MID_K, QUEUE_MID_FRAC = 12, 0.5
QUEUE_FAILURES = (5e4, 5e3, 64)
# the oracle's tolerances (tests/test_cluster_batched.py:55-72): latencies
# rtol 1e-3 + atol 2e-2, utilization and wasted fraction 2e-3 absolute.
# The lanes keep absolute times in float32 as the reference's engine does
# (ROADMAP Queue 3); at this cell the clock reaches ~9e5, where a float32
# step is 0.0625, so each latency also gets two steps of the clock at the
# latest arrival (host runs of four seeds: at most 0.92 of one step).
QUEUE_RTOL, QUEUE_ATOL, QUEUE_RATE_TOL, QUEUE_CLOCK_ULPS = 1e-3, 2e-2, 2e-3, 2
# examples/load_sweep.py at its own size
LOAD_SWEEP_LOADS = (0.01, 0.06, 0.12, 0.20)
# phase 7: the feasibility gate of benchmarks/fleet_sweep.py — n, jobs, the
# k decades, loads as fractions of lambda_max, the reservoir, and the JAX
# package's 4096 MB memory budget (here: peak device memory)
FLEET_N, FLEET_JOBS, FLEET_RESERVOIR = 10_000, 100_000, 4096
FLEET_KS = (1, 10, 100, 1_000, 10_000)
FLEET_FRACS = (0.3, 0.8)
FLEET_MEM_MB = 4096.0
# the JAX package's own point, bench_results/BENCH_fleet.json (one CPU core)
FLEET_REF_S, FLEET_REF_KSTAR = 235.6, {5e-06: 1, 1.33e-05: 10}
# its fidelity gate (streaming p99 within 2 % of exact, n 120, 6000 jobs,
# k {1, 12, 120}, two loads, reservoir 4096 of 5400 samples) and its
# throughput point (n 120 x 600 jobs, three loads; it gates chunked /
# monolithic >= 0.9 on its own machine).  One run's p99 error is the max
# over six lanes of a subsample's order-statistic noise, and crosses 2 % at
# some seeds (the reference's seed 7 among them, for the port and for the
# JAX package's own engine alike); so the check holds each lane's error
# averaged over FLEET_P99_SEEDS to 2 %, and prints every run's.
FLEET_P99_TOL, FLEET_REF_RATIO = 0.02, 0.9
FLEET_P99_SEEDS = tuple(range(1, 9))
# card against host on a continuous and a failure cell: the same bits on
# both devices, float32 rounding of log1p and of sums between them; held to
# the failure lanes' chunk-parity tolerance (tests/test_fleet.py:172)
FLEET_CARD_RTOL, FLEET_CARD_ATOL = 1e-4, 1e-5
# examples/fleet_scale.py: its day/night MMPP at n 10^4, 10^4 jobs
FLEET_DIURNAL_JOBS, FLEET_DIURNAL_FRACS = 10_000, (0.05, 0.5, 0.85)


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


def ptxas_report(log: str) -> list:
    """(function, registers, spill-store bytes, spill-load bytes) for each
    entry function in nvcc's ``-Xptxas -v`` output, names demangled where
    ``c++filt`` is on the PATH."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and spills is not None:
            rows.append([name, int(m.group(1)), *spills])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for r, full in zip(rows, names):
            r[0] = full.replace("(anonymous namespace)::", "").split("(")[0]
            r[0] = r[0].removeprefix("void ")
    return rows


def build_phase() -> None:
    phase("2. build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    results = _build.build()
    for r in results.values():
        print(f"built {r.name} in {r.seconds:.2f} s -> "
              f"{r.path.relative_to(ROOT)}")
        report = ptxas_report(r.log)
        for fn, regs, stores, loads in report:
            print(f"  {fn}: {regs} registers, spill stores {stores} B, "
                  f"spill loads {loads} B")
        spilled = [fn for fn, _, stores, loads in report if stores or loads]
        print(f"  {len(report)} entry functions, "
              f"{'spills in ' + ', '.join(spilled) if spilled else 'no spills'}")
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


def roofline(nbytes: float, ops: float, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate(ms: float, nbytes: float, ops: float, bound_ms: float,
         bound_by: str) -> str:
    """The achieved rate of what bounds the kernel, and the bound's share
    of its time."""
    achieved = (f"{ops / ms / 1e9:.1f} TFLOP/s" if bound_by == "operations"
                else f"{nbytes / ms / 1e6:.0f} GB/s")
    return f"{achieved}, {bound_ms / ms:.1%} of bound"


def timed_turns(fns: dict, order, reps: dict) -> dict:
    """Mean ms of each function over its turns in ``order``."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(time_ms(fns[name], reps[name]))
    return {name: sum(t) / len(t) for name, t in times.items()}


def bound(G, A, X) -> tuple:
    """(bound_ms, bound_by, bytes, operations): each input read once, the
    output written once, against 2*k*M*K*N + 2*n*k*M*N operations (the
    product with the k source blocks, then the encode) at the inputs' peak
    rate."""
    n, k = G.shape
    _, M, K = A.shape
    N = X.shape[1]
    es = A.element_size()
    nbytes = G.numel() * G.element_size() + (A.numel() + X.numel()
                                             + n * M * N) * es
    ops = 2.0 * k * M * K * N + 2.0 * n * k * M * N
    return (*roofline(nbytes, ops, A.dtype), nbytes, ops)


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
    t = timed_turns(fns, ["plain", "kernel", "library", "library", "kernel",
                          "plain"], dict.fromkeys(fns, reps))
    b_ms, b_by, nbytes, ops = bound(G, A, X)
    row = dict(max_abs_err=max_abs, rel_err=max_abs / scale, ok=ok,
               ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
               bound_ms=b_ms, bound_by=b_by)
    n, k = G.shape
    _, M, K = A.shape
    print(f"  n={n:2d} k={k:2d} M={M:5d} K={K} N={X.shape[1]:3d} "
          f"{str(A.dtype)[6:]:8s} max_abs_err={max_abs:.3e} "
          f"rel={row['rel_err']:.2e} (tol {tol:g}) "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
          f"einsum {row['library_ms']:.4f} ms  bound {b_ms:.4f} ms "
          f"({b_by}; {rate(row['ms'], nbytes, ops, b_ms, b_by)})  "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
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


def excess(out, ref, atol: float, rtol: float) -> float:
    """max |out - ref| / (atol + rtol |ref|): at most 1 within tolerance."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (atol + rtol * ref.abs())).max())


def planted_faults(q, k, v, ref, atol: float, rtol: float) -> None:
    """Show that the tolerance catches a wrong kernel at this shape: two
    faulted outputs, made with the plain version, must fail the check."""
    from repro_torch.kernels.flash_attention import attention_ref
    half_scale = attention_ref(q * 0.5, k, v, True)     # exact in bf16
    dropped = ref.clone()
    r, t = FLASH_DROP_ROWS, FLASH_DROP_TILE
    # rows r.. without keys [0, t): causal rows of the slice sit at key
    # positions (Sk - Sq) + i = r - t + i, i.e. r + i of the full input
    dropped[:, r:] = attention_ref(q[:, r:], k[:, t:], v[:, t:], True)
    for name, out in (("softmax scale x0.5", half_scale),
                      (f"KV tile [0, {t}) dropped from rows >= {r}", dropped)):
        e = excess(out, ref, atol, rtol)
        print(f"    planted fault, {name}: max |out-ref| / limit = {e:.3g}"
              f"  {'caught' if e > 1 else 'MISSED'}", flush=True)
        assert e > 1, f"the tolerance misses a planted fault: {name}"


def flash_compare(shape, dtype, causal: bool, gen, reps: int,
                  plant: bool = False) -> dict:
    """flash_attention against its plain version on one input, then the
    kernel's, the plain version's and SDPA's times in turns (plain,
    kernel, sdpa, sdpa, kernel, plain).  ``plant``: also show that the
    tolerance catches two planted faults on this input."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    B, Sq, Sk, H, KV, D = shape
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, D), generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v, causal)
    ref = attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    assert torch.isfinite(out.float()).all()
    atol, rtol = FLASH_TOL[dtype]
    max_abs = float((out.float() - ref.float()).abs().max())
    ratio = excess(out, ref, atol, rtol)
    ok = ratio <= 1
    if plant:
        planted_faults(q, k, v, ref, atol, rtol)
    del out, ref
    fns = {"plain": lambda: attention_ref(q, k, v, causal),
           "kernel": lambda: flash_attention(q, k, v, causal)}
    # SDPA's causal mask is aligned to the top left: the same function
    # only where Sq == Sk or nothing is masked
    if Sq == Sk or not causal:
        fns["library"] = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
    order = [n for n in ("plain", "kernel", "library", "library", "kernel",
                         "plain") if n in fns]
    t = timed_turns(fns, order, {"plain": max(1, reps // 2), "kernel": reps,
                                 "library": reps})
    # q rows i see keys up to (Sk - Sq) + i under the causal mask
    pairs = Sq * (Sk - Sq) + Sq * (Sq + 1) / 2 if causal else Sq * Sk
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    ops = 4.0 * B * H * pairs * D
    b_ms, b_by = roofline(nbytes, ops, dtype)
    library = t.get("library")
    row = dict(max_abs_err=max_abs, ok=ok, ms=t["kernel"],
               plain_ms=t["plain"], library_ms=library, bound_ms=b_ms,
               bound_by=b_by)
    sdpa = f"{library:.4f} ms" if library is not None else "n/a (offset rows)"
    print(f"  flash B={B} Sq={Sq:4d} Sk={Sk:4d} H={H:2d} KV={KV} D={D:3d} "
          f"{'causal' if causal else 'full  '} {str(dtype)[6:]:8s} "
          f"max_abs_err={max_abs:.3e} (/limit {ratio:.3f}; tol {atol:g} abs "
          f"+ {rtol:g} rel) kernel {t['kernel']:.4f} "
          f"ms  plain {t['plain']:.4f} ms  sdpa {sdpa}  "
          f"bound {b_ms:.4f} ms ({b_by}; "
          f"{rate(t['kernel'], nbytes, ops, b_ms, b_by)})  "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    return row


def ssd_inputs(shape, dtype, gen, model_law: bool):
    """x, dt, A, B, C on the card.  The reference test's laws (dt =
    softplus(normal), A = -exp(normal)) or the model's (dt in [1e-3, 0.1],
    A in [-16, -1))."""
    B, S, H, P, N = shape
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
    if model_law:
        dt = torch.empty((B, S, H), device="cuda").uniform_(
            1e-3, 1e-1, generator=gen)
        A = -torch.empty((H,), device="cuda").uniform_(1.0, 16.0,
                                                       generator=gen)
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=gen, device="cuda"))
        A = -torch.exp(torch.randn((H,), generator=gen, device="cuda"))
    Bm = torch.randn((B, S, N), generator=gen, device="cuda").to(dtype)
    Cm = torch.randn((B, S, N), generator=gen, device="cuda").to(dtype)
    return x, dt, A, Bm, Cm


def ssd_intra(x, dt, A, Cm, Bm):
    """The intra-chunk term of one chunk from the given C and B, as the
    plain version computes it: sum_{s<=t} (C_t . B_s) exp(l_t - l_s) dt_s
    x_s, in fp32."""
    lc = torch.cumsum(dt * A, dim=1)
    q = x.shape[1]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.where(causal[None, :, :, None],
                        torch.exp(lc[:, :, None] - lc[:, None]), 0.0)
    cb = torch.einsum("bqn,bsn->bqs", Cm.float(), Bm.float())
    return torch.einsum("bqsh,bshp->bqhp", cb[..., None] * decay * dt[:, None],
                        x.float())


def ssd_planted_faults(args, chunk: int, ref, limit: float) -> None:
    """Show that the tolerance catches a wrong scan at this shape: two
    faulted outputs, made with the plain version, must read >= 10x it."""
    from repro_torch.kernels.ssd_scan import ssd_chunked
    x, dt, A, Bm, Cm = args
    b, s = x.shape[:2]
    cut = lambda t: t.reshape(b * (s // chunk), chunk, *t.shape[2:])
    dropped = ssd_chunked(cut(x), cut(dt), A, cut(Bm), cut(Cm), chunk)[0]
    c = SSD_FAULT_CHUNK
    rows, prev = slice(c * chunk, (c + 1) * chunk), slice((c - 1) * chunk, c * chunk)
    swapped = ref.float()
    swapped[:, rows] += (ssd_intra(x[:, rows], dt[:, rows], A, Cm[:, prev], Bm[:, prev])
                         - ssd_intra(x[:, rows], dt[:, rows], A, Cm[:, rows], Bm[:, rows]))
    for name, out in (("state dropped between chunks", dropped.view(x.shape)),
                      (f"chunk {c}'s C B^T from chunk {c - 1}", swapped)):
        e = float((out.float() - ref.float()).abs().max()) / limit
        print(f"    planted fault, {name}: max |out-ref| / limit = {e:.3g}"
              f"  {'caught' if e >= 10 else 'MISSED'}", flush=True)
        assert e >= 10, f"the tolerance misses a planted fault: {name}"


def device_split(fn, reps: int) -> dict:
    """Mean device ms of each CUDA kernel that ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls; empty if it sees no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    def name(key):
        return key.replace("(anonymous namespace)::", "").removeprefix(
            "void ").split("(")[0]
    return {name(e.key): e.self_device_time_total / reps / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def ssd_compare(shape, chunk: int, dtype, gen, reps: int,
                model_law: bool = False, plant: bool = False) -> dict:
    """ssd_scan against its plain version (the chunked form) on one input,
    then the kernel's and the plain version's times in turns (plain,
    kernel, kernel, plain).  No single PyTorch call computes the scan.
    ``plant``: also show that the tolerance catches two planted faults on
    this input, and split the call's device time over its CUDA kernels."""
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    args = ssd_inputs(shape, dtype, gen, model_law)
    out = ssd_scan(*args, chunk=chunk)
    ref = ssd_chunked(*args, chunk)[0]
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    assert torch.isfinite(out.float()).all()
    scale = float(ref.float().abs().max())
    max_abs = float((out.float() - ref.float()).abs().max())
    tol = SSD_TOL[dtype]
    ok = max_abs <= tol * scale
    if plant:
        ssd_planted_faults(args, chunk, ref, tol * scale)
    del out, ref
    fns = {"plain": lambda: ssd_chunked(*args, chunk),
           "kernel": lambda: ssd_scan(*args, chunk=chunk)}
    t = timed_turns(fns, ["plain", "kernel", "kernel", "plain"],
                    {"plain": max(1, reps // 2), "kernel": reps})
    B, S, H, P, N = shape
    nc, tri = S // chunk, chunk * (chunk + 1) / 2
    # C B^T over the causal half once per (batch row, chunk); per head the
    # causal half of the weighted sum, C h^T and the state update
    ops = B * nc * (2.0 * tri * N + H * (2.0 * tri * P + 4.0 * chunk * N * P))
    x, dt, A, Bm, _ = args
    nbytes = (2 * x.numel() * x.element_size() + 4 * (dt.numel() + A.numel())
              + 2 * Bm.numel() * Bm.element_size())
    # the products' operands are x's dtype: bf16 on the tensor cores
    b_ms, b_by = roofline(nbytes, ops, dtype)
    row = dict(max_abs_err=max_abs, ok=ok, ms=t["kernel"],
               plain_ms=t["plain"], library_ms=None, bound_ms=b_ms,
               bound_by=b_by)
    print(f"  ssd B={B} S={S:4d} H={H:2d} P={P:2d} N={N:3d} chunk={chunk:3d} "
          f"{str(dtype)[6:]:8s} max_abs_err={max_abs:.3e} "
          f"rel={max_abs / scale:.2e} (/limit {max_abs / (tol * scale):.3f}; "
          f"tol {tol:g} of max|y|) kernel {t['kernel']:.4f} ms  plain "
          f"{t['plain']:.4f} ms  bound {b_ms:.4f} ms ({b_by}; "
          f"{rate(t['kernel'], nbytes, ops, b_ms, b_by)})"
          f"  {'ok' if ok else 'MISMATCH'}", flush=True)
    if plant:
        split = device_split(fns["kernel"], reps)
        print(f"    device time of one call by CUDA kernel (profiler, {reps} "
              f"calls): " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()),
              flush=True)
    return row


def model_kernel_phase(seed: int) -> dict:
    """Phase 3, continued: the serving path's two kernels.  Returns the
    rows at the main-path shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    failures = []
    print("flash_attention:")
    for shape, dtype, causal in FLASH_GRID:
        if not flash_compare(shape, dtype, causal, gen, reps=10)["ok"]:
            failures.append(("flash_attention", shape, dtype, causal))
    flash = flash_compare(*FLASH_MAIN, gen, reps=5, plant=True)
    if not flash["ok"]:
        failures.append(("flash_attention", FLASH_MAIN))
    print("ssd_scan:")
    for shape, chunk in SSD_GRID:
        if not ssd_compare(shape, chunk, torch.float32, gen, reps=10)["ok"]:
            failures.append(("ssd_scan", shape, chunk, torch.float32))
    for shape, chunk in SSD_BF16_GRID:
        if not ssd_compare(shape, chunk, torch.bfloat16, gen, reps=10)["ok"]:
            failures.append(("ssd_scan", shape, chunk, torch.bfloat16))
    ssd = ssd_compare(*SSD_MAIN, torch.bfloat16, gen, reps=10, model_law=True,
                      plant=True)
    if not ssd["ok"]:
        failures.append(("ssd_scan", SSD_MAIN))
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{failures}")
    return {"flash_attention": flash, "ssd_scan": ssd}


def main_path_phase(cfg, seed: int) -> dict:
    """The port's main path; returns {(k, N): launches}."""
    from repro_torch.api import Planner, Scenario
    from repro_torch.core import (BiModal, Pareto, Scaling, ShiftedExp,
                                  completion_curve_mc, decode_blocks,
                                  job_completion_times, mds_generator,
                                  sample_task_times)
    from repro_torch.kernels.coded_matmul import coded_matmul
    phase("4. coded mat-vec path")
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


def profile_call(label: str, fn):
    """One more call of ``fn`` under ``torch.profiler``: the device
    operations it launched, device time by kernel group and the device's
    idle share of the call's span.  Returns (device operations, busy ms,
    span ms), or None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"  profiled {label}: span {span_ms:.2f} ms; the profiler saw "
              f"no device time: breakdown not measured")
        return None
    groups = {}
    for e in kernels:
        low = e.key.lower()
        group = ("flash_attention" if "flash_fwd" in low else
                 "ssd_scan" if "ssd_scan" in low else
                 "matmul" if any(w in low for w in ("gemm", "nvjet", "cutlass",
                                                    "sm90_xmma")) else
                 "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total
    busy_ms = sum(groups.values()) / 1e3
    idle = 1 - busy_ms / span_ms
    print(f"  profiled {label}: span {span_ms:.3f} ms (CUDA events, under the "
          f"profiler), {sum(e.count for e in kernels)} device operations, "
          f"busy {busy_ms:.3f} ms, device idle {idle:.1%} of the span")
    if idle < 0:
        print(f"  WARNING: device time exceeds the span by {-idle:.1%}: the "
              f"busy count is wrong (overlap or double counting); idle share "
              f"not measured", flush=True)
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {group:16s} {us / 1e3:9.3f} ms  {us / 1e3 / span_ms:6.1%}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"    top: {e.self_device_time_total / 1e3:9.3f} ms x{e.count:4d} "
              f"{e.key[:90]}")
    return sum(e.count for e in kernels), busy_ms, span_ms


def serving_phase(seed: int) -> dict:
    """The serving path at full width; returns {kernel: launches}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import api
    phase("5. serving path at full width")
    counters = {"qwen3-0.6b": ("flash_attention", flash_attention),
                "mamba2-1.3b": ("ssd_scan", ssd_scan)}
    launches = {}
    for arch in SERVE_ARCHS:
        name, counter = counters[arch]
        cfg = get_config(arch)
        layers = cfg.num_layers
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = api.init_params(cfg, gen)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{arch}: {n_params / 1e6:.1f} M parameters, fp32, made on "
              f"the card in {time.perf_counter() - t0:.2f} s (host clock)")

        def forward(c, toks):
            counter.launches = 0
            logits = api.forward(c, model, toks)
            torch.cuda.synchronize()
            assert counter.launches == layers, (arch, counter.launches)
            launches[name] = launches.get(name, 0) + counter.launches
            assert torch.isfinite(logits).all()
            assert logits.shape == (*toks.shape, api.padded_vocab(c))
            return logits

        # prefill against token-by-token decode, fp32 compute
        cfg32 = cfg.scaled(compute_dtype="float32")
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                             device="cuda")
        full = forward(cfg32, toks)
        cache = api.init_cache(cfg32, 2, 64, dtype="float32", device="cuda")
        steps = []
        for t in range(64):
            lg, cache = api.decode_step(cfg32, model, cache, toks[:, t:t + 1],
                                        t)
            steps.append(lg[:, 0])
        dec = torch.stack(steps, dim=1)
        diff = (dec - full).abs()
        ok = bool((diff <= PREFILL_TOL + PREFILL_TOL * full.abs()).all())
        print(f"  prefill (fp32, B 2 x 64 tokens, {name} launches "
              f"{layers}) against 64 decode steps: max|diff| "
              f"{float(diff.max()):.3e}, max|logits| "
              f"{float(full.abs().max()):.3f} (tol {PREFILL_TOL:g} abs + "
              f"rel)  {'ok' if ok else 'MISMATCH'}", flush=True)
        assert ok, (arch, float(diff.max()))
        del full, dec, diff, cache, steps

        # timed prefill in the config's own compute dtype
        toks = torch.randint(0, cfg.vocab_size, (2, 4096), generator=gen,
                             device="cuda")
        ms = []
        for _ in ("first", "warm"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = forward(cfg, toks)
            end.record()
            torch.cuda.synchronize()
            assert logits.dtype == torch.bfloat16
            ms.append(start.elapsed_time(end))
            del logits
        print(f"  prefill ({cfg.compute_dtype}, B 2 x S 4096, {name} "
              f"launches {layers} each): first call {ms[0]:.2f} ms, warm "
              f"{ms[1]:.2f} ms = {2 * 4096 / ms[1] * 1e3:.0f} tokens/s "
              f"(CUDA events)", flush=True)
        profile_call("prefill", lambda: forward(cfg, toks))

        # the hedged serving loop at the reference's defaults
        dist = serve.parse_dist("pareto:0.05:1.8")
        r = serve.plan_replicas(dist, 4)
        print(f"  hedging plan: r = {r} replicas (tail gain "
              f"{serve.hedge_gain(dist, r):.2f}x)")
        prompt = torch.randint(1, cfg.vocab_size, (4, 32), generator=gen,
                               device="cuda")
        res = serve.serve(cfg, model, prompt, 32, dist, r)
        assert res.tokens.shape == (4, 32)
        in_vocab = (res.tokens >= 0) & (res.tokens < api.padded_vocab(cfg))
        assert in_vocab.all(), res.tokens
        print(f"  serve: batch 4, prompt 32 (decode steps {res.prompt_s:.3f} "
              f"s), gen 32 in {res.gen_s:.3f} s = {res.tokens_per_s:.1f} "
              f"tokens/s (host clock); tokens >= vocab_size "
              f"{int((res.tokens >= cfg.vocab_size).sum())} of "
              f"{res.tokens.size} (argmax over the padded vocab, as the "
              f"reference's)")
        print(f"  greedy tokens, row 0: {res.tokens[0].tolist()}")
        print(f"  simulated service latency: hedged {res.sim_latency:.2f} vs "
              f"unhedged E {res.unhedged:.2f} (r={r})", flush=True)

        # one decode step of the serve loop's shape, timed and profiled
        cache = api.init_cache(cfg, 4, 64, dtype="float32", device="cuda")
        tok = prompt[:, :1]
        _, cache = api.decode_step(cfg, model, cache, tok, 0)
        step_ms = time_ms(lambda: api.decode_step(cfg, model, cache, tok, 1),
                          reps=20)
        print(f"  decode step (batch 4, position 1, {cfg.compute_dtype}): "
              f"{step_ms:.3f} ms a step (CUDA events, 20 steps)")
        profile_call("decode step",
                     lambda: api.decode_step(cfg, model, cache, tok, 1))
        del cache
        del model
        torch.cuda.empty_cache()
    return launches


def queueing_phase(seed: int) -> None:
    """Phase 6: the load-aware queueing path on the card.  Any miss
    raises."""
    import numpy as np
    from repro_torch.api import (AllWorkers, LoadAwareLatency, MMPPArrivals,
                                 Planner, RandomGroups, ReplicationGroups,
                                 RoundRobin, Scenario, SpeedAware)
    from repro_torch.core.distributions import BiModal, Scaling, ShiftedExp
    from repro_torch.core.policy import RetryPolicy
    from repro_torch.runtime.cluster import ClusterConfig, simulate
    from repro_torch.runtime.cluster_batched import sweep
    phase("6. load-aware queueing path")
    t_phase = time.perf_counter()

    # -- the cluster_sweep gate shape ---------------------------------------
    dist, scaling = ShiftedExp(1.0, 5.0), Scaling.SERVER_DEPENDENT
    sc = Scenario(dist, scaling, QUEUE_N)
    ks = sc.legal_ks()
    lam_max = 1.0 / (dist.mean() * QUEUE_N)
    loads = [lam_max * f for f in QUEUE_FRACS]
    cells = len(ks) * len(loads)

    def surface(s):
        return sweep(sc, loads, num_jobs=QUEUE_JOBS, seed=s,
                     warmup=QUEUE_WARMUP, device="cuda")

    t0 = time.perf_counter()
    surface(1)
    first_s = time.perf_counter() - t0
    warm = []
    for s in (2, 3):
        t0 = time.perf_counter()
        sw = surface(s)
        warm.append(time.perf_counter() - t0)
    assert sw.mean.shape == (len(loads), len(ks)), sw.mean.shape
    for m in ("mean", "p99", "utilization", "wasted_frac", "throughput"):
        assert np.isfinite(sw.metric(m)).all(), m
    kstar = sw.kstar()
    assert all(QUEUE_N % k == 0 for k in kstar.values()), kstar
    batched_s = min(warm)
    cps = cells / batched_s
    print(f"  gate shape: S-Exp(1, 5) server-dependent, n {QUEUE_N}, "
          f"{len(ks)} k x {len(loads)} loads = {cells} cells, "
          f"{QUEUE_JOBS} jobs, warmup {QUEUE_WARMUP}, 1 rep "
          f"({len(ks) * len(loads)} lanes)")
    print(f"  sweep (host clock, results on the host): first call "
          f"{first_s:.3f} s, warm {warm[0]:.3f} / {warm[1]:.3f} s = "
          f"{cps:.1f} cells/s, {batched_s / QUEUE_JOBS * 1e3:.4f} ms per job "
          f"step", flush=True)
    print(f"  k* by load (x lambda_max): "
          + ", ".join(f"{f}: {kstar[float(lam)]}"
                      for f, lam in zip(QUEUE_FRACS, loads)))
    stats = profile_call("sweep (seed 2)", lambda: surface(2))
    if stats is not None:
        ops, busy_ms, span_ms = stats
        print(f"  {ops / QUEUE_JOBS:.1f} device operations per job step; "
              f"device busy {busy_ms:.3f} ms of {span_ms:.3f} ms, idle "
              f"{1 - busy_ms / span_ms:.1%}")
    oracle_cells = [(ks[0], loads[0]), (ks[len(ks) // 2], loads[2]),
                    (ks[-1], loads[-1])]
    t0 = time.perf_counter()
    oracle = {cell: simulate(
        ClusterConfig(QUEUE_N, cell[0], cell[1], num_jobs=QUEUE_JOBS, seed=1,
                      warmup=QUEUE_WARMUP), dist, scaling, backend="oracle",
        device="cuda") for cell in oracle_cells}
    oracle_s = time.perf_counter() - t0
    ocps = len(oracle_cells) / oracle_s
    print(f"  oracle on {len(oracle_cells)} cells (k, x lambda_max) "
          f"{[(k, round(lam / lam_max, 2)) for k, lam in oracle_cells]}: "
          f"{oracle_s:.3f} s = {ocps:.2f} cells/s; batched / oracle "
          f"{cps / ocps:.1f}x (the JAX package gates >= 20x on its own "
          f"machine; printed, not checked)")
    k_mid, lam_mid = oracle_cells[1]
    om = oracle[oracle_cells[1]].summary()["mean"]
    bm = sw.summary(2, ks.index(k_mid))["mean"]
    print(f"  mid cell (k {k_mid}, 0.5 lambda_max) mean latency: batched "
          f"{bm:.3f}, oracle {om:.3f} (benchmarks/cluster_sweep.py's guard: "
          f"within 15 %)", flush=True)
    assert abs(bm - om) / om < 0.15, (bm, om)

    # -- the card against the host on injected draws ------------------------
    rng = np.random.default_rng(seed)
    n, k, lam = QUEUE_N, QUEUE_MID_K, lam_max * QUEUE_MID_FRAC
    svc = dist.shift + (n // k) * rng.exponential(dist.W, (QUEUE_JOBS, n))
    arr = np.cumsum(rng.exponential(1.0 / lam, QUEUE_JOBS))
    mttf, mttr, events = QUEUE_FAILURES
    up = rng.exponential(mttf, (n, events))
    down = rng.exponential(mttr, (n, events))
    crash = np.cumsum(up + np.pad(down[:, :-1], ((0, 0), (1, 0))), axis=1)
    step = float(np.spacing(np.float32(arr.max())))
    print(f"  injected draws (numpy, seed {seed}): k {k}, load "
          f"{QUEUE_MID_FRAC} lambda_max, clock up to {arr.max():.0f} "
          f"(float32 step {step:g})")
    retry = RetryPolicy(max_attempts=3, backoff_base=0.5, backoff_mult=2.0)
    for cell, extra, kw in (
            ("plain", {}, {}),
            ("failure", dict(retry=retry),
             dict(crash_times=crash, recovery_times=crash + down)),
            ("grouped g=2", dict(assignment=ReplicationGroups(g=2)), {})):
        cfg = ClusterConfig(n, k, lam, num_jobs=QUEUE_JOBS, **extra)
        card, host, des = (simulate(
            cfg, dist, scaling, backend=backend, service_times=svc,
            arrival_times=arr, device=dev, **kw)
            for backend, dev in (("batched", "cuda"), ("batched", "cpu"),
                                 ("oracle", "cuda")))
        equal = np.array_equal(card.latencies, host.latencies)
        rel = [abs(a - b) / abs(b) if b else abs(a)
               for a, b in ((card.utilization, host.utilization),
                            (card.wasted_frac, host.wasted_frac))]
        diff = np.abs(card.latencies - des.latencies)
        ref_tol = QUEUE_ATOL + QUEUE_RTOL * np.abs(des.latencies)
        within = bool((diff <= ref_tol + QUEUE_CLOCK_ULPS * step).all())
        rates = max(abs(card.utilization - des.utilization),
                    abs(card.wasted_frac - des.wasted_frac))
        masks = card.job_failed is None or (
            np.array_equal(card.job_failed, host.job_failed)
            and np.array_equal(card.job_failed, des.job_failed))
        ok = equal and max(rel) <= 1e-5 and within and \
            rates < QUEUE_RATE_TOL and masks
        print(f"  {cell:12s} card = host latencies {equal}, utilization / "
              f"wasted rel diff {rel[0]:.1e} / {rel[1]:.1e}; against the "
              f"oracle max|diff| {diff.max():.4f} ({diff.max() / step:.2f} "
              f"clock steps), {int((diff > ref_tol).sum())} of "
              f"{diff.size} outside 2e-2 + 1e-3|lat| alone, rates "
              f"{rates:.1e}; failed jobs "
              f"{0 if card.job_failed is None else int(card.job_failed.sum())}"
              f"  {'ok' if ok else 'MISMATCH'}", flush=True)
        assert ok, cell

    # -- examples/load_sweep.py's three surfaces ----------------------------
    planner = Planner()
    sc = Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, 12)
    single = planner.plan(sc).k
    law = LoadAwareLatency(num_jobs=2000, reps=4, seed=0)
    burst = MMPPArrivals(rate=1.0, slow=0.2, burst=5.0, switch=0.02)
    for label, scen, obj in (
            ("Poisson, mean", sc, law),
            ("MMPP burst, p99",
             Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, 12,
                      arrivals=burst),
             LoadAwareLatency(num_jobs=2000, reps=4, seed=0, metric="p99")),
            ("speeds (1,)*10+(3,3), mean",
             Scenario(BiModal(10.0, 0.3), Scaling.ADDITIVE, 12,
                      worker_speeds=(1,) * 10 + (3.0, 3.0)), law)):
        t0 = time.perf_counter()
        kmap = planner.kstar_vs_load(scen, list(LOAD_SWEEP_LOADS), obj)
        dt = time.perf_counter() - t0
        assert set(kmap) == set(LOAD_SWEEP_LOADS), kmap
        assert all(12 % v == 0 for v in kmap.values()), kmap
        print(f"  load_sweep {label:27s}: k* {kmap} (single-job k* "
              f"{single} beside load {LOAD_SWEEP_LOADS[0]}); 2000 jobs x 4 "
              f"reps x {len(LOAD_SWEEP_LOADS)} loads x 6 k in {dt:.3f} s",
              flush=True)

    # -- Planner.co_plan at examples/assignment.py's candidates -------------
    cdist = ShiftedExp(1.0, 1.25)
    csc = Scenario(cdist, Scaling.SERVER_DEPENDENT, 12,
                   worker_speeds=(3.0,) * 4 + (1.0,) * 8)
    clam = 1.0 / (cdist.mean() * 12)
    candidates = [AllWorkers(), RoundRobin(), RandomGroups(), SpeedAware()]
    t0 = time.perf_counter()
    plan = Planner(LoadAwareLatency(num_jobs=1200, reps=2, preempt=False,
                                    seed=0)).co_plan(
        csc, candidates, objective=LoadAwareLatency(
            arrival_rate=0.5 * clam, num_jobs=1200, reps=2, preempt=False,
            seed=0))
    dt = time.perf_counter() - t0
    assert plan.k in csc.legal_ks() and np.isfinite(plan.expected_time)
    assert all(np.isfinite(v) for v in plan.curve.values()), plan.curve
    print(f"  co_plan: k* {plan.k}, placement {plan.assignment}, mean "
          f"{plan.expected_time:.3f}; {len(candidates)} placements x "
          f"{len(csc.legal_ks())} k x 1200 jobs x 2 reps in {dt:.3f} s")
    print("  envelope: " + ", ".join(f"k={kk}: {v:.2f}"
                                     for kk, v in sorted(plan.curve.items())))
    print(f"  phase 6 in {time.perf_counter() - t_phase:.1f} s (host clock)",
          flush=True)


def fleet_phase(seed: int) -> None:
    """Phase 7: the chunked fleet engine on the card.  Any miss raises."""
    import numpy as np
    from repro_torch.core.distributions import BiModal, Scaling, ShiftedExp
    from repro_torch.core.policy import RetryPolicy
    from repro_torch.core.scenario import (DeterministicArrivals,
                                           FailureModel, MMPPArrivals,
                                           Scenario)
    from repro_torch.runtime.cluster_batched import _kth_sort, sweep
    from repro_torch.runtime.fleet import (_kth_bisect, build_fleet_lanes,
                                           default_chunk, fleet_sweep,
                                           run_fleet)
    phase("7. fleet-scale queueing")
    t_phase = time.perf_counter()
    dist, scaling = ShiftedExp(1.0, 5.0), Scaling.SERVER_DEPENDENT

    # -- benchmarks/fleet_sweep.py's feasibility surface --------------------
    sc = Scenario(dist, scaling, FLEET_N)
    lam_max = 1.0 / (dist.mean() * FLEET_N)
    loads = [lam_max * f for f in FLEET_FRACS]
    chunk = default_chunk(FLEET_JOBS)
    kw = dict(ks=list(FLEET_KS), reps=1, seed=1, chunk_size=chunk,
              stream=True, reservoir=FLEET_RESERVOIR, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sw = fleet_sweep(sc, loads, num_jobs=FLEET_JOBS, **kw)
    wall = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    cells = len(loads) * len(FLEET_KS)
    print(f"  gate: S-Exp(1, 5) server-dependent, n {FLEET_N}, "
          f"{FLEET_JOBS} jobs, k {list(FLEET_KS)} x loads lambda_max x "
          f"{list(FLEET_FRACS)} = {cells} cells, chunk {chunk}, stream, "
          f"reservoir {FLEET_RESERVOIR}, 1 rep")
    print(f"  fleet_sweep (host clock, results on the host): {wall:.3f} s, "
          f"{FLEET_JOBS / wall:.1f} jobs/s, {wall / FLEET_JOBS * 1e3:.4f} ms "
          f"per job step; peak device memory {peak_mb:.1f} MB (budget "
          f"{FLEET_MEM_MB:.0f} MB)", flush=True)
    kstar = sw.kstar()
    print("  k* by load: " + ", ".join(
        f"{lam:.3g} ({f} lambda_max): {kstar[float(lam)]}"
        for f, lam in zip(FLEET_FRACS, loads)))
    print(f"  the JAX package's CPU run (bench_results/BENCH_fleet.json, one "
          f"CPU core, not this card): {FLEET_REF_S} s, k* {FLEET_REF_KSTAR}")
    for m in ("mean", "p50", "p99", "utilization", "throughput"):
        assert np.isfinite(sw.metric(m)).all(), (m, sw.metric(m))
    assert (sw.p99 > 0).all() and all(FLEET_N % k == 0
                                      for k in kstar.values()), kstar
    assert peak_mb < FLEET_MEM_MB, peak_mb
    stats = profile_call(
        f"two chunks at the gate width ({2 * chunk} jobs)",
        lambda: fleet_sweep(sc, loads, num_jobs=2 * chunk, **kw))
    if stats is not None:
        ops, busy_ms, span_ms = stats
        print(f"  {ops / (2 * chunk):.1f} device operations per job step; "
              f"device busy {busy_ms:.3f} ms of {span_ms:.3f} ms, idle "
              f"{1 - busy_ms / span_ms:.1%}", flush=True)

    # -- fidelity: streaming p99 against the exact cube ---------------------
    n2, jobs2 = 120, 6000
    lam2 = 1.0 / (dist.mean() * n2)
    kw2 = dict(ks=[1, 12, 120], num_jobs=jobs2, reps=1,
               chunk_size=default_chunk(jobs2), device="cuda")
    sc2 = Scenario(dist, scaling, n2)
    errs = []
    for s_ in FLEET_P99_SEEDS:
        exact = fleet_sweep(sc2, [lam2 * 0.3, lam2 * 0.8], seed=s_, **kw2)
        stream = fleet_sweep(sc2, [lam2 * 0.3, lam2 * 0.8], seed=s_, **kw2,
                             stream=True, reservoir=FLEET_RESERVOIR)
        errs.append(np.abs(stream.p99 - exact.p99) / exact.p99)
    errs = np.stack(errs)                                 # (seeds, L, K)
    lane_mean = errs.mean(axis=0)
    print(f"  fidelity (n {n2}, {jobs2} jobs, reservoir {FLEET_RESERVOIR} of "
          f"{jobs2 - jobs2 // 10} samples): streaming p99 max rel err per "
          f"seed " + ", ".join(f"{s_}: {e.max():.5f}"
                               for s_, e in zip(FLEET_P99_SEEDS, errs))
          + f"; worst lane's mean over the {len(FLEET_P99_SEEDS)} seeds "
          f"{lane_mean.max():.5f} (limit {FLEET_P99_TOL}); the JAX "
          f"package's recorded run (seed 7, bench_results/BENCH_fleet.json) "
          f"0.00656", flush=True)
    assert lane_mean.max() < FLEET_P99_TOL, lane_mean

    # -- chunked against monolithic at the monolithic engine's scale --------
    n3, jobs3 = 120, 600
    lam3 = 1.0 / (dist.mean() * n3)
    sc3 = Scenario(dist, scaling, n3)
    kw3 = dict(loads=[lam3 * f for f in (0.2, 0.5, 0.8)], num_jobs=jobs3,
               warmup=jobs3 // 10, device="cuda")

    def best(fn):
        fn(1)
        ts = []
        for s_ in (2, 3, 4):
            t0 = time.perf_counter()
            fn(s_)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    mono_s = best(lambda s_: sweep(sc3, seed=s_, **kw3))
    chnk_s = best(lambda s_: fleet_sweep(
        sc3, seed=s_, chunk_size=default_chunk(jobs3), **kw3))
    print(f"  chunked / monolithic throughput at n {n3} x {jobs3} jobs, 16 k "
          f"x 3 loads: {mono_s / chnk_s:.3f} ({chnk_s:.3f} s against "
          f"{mono_s:.3f} s, best of three; the JAX package gates >= "
          f"{FLEET_REF_RATIO} on its own machine, printed, not checked)",
          flush=True)

    # -- card against host --------------------------------------------------
    dyadic = Scenario(BiModal(4.0, 0.25), scaling, 12,
                      arrivals=DeterministicArrivals(rate=1.0))

    def raw(sc_, c, device):
        lanes = build_fleet_lanes(None, 12, [1, 3, 12])
        return run_fleet(sc_, [0.25], lanes, num_jobs=60, reps=2,
                         preempt=True, cancel_overhead=0.0, seed=seed,
                         warmup=6, arrivals=sc_.arrivals,
                         speeds=np.ones(12, np.float32), failures=None,
                         retry=None, chunk=c, stream=False, reservoir=64,
                         shard=None, device=device)

    for c in (1, 7, 64):
        card, host = raw(dyadic, c, "cuda"), raw(dyadic, c, "cpu")
        equal = all(np.array_equal(getattr(card, f), getattr(host, f))
                    for f in ("lat", "busy", "wasted", "horizon"))
        print(f"  dyadic cell (Bi-Modal(4, 0.25), clockwork arrivals, n 12) "
              f"chunk {c:2d}: card = host bitwise {equal}")
        assert equal, c
    for label, sc_, retry in (
            ("continuous", Scenario(ShiftedExp(1.0, 2.0), scaling, 12), None),
            ("failure", Scenario(ShiftedExp(1.0, 2.0), scaling, 12,
                                 failures=FailureModel(80.0, 4.0, 16)),
             RetryPolicy(3, 0.5, jitter=0.3))):
        card, host = (fleet_sweep(sc_, [0.05, 0.2], ks=[1, 3, 12],
                                  num_jobs=120, reps=2, seed=seed,
                                  chunk_size=32, retry=retry, device=d)
                      for d in ("cuda", "cpu"))
        worst = 0.0
        for m in ("mean", "p50", "p95", "p99", "utilization", "wasted_frac",
                  "throughput") + (("failure_rate",) if retry else ()):
            a, b = card.metric(m), host.metric(m)
            excess = np.abs(a - b) / (FLEET_CARD_ATOL + FLEET_CARD_RTOL
                                      * np.abs(b))
            worst = max(worst, float(excess.max()))
        print(f"  {label} cell: card against host, worst metric "
              f"{worst:.3f} of the limit {FLEET_CARD_ATOL} + "
              f"{FLEET_CARD_RTOL}|host|", flush=True)
        assert worst <= 1.0, (label, worst)

    # -- selection: radix bisection against the sort ------------------------
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ks = torch.tensor(FLEET_KS * 2, device="cuda")
    nat = torch.empty((ks.numel(), FLEET_N), device="cuda").exponential_(
        generator=gen)
    bis, srt = _kth_bisect(nat, ks), _kth_sort(nat, (ks - 1)[:, None])[:, 0]
    same = bool(torch.equal(bis, srt))
    t_bis = time_ms(lambda: _kth_bisect(nat, ks), 50)
    t_srt = time_ms(lambda: _kth_sort(nat, (ks - 1)[:, None]), 50)
    print(f"  k-th finish on {tuple(nat.shape)}: bisection {t_bis:.4f} ms "
          f"(31 passes, CUDA events), sort {t_srt:.4f} ms; bitwise equal "
          f"{same}; the step uses the sort", flush=True)
    assert same

    # -- examples/fleet_scale.py's day/night MMPP surface -------------------
    diurnal = MMPPArrivals(rate=1.0, slow=0.4, burst=1.6, switch=1e-3)
    sc_day = Scenario(dist, scaling, FLEET_N, arrivals=diurnal)
    lam_e = 1.0 / dist.mean()
    dloads = [lam_e * f for f in FLEET_DIURNAL_FRACS]
    t0 = time.perf_counter()
    day = fleet_sweep(sc_day, dloads, ks=list(FLEET_KS),
                      num_jobs=FLEET_DIURNAL_JOBS, seed=0,
                      chunk_size=default_chunk(FLEET_DIURNAL_JOBS),
                      stream=True, device="cuda")
    dt = time.perf_counter() - t0
    assert np.isfinite(day.mean).all() and np.isfinite(day.p99).all()
    km, kp = day.kstar(), day.kstar(metric="p99")
    print(f"  fleet_scale diurnal MMPP (n {FLEET_N}, {FLEET_DIURNAL_JOBS} "
          f"jobs, 15 cells) in {dt:.3f} s: k* mean / p99 by load (x 1/E[Y]) "
          + ", ".join(f"{f}: {km[float(lam)]} / {kp[float(lam)]}"
                      for f, lam in zip(FLEET_DIURNAL_FRACS, dloads)))
    print(f"  phase 7 in {time.perf_counter() - t_phase:.1f} s (host clock)",
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    smi = device_phase()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import CONFIG
    build_phase()
    timed = kernel_phase(CONFIG, args.seed)
    model_rows = model_kernel_phase(args.seed)
    launches = main_path_phase(CONFIG, args.seed)
    serve_launches = serving_phase(args.seed)
    queueing_phase(args.seed)
    fleet_phase(args.seed)

    phase("8. kernels")
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
    shapes = {"flash_attention": "qwen3-0.6b prefill B=2,S=4096,H=16,KV=8,"
                                 "D=128,bf16,causal",
              "ssd_scan": "mamba2-1.3b prefill B=2,S=4096,H=64,P=64,N=128,"
                          "chunk=256,bf16"}
    sources = {"flash_attention": (FLASH_SOURCE, FLASH_REPLACES),
               "ssd_scan": (SSD_SOURCE, SSD_REPLACES)}
    for name, row in model_rows.items():
        kernels.append({
            "name": f"{name}[{shapes[name]}]", "route": "cuda",
            "source": sources[name][0], "replaces": sources[name][1],
            "launches": serve_launches.get(name, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
