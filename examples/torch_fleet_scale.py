"""Fleet-scale planning on the PyTorch port: k* vs load at n = 10,000.

    PYTHONPATH=src python examples/torch_fleet_scale.py                # card
    PYTHONPATH=src python examples/torch_fleet_scale.py --smoke --device cpu

The twin of ``examples/fleet_scale.py``.  The paper's diversity/
parallelism question at fleet width: 10^4 workers can split a job 10^4
ways (parallelism) or run it replicated on all 10^4 (diversity), with
four decades of k between.  The monolithic lane engine cannot hold that
surface; the chunked streaming engine (``repro_torch.runtime.fleet``)
runs it in fixed-size job chunks with a per-chunk rebased clock and
reservoir-sketched tails, in O(n + chunk x n) memory.

1. the k* x load map across four decades of k, exact-paired by CRN;
2. diurnal traffic: the same fleet under a slowly-switching MMPP
   (day/night phases) — burst piling moves k* at the SAME average rate.
"""
import argparse

from repro_torch.core.distributions import Scaling, ShiftedExp
from repro_torch.core.scenario import MMPPArrivals, Scenario
from repro_torch.runtime.fleet import default_chunk, fleet_sweep

ap = argparse.ArgumentParser()
ap.add_argument("--smoke", action="store_true",
                help="n=1000, fewer jobs (CI sizes)")
ap.add_argument("--device", default="cuda",
                help="where the engine runs (default cuda; cpu for the host)")
args = ap.parse_args()

N = 1_000 if args.smoke else 10_000
JOBS = 4_000 if args.smoke else 10_000
KS = [k for k in (1, 10, 100, 1_000, 10_000) if k <= N]
DIST = ShiftedExp(1.0, 5.0)
SC = Scenario(DIST, Scaling.SERVER_DEPENDENT, N)
# with cancel-on-complete a job occupies the fleet for roughly one E[Y]
# regardless of k, so cluster saturation sits near 1/E[Y]; these fractions
# span idle -> heavy, where k* visibly retires diversity
lam_max = 1.0 / DIST.mean()
LOADS = [lam_max * f for f in (0.05, 0.5, 0.85)]
CHUNK = default_chunk(JOBS)

print("=" * 72)
print(f"1. k* vs load at n={N:,} ({JOBS:,} jobs/cell, chunk={CHUNK}, "
      f"streaming stats, device {args.device})")
print("=" * 72)
surface = fleet_sweep(SC, LOADS, ks=KS, num_jobs=JOBS, seed=0,
                      chunk_size=CHUNK, stream=True, device=args.device)
hdr = " ".join(f"k={k:<7,d}" for k in KS)
print(f"  {'load/max':>8s} | mean latency: {hdr}")
for i, lam in enumerate(surface.loads):
    row = " ".join(f"{surface.mean[i, j]:9.2f}" for j in range(len(KS)))
    print(f"  {lam / lam_max:8.2f} | {row}")
kstars = surface.kstar()
tails = surface.kstar(metric="p99")
for lam in surface.loads:
    print(f"  load {lam / lam_max:4.2f} x max:  mean-k* = "
          f"{kstars[lam]:>6,d}   p99-k* = {tails[lam]:>6,d}")

print()
print("=" * 72)
print("2. diurnal MMPP: day/night arrival phases at the same average rate")
print("=" * 72)
# switch ~ 1e-3 per job: phase dwells are thousands of jobs long — a
# day/night cycle, not jitter.  burst/slow average to ~1 x rate, so any
# k* shift vs Poisson is pure burst-piling, not extra traffic.
diurnal = MMPPArrivals(rate=1.0, slow=0.4, burst=1.6, switch=1e-3)
sc_day = Scenario(DIST, Scaling.SERVER_DEPENDENT, N, arrivals=diurnal)
day = fleet_sweep(sc_day, LOADS, ks=KS, num_jobs=JOBS, seed=0,
                  chunk_size=CHUNK, stream=True, device=args.device)
print(f"  {'load/max':>8s} | {'poisson p99-k*':>15s} | {'diurnal p99-k*':>15s}"
      f" | p99 inflation at that k")
for i, lam in enumerate(surface.loads):
    kp, kd = tails[lam], day.kstar(metric="p99")[lam]
    jp, jd = KS.index(kp), KS.index(kd)
    infl = day.p99[i, jd] / surface.p99[i, jp]
    print(f"  {lam / lam_max:8.2f} | {kp:15,d} | {kd:15,d} | {infl:9.2f}x")
print("\n  (all surfaces above ran in bounded memory: peak sampling state "
      f"is chunk x n = {CHUNK * N * 4 / 2**20:.0f} MB, never jobs x n = "
      f"{JOBS * N * 4 / 2**20:,.0f} MB)")
