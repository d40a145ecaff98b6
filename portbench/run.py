"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: BENCHMARK.json names the cell.  Set-up
(``setup_s``, from the start of this process) draws the weights, caches
and inputs from ``--seed`` on the card, builds or loads the program's
kernels under ``build/`` in the checkout and warms up the cell's shapes;
then ``--trace 0`` measures for ``--seconds`` and reports the cell's
end-to-end metrics, ``--trace 1`` profiles a steady stretch and reports
its per-layer metrics.  Then the plain reference checks what the timed
path produced.  The last line on standard output is the result; the
numbers compared and their limits are the last lines on standard error.
Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded, it exits with 1 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda").sum().item()
    print(f"setup: imports and CUDA context {time.perf_counter() - T0:.2f} s",
          file=sys.stderr)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out = harness.run(ROOT, bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T0)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"refused: loaded modules with top-level names {found}",
              file=sys.stderr)
        return 1
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        card = f"nvidia-smi not read: {exc}"
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", file=sys.stderr)
    for name, value, limit in out.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
