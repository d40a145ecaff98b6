"""Readings of one cell's compared numbers over many seeds in one process:
the program (a run of the cell with a short window), the control (the
reference one precision lower in the program's place) and planted
faults.  The limits are set from these readings (PERF.md).

    python3 portbench/tools/readings.py --workload <cell> \
        --seeds 101,102,... [--control 3] [--faults frozen,half_batch] \
        [--seconds 2] [--out readings.jsonl]

One JSON line a reading on standard output (and appended to ``--out``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="the control's readings on the first N seeds")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = [(s, (), i < args.control) for i, s in enumerate(seeds)]
    jobs += [(seeds[i % len(seeds)], (f,), False)
             for f in filter(None, args.faults.split(","))
             for i in range(3)]
    sink = open(args.out, "a") if args.out else None
    start = T0
    for seed, faults, control in jobs:
        box = {}
        out = harness.run(ROOT, bench, args.workload, seed, args.seconds,
                          False, device, start, faults)
        if control:
            t = time.perf_counter()
            box["control"] = out.session.control_numbers(out.outputs,
                                                         out.ref)
            box["control_s"] = time.perf_counter() - t
        result = out.result
        del out
        line = {"workload": args.workload, "seed": seed,
                "faults": list(faults), "correct": result["correct"],
                "program": {k: v["value"]
                            for k, v in result["checks"].items()},
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - start, **box}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.empty_cache()
        start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
