"""Every span of a cell's traced stretch, by name: how many a unit, and
host and device time a unit, in all and self (less what the span's
children cover), from the program's flight recorder.

    python3 portbench/tools/span_table.py --workload <cell> --seed <n>

On the card: the cell is built and warmed up as the benchmark's run does;
then a recorder is installed and the mix's ``trace_units`` units run
under the profiler as in a traced run.  One JSON line a span name, then
one with the stretch's span and busy seconds.  No reference check: it
reads, it does not judge.
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
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness, timing
    from repro_torch.obs import recorder, report
    if not torch.cuda.is_available():
        print("the span table needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(ROOT, bench, args.workload)
    mod = harness.driver(ROOT, cell.mix["kind"])
    session = mod.Session(cell, args.seed, device)
    session.build()
    session.warm()
    timing.sync(device)
    units = cell.mix["trace_units"]
    with recorder.recording() as rec:
        tr = timing.profile(lambda: session.run_units(units), device)
    lines = []
    for name, row in sorted(report.span_table(rec.events()).items()):
        lines.append({"span": name, "per_unit": row["n"] / units,
                      **{f"{k}_ms": None if row[k] is None
                         else row[k] * 1e3 / units
                         for k in ("host", "host_self", "device",
                                   "device_self")}})
    lines.append({"workload": args.workload, "seed": args.seed,
                  "units": units, "span_s": tr.span_s, "busy_s": tr.busy_s,
                  "dropped": rec.dropped,
                  "device": torch.cuda.get_device_name(device)})
    for line in lines:
        print(json.dumps(line), flush=True)
    session.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
