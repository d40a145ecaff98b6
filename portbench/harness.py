"""One run of one cell: set-up, the measured window or the traced
stretch, the check against the reference, and the result line.

Everything a cell names is found by name under the benchmark's root:
the configuration file ``BENCHMARK.json`` gives and its model family
(``portbench/families/<family>.py``), ``portbench/traffic/
<traffic>.json``, the driver of the mix's ``kind`` (``portbench/drivers/
<kind>.py``), ``portbench/limits/<cell>.json`` and, for a traced run, each
per-layer metric's reader ``portbench/metrics/<name>.py``, with the
program's counters that reader names.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import timing
from .drivers import Window
from .faults import planted
from .spec import Spec, by_name, spec_of


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: Dict[str, float]
    chips: int
    root: Path

    @property
    def spec(self) -> Spec:
        return spec_of(self.config, self.root)


def load_cell(root: Path, bench: dict, name: str) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic"
                      / f"{entry['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits"
                         / f"{name}.json").read_text())
    return Cell(name, config, mix, limits["limits"], entry["chips"], root)


def driver(root: Path, kind: str):
    """The driver of a traffic kind: ``portbench/drivers/<kind>.py``."""
    return by_name(root, "drivers", kind)


def reader(root: Path, metric: str):
    """The module of a per-layer metric: ``read(ctx)`` and, where it reads
    the program's counters, ``COUNTERS``: {name: "module:attribute.path"}."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_counter(path: str) -> int:
    """The program's counter at ``module:attribute.path``."""
    module, attrs = path.split(":")
    obj = importlib.import_module(module)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader reads: the cell's kind and sizes,
    the units of work in the traced stretch and what the driver says of
    them, the profiler's trace and the counters the readers name, each
    as it moved over the stretch; where the mix names ``paced_units``,
    that many units run untraced, as the window runs them, just before
    the traced stretch."""
    kind: str
    spec: Spec
    mix: dict
    units: int
    info: dict
    trace: timing.Trace
    counters: Dict[str, int]
    paced: Optional[Window] = None


@dataclasses.dataclass
class Outcome:
    result: dict            # the result line
    checks: List[tuple]     # (name, value, limit) of the numbers compared
    session: object         # the driver's session, its program freed
    outputs: dict           # what the timed path produced, as judged
    ref: dict               # the reference's readings of the same


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def window(session, sync_each: bool, seconds: Optional[float],
           device: torch.device, units: Optional[int] = None) -> Window:
    """Units back to back until the first completes at or after
    ``seconds`` (or, with ``units``, until that many have run; at least
    two, so that there is a gap): all the work over all the window's time,
    and the device clock's gaps between consecutive completions."""
    marks = timing.Marks(device)
    marks.mark()
    t0 = time.perf_counter()
    values = []
    while True:
        values.append(session.unit(
            None if units else seconds - (time.perf_counter() - t0)))
        marks.mark()
        if sync_each:
            timing.sync(device)
        else:
            marks.wait_previous()
        done = len(values) >= units if units else \
            time.perf_counter() - t0 >= seconds
        if done and len(values) >= 2:
            break
    timing.sync(device)
    elapsed = time.perf_counter() - t0
    times = marks.seconds()
    failed = sum(not math.isfinite(float(v)) for v in values
                 if v is not None)
    return Window(len(values), failed, len(values) * session.work_per_unit,
                  elapsed, [b - a for a, b in zip(times, times[1:])])


def device_time(session, units: int, device: torch.device,
                tries: int = 4) -> float:
    """The device's busy time a unit, once the window has closed:
    stretches of ``units`` units profiled one after another until two
    count the same number of device operations, and the mean of those
    two.  The profiler's trace loses some tens of a decode stretch's
    ~45,000 operations now and then (its collecting thread falls behind),
    and a stretch that lost some reads low; two that count alike lost
    none.  With no two alike after ``tries``, the stretch with the most."""
    seen = {}
    for _ in range(tries):
        busy_s, ops = timing.busy(lambda: session.run_units(units), device)
        if ops in seen:
            return (busy_s + seen[ops]) / (2 * units)
        seen[ops] = busy_s
    print(f"device time: no two of {tries} stretches counted alike "
          f"({sorted(seen)} operations); the most", file=sys.stderr)
    return seen[max(seen)] / units


def traced(root: Path, bench: dict, cell: Cell, mod, session,
           device: torch.device) -> tuple:
    """(metrics, device readings, breakdown) of a profiled stretch of
    ``trace_units`` units."""
    readers = {m["name"]: (m, reader(root, m["name"]))
               for m in bench["per_layer"] if _applies(m, cell.name)}
    paths = {k: p for _, r in readers.values()
             for k, p in getattr(r, "COUNTERS", {}).items()}
    paced = None
    if cell.mix.get("paced_units"):
        paced = window(session, mod.SYNC_EACH, None, device,
                       units=cell.mix["paced_units"])
    before = {k: read_counter(p) for k, p in paths.items()}
    box = {}

    def stretch():
        box["info"] = session.run_units(cell.mix["trace_units"])
    tr = timing.profile(stretch, device)
    if tr is None:
        raise RuntimeError("the profiler saw no device time")
    ctx = TraceContext(mod.KIND, cell.spec, cell.mix,
                       cell.mix["trace_units"], box["info"], tr,
                       {k: read_counter(p) - before[k]
                        for k, p in paths.items()}, paced)
    metrics = {}
    for name, (m, r) in readers.items():
        value = r.read(ctx)
        if value is not None:
            metrics[name] = _metric(value, m["unit"])
    breakdown = {"device_ops": [[k[0][:160], k[1]] for k in tr.kernels[:10]],
                 "idle_gaps": [list(g) for g in tr.gaps]}
    return metrics, {"busy_s": tr.busy_s, "window_s": tr.span_s}, breakdown


def run(root: Path, bench: dict, name: str, seed: int, seconds: float,
        trace: bool, device: torch.device, t0: float,
        faults=()) -> Outcome:
    """One run of cell ``name``.  ``faults`` (``portbench.faults``' names)
    break the timed path underneath: the readings that show the check
    fails them, never a run of the benchmark's command."""
    cell = load_cell(root, bench, name)
    mod = driver(root, cell.mix["kind"])
    session = mod.Session(cell, seed, device)
    broken = planted(faults, mod.KIND)
    session.build()
    timing.sync(device)
    ready = time.perf_counter()
    for fault in broken:
        if not fault.late:
            fault.plant(session)
    session.warm()
    for fault in broken:
        if fault.late:
            fault.plant(session)
    timing.sync(device)
    setup_s = time.perf_counter() - t0
    print(f"setup: {setup_s:.2f} s in all; program and weights ready at "
          f"{ready - t0:.2f} s, then the warm-up", file=sys.stderr)
    dev: dict = {"platform": "gpu" if device.type == "cuda" else "cpu",
                 "kind": torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu",
                 "count": 1}
    breakdown = None
    if trace:
        metrics, readings, breakdown = traced(root, bench, cell, mod,
                                              session, device)
        dev.update(readings)
        attempted, failed = cell.mix["trace_units"], 0
    else:
        win = window(session, mod.SYNC_EACH, seconds, device)
        attempted, failed = win.units, win.failed
        if cell.mix.get("profiled_units"):
            win.device_s_per_unit = device_time(
                session, cell.mix["profiled_units"], device)
        g = sorted(win.gaps)
        print(f"window: {win.units} units in {win.seconds:.3f} s; a unit "
              f"{g[0]:.4f} / {g[len(g) // 2]:.4f} / {g[-1]:.4f} s (least "
              f"/ median / most)", file=sys.stderr)
        values = mod.end_to_end(win)
        values["setup_s"] = setup_s
        metrics = {m["name"]: _metric(values[m["name"]], m["unit"])
                   for m in bench["end_to_end"]
                   if _applies(m, name) and m["name"] in values}
    outputs = session.judged()
    if device.type == "cuda":
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        dev["memory_peak_bytes"] = 0
    for fault in broken:
        fault.remove()
    session.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = session.reference(outputs)
    numbers = session.numbers(outputs, ref)
    checks = [(k, numbers[k], cell.limits[k]) for k in cell.limits]
    correct = failed == 0 and all(math.isfinite(v) and v <= lim
                                  for _, v, lim in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a non-finite number as its name: the line stays valid JSON
    result["checks"] = {k: {"value": v if math.isfinite(v) else repr(v),
                            "limit": lim} for k, v, lim in checks}
    return Outcome(result, checks, session, outputs, ref)


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))
