"""A decode cell's two stretches beside its window: ``paced_units`` steps
run untraced as the window runs them, before a traced stretch, for the
wall-clock readers; ``profiled_units`` steps profiled once the window has
closed, for the device's time a step.  Run on the CPU with a session that
only counts its units, and with readers given a trace as the card's."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import cell_name, run_cell
from portbench import harness, timing
from portbench.drivers import Window


class Counting:
    work_per_unit = 3

    def __init__(self):
        self.remaining = []
        self.stretches = []

    def unit(self, remaining=None):
        self.remaining.append(remaining)

    def run_units(self, n):
        self.stretches.append(n)


@pytest.mark.parametrize("units", [2, 5])
def test_a_window_of_units_runs_that_many_and_passes_no_time(units):
    s = Counting()
    win = harness.window(s, True, None, torch.device("cpu"), units=units)
    assert win.units == len(s.remaining) == units
    assert s.remaining == [None] * units
    assert win.work == 3 * units and len(win.gaps) == units


def test_a_timed_window_passes_the_time_still_to_run():
    s = Counting()
    win = harness.window(s, True, 0.05, torch.device("cpu"))
    assert win.units >= 2 and win.seconds >= 0.05
    assert all(r is not None and r <= 0.05 for r in s.remaining)


def _card_trace(busy_s=0.28, span_s=1.5):
    return timing.Trace(span_s, [("split_kernel", busy_s, 448)], [])


class Stretches:
    """``timing.busy`` as the card's profiler reads it: each stretch's
    (seconds, operations), in turn."""

    def __init__(self, readings):
        self.readings = list(readings)

    def __call__(self, fn, device):
        fn()
        return self.readings.pop(0)


@pytest.mark.parametrize("readings, want", [
    # two alike at once
    ([(0.2660, 44656), (0.2652, 44656)], (0.2660 + 0.2652) / 32),
    # one lost records and reads low: passed over
    ([(0.2630, 44311), (0.2660, 44656), (0.2652, 44656)],
     (0.2660 + 0.2652) / 32),
    # no two alike in four tries: the one with the most
    ([(0.2630, 44311), (0.2640, 44500), (0.2650, 44600), (0.2600, 44000)],
     0.2650 / 16),
])
def test_device_time_takes_two_stretches_that_count_alike(
        monkeypatch, readings, want):
    monkeypatch.setattr(timing, "busy", Stretches(readings))
    s = Counting()
    assert harness.device_time(s, 16, torch.device("cuda")) == \
        pytest.approx(want)
    assert s.stretches == [16] * len(readings)


def _ctx(trace, paced, kind="decode"):
    return harness.TraceContext(kind, None, {}, 16, {}, trace, {}, paced)


@pytest.mark.parametrize("metric", ["wall_tokens_per_s.decode",
                                    "wall_step_p90_ms.decode"])
def test_wall_readers_read_the_paced_stretch(root, metric):
    r = harness.reader(root, metric)
    gaps = [0.040 + 0.001 * i for i in range(20)]
    paced = Window(21, 0, 168, 1.0, gaps)
    want = {"wall_tokens_per_s.decode": 168.0,
            "wall_step_p90_ms.decode": paced.gap_quantile_ms(90)}[metric]
    assert r.read(_ctx(_card_trace(), paced)) == pytest.approx(want)
    assert 40 < paced.gap_quantile_ms(90) < 60
    # nothing to read: no paced stretch, another kind, or off the card
    assert r.read(_ctx(_card_trace(), None)) is None
    assert r.read(_ctx(_card_trace(), paced, "train")) is None
    off = timing.Trace(1.0, [], [], on_device=False)
    assert r.read(_ctx(off, paced)) is None


def test_the_decode_cell_reads_its_device_time_from_the_profiled_stretch(
        root):
    out = run_cell(root, cell_name("tiny-dense", "tiny_decode"))
    result = out.result
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"decode_device_ms_per_step",
                                      "setup_s"}
    assert result["metrics"]["decode_device_ms_per_step"]["value"] > 0
    # two profiled stretches ran after the window (on the CPU they count
    # alike, no operation each), and the judged steps are the newest
    mix = json.loads((root / "portbench/traffic/tiny_decode.json")
                     .read_text())
    assert out.session.n == (mix["warmup_units"] + result["attempted"]
                             + 2 * mix["profiled_units"])
