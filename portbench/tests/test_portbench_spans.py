"""The span metrics read through the harness as it stands: a fixture
train cell and a fixture decode cell run traced on the CPU, with the
span metrics' entries given those cells (as the fixture metric's entry
is added); the host-clock one reads finite and positive, the
device-clock ones nothing off the card, as the other device readers,
and the totals they name move over the stretch.  Over a program that
keeps no span totals they name no counter and read nothing, and a
measured window runs with no recorder installed."""
from __future__ import annotations

import json
import math

import pytest

from conftest import cell_name, make_root, run_cell
from portbench import spans

#: each span metric -> the fixture traffic of its kind
SPAN_METRICS = {"trainer_host_ms.train": "tiny_train",
                "adamw_ms.train": "tiny_train",
                "flash_bwd_ms.train": "tiny_train",
                "decode_attn_ms.decode": "tiny_decode"}
ON_HOST = {"trainer_host_ms.train"}
#: the spans of a unit of each fixture traffic, per layer or per unit
UNIT_SPANS = {"tiny_train": ("attn.flash_bwd", "coded.step"),
              "tiny_decode": ("attn.decode_row", "decode.step")}


@pytest.fixture(scope="module")
def span_root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("spans"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS:
            m["workloads"].append(cell_name("tiny-dense",
                                            SPAN_METRICS[m["name"]]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(autouse=True)
def no_recorder_left():
    """The span metrics install the process's recorder when loaded: each
    test starts without one and leaves none behind."""
    from repro_torch.obs import recorder
    assert recorder.active() is None
    yield
    recorder.uninstall()


@pytest.mark.parametrize("traffic", ["tiny_train", "tiny_decode"])
def test_span_metrics_read_in_a_traced_run(span_root, traffic):
    from portbench import harness
    from repro_torch.obs import recorder
    result = run_cell(span_root, cell_name("tiny-dense", traffic),
                      trace=True).result
    assert result["correct"], result["checks"]
    assert recorder.active() is not None
    # the spans recorded, read by the paths the readers name
    per_layer, per_unit = (harness.read_counter(
        f"{spans.TOTALS}.{n}.count") for n in UNIT_SPANS[traffic])
    assert per_unit > 0 and per_layer == 2 * per_unit
    mine = {m for m, t in SPAN_METRICS.items() if t == traffic}
    got = set(result["metrics"]) & set(SPAN_METRICS)
    assert got == mine & ON_HOST
    for name in got:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
        assert result["metrics"][name]["unit"] == "ms"


def test_a_measured_window_runs_untraced(span_root):
    from repro_torch.obs import recorder
    result = run_cell(span_root, cell_name("tiny-dense", "tiny_decode"),
                      trace=False).result
    assert result["correct"]
    assert recorder.active() is None
    assert not set(result["metrics"]) & set(SPAN_METRICS)


def test_a_program_without_span_totals_reads_nothing(span_root,
                                                     monkeypatch):
    from repro_torch.obs import recorder
    monkeypatch.delattr(recorder, "SPANS")
    assert spans.counters(step="decode.step.host_ns") == {}
    for traffic in ("tiny_train", "tiny_decode"):
        result = run_cell(span_root, cell_name("tiny-dense", traffic),
                          trace=True).result
        assert result["correct"]
        assert not set(result["metrics"]) & set(SPAN_METRICS)
    assert recorder.active() is None
