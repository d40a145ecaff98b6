"""Shared helpers of the benchmark's tests: a benchmark root in a
temporary directory, the repository's ``portbench`` and ``BENCHMARK.json``
with the fixture files (tiny configurations, mixes, a traffic kind's
driver, a metric) and their entries added beside them, run on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FIXTURES = Path(__file__).resolve().parent / "fixtures"
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the fixture cells: (config, traffic) -> the limits of its numbers,
#: set from the CPU's readings at these sizes over seeds 1, 2, 3, 7 and
#: 12345: the program's bf16 below, the fp8 control and the faults above
FIXTURE_CELLS = {
    ("tiny-dense", "tiny_train"): {"loss_gap": 0.002, "grad_gap": 0.01,
                                   "change_gap": 0.005,
                                   "last_grad_gap": 0.012,
                                   "last_change_gap": 0.0012},
    ("tiny-hybrid", "tiny_train"): {"loss_gap": 0.002, "grad_gap": 0.03,
                                    "change_gap": 0.007,
                                    "last_grad_gap": 0.03,
                                    "last_change_gap": 0.0025},
    ("tiny-dense", "tiny_decode"): {"token_gap": 0.1, "cache_err": 0.05},
    ("tiny-hybrid", "tiny_prefill"): {"token_gap": 0.3, "logit_err": 0.08},
    ("tiny-dense", "tiny_score"): {"score_gap": 0.0011},
    ("tiny-ssm", "tiny_train"): {"loss_gap": 0.002, "grad_gap": 0.03,
                                 "change_gap": 0.01, "last_grad_gap": 0.03,
                                 "last_change_gap": 0.002},
    ("tiny-ssm", "tiny_prefill"): {"token_gap": 0.18, "logit_err": 0.08},
}


def cell_name(config: str, traffic: str) -> str:
    return f"{config}.{traffic}"


def make_root(tmp: Path) -> Path:
    """A benchmark root holding the repository's files and the fixtures,
    added as new files and entries only."""
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for kind in ("configs", "traffic", "metrics", "drivers", "families"):
        for f in (FIXTURES / kind).iterdir():
            shutil.copy(f, root / "portbench" / kind / f.name)
    for f in (FIXTURES / "configs").iterdir():
        cfg = json.loads(f.read_text())
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                 "file": f"portbench/configs/{f.name}",
                                 "reduced": cfg["reduced"], "why": "fixture"})
    for (config, traffic), limits in FIXTURE_CELLS.items():
        name = cell_name(config, traffic)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "fixture"})
        (root / "portbench" / "limits" / f"{name}.json").write_text(
            json.dumps({"limits": limits}))
    bench["end_to_end"].append({"name": "score_tokens_per_s",
                                "unit": "tokens/s", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": []})
    bench["per_layer"].append({"name": "units.train", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "the model step",
                               "moves": "train_tokens_per_s"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [cell_name(c, t) for c, t in FIXTURE_CELLS
                               if _reports(t, m["name"])]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _reports(traffic: str, metric: str) -> bool:
    return metric.split("_")[0] in traffic


@pytest.fixture(scope="session")
def root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))


def run_cell(root: Path, name: str, seed: int = 12345, trace: bool = False,
             faults=()):
    """The harness's ``Outcome`` of one run of a cell on the CPU."""
    import torch
    from portbench import harness
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return harness.run(root, bench, name, seed, 0.2, trace,
                       torch.device("cpu"), time.perf_counter(), faults)
