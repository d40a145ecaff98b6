"""The harness is driven by data: fixture cells, configurations, mixes,
a traffic kind's driver and a metric that names the program's counter
it reads, added as new files and entries only, run at a tiny size on the
CPU path; the result line has the contract's keys, and the numbers
compared come last.  The device path (``run.py`` on the card) is marked
``gpu`` and skips without one."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import FIXTURE_CELLS, REPO, cell_name, run_cell

CELLS = [cell_name(c, t) for c, t in FIXTURE_CELLS]


@pytest.mark.parametrize("name", CELLS)
def test_fixture_cell_runs_correct_with_its_end_to_end_metrics(root, name):
    out = run_cell(root, name)
    result, checks = out.result, out.checks
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or name in m["workloads"]}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert [c[0] for c in checks] == list(result["checks"])


def test_fixture_metric_reads_in_a_traced_run(root):
    result = run_cell(root, cell_name("tiny-dense", "tiny_train"),
                      trace=True).result
    # device metrics read nothing on the CPU; the fixture counter does
    assert set(result["metrics"]) == {"units.train"}
    assert result["metrics"]["units.train"]["value"] == 1.0
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_same_seed_same_inputs(root):
    import torch
    from portbench import weights
    from portbench.drivers.train_coded import alive_mask
    from portbench.harness import load_cell
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = load_cell(root, bench, cell_name("tiny-dense", "tiny_decode"))
    seed = 2 ** 31 + 12345                   # larger than 32 signed bits
    for name, shape in weights.param_shapes(cell.spec).items():
        a = weights.draw(cell.spec, name, shape, seed, "cpu")
        assert torch.equal(a, weights.draw(cell.spec, name, shape, seed,
                                           "cpu"))
        if not name.endswith("norm"):
            assert not torch.equal(a, weights.draw(cell.spec, name, shape,
                                                   seed + 1, "cpu"))
    one = weights.cache_layer(seed, "k", 1, (2, 8, 2, 16), torch.bfloat16,
                              "cpu")
    assert torch.equal(one, weights.cache_layer(seed, "k", 1, (2, 8, 2, 16),
                                                torch.bfloat16, "cpu"))
    mix = json.loads((root / "portbench/traffic/tiny_train.json")
                     .read_text())
    masks = [alive_mask(mix, seed, s) for s in range(50)]
    assert all((m == alive_mask(mix, seed, s)).all()
               for s, m in enumerate(masks))


def _run_py(cwd, *args, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_without_a_card_run_exits_nonzero_with_no_result(root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    out = _run_py(REPO, "--workload", "qwen3-0.6b.decode_32k", "--seed",
                  "2147483999", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_run_exits_nonzero(tmp_path):
    (tmp_path / "portbench").mkdir()
    import shutil
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = _run_py(tmp_path, "--workload", "qwen3-0.6b.decode_32k", "--seed",
                  "1", "--seconds", "1", "--trace", "0", env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_device_path_runs_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run_py(REPO, "--workload", "qwen3-0.6b.decode_32k", "--seed",
                  "2147483998", "--seconds", "3", "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
