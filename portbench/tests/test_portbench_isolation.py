"""What the benchmark loads and where it writes: no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared
whole), and files only inside the checkout, ``HOME``, ``XDG_CACHE_HOME``
and ``TMPDIR``."""
from __future__ import annotations

import os
import subprocess
import sys

from conftest import REPO, make_root
from portbench.harness import forbidden_modules

LOADS = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
from portbench import harness
import json
from pathlib import Path
root = Path({root!r})
bench = json.loads((root / "BENCHMARK.json").read_text())
for cell in ("tiny-dense.tiny_train", "tiny-dense.tiny_decode",
             "tiny-hybrid.tiny_prefill"):
    harness.run(root, bench, cell, 5, 0.1, False, torch.device("cpu"),
                time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.models",
                              "jax_like", "reprox"]) == []
    assert forbidden_modules(["repro.core", "jax", "jaxlib.xla_client",
                              "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                 "repro"]


def test_a_run_loads_no_jax_and_writes_only_where_it_may(tmp_path):
    root = make_root(tmp_path)
    for d in ("home", "cache", "tmp"):
        (tmp_path / d).mkdir()
    env = dict(os.environ, HOME=str(tmp_path / "home"),
               XDG_CACHE_HOME=str(tmp_path / "cache"),
               TMPDIR=str(tmp_path / "tmp"))
    env.pop("PYTHONPATH", None)
    before = {p for p in tmp_path.rglob("*")}
    # /dev/shm only: other processes of the machine write to /tmp
    shared = {d: set(os.listdir(d)) for d in ("/dev/shm",)
              if os.path.isdir(d)}
    out = subprocess.run(
        [sys.executable, "-c", LOADS.format(root=str(root),
                                            src=str(REPO / "src"))],
        env=env, capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = eval(out.stdout.strip().splitlines()[-1])
    assert forbidden_modules(loaded) == [], loaded
    allowed = [root, tmp_path / "home", tmp_path / "cache", tmp_path / "tmp"]
    for p in set(tmp_path.rglob("*")) - before:
        assert any(a == p or a in p.parents for a in allowed), p
    for d, names in shared.items():
        new = {n for n in set(os.listdir(d)) - names
               if not n.startswith("pytest-of-")}
        assert not new, (d, new)
