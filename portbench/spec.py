"""A configuration file's sizes as the reference and the counts read them.

The file holds the model's published keys as run (``hidden_size``,
``num_hidden_layers``, ...) and a ``run`` object with what the published
keys do not say about the port's model: its ``family`` and what that
family reads besides.  A family is a module of its own,
``portbench/families/<family>.py`` under the benchmark's root, found by
that name as drivers and metric readers are found by theirs; it gives
the spec, the layout, the reference's forward and the counts
(``families/__init__.py``).  ``program_config`` builds the program's own
``ModelConfig`` from the file's ``program`` entry and refuses one whose
sizes differ from the file's.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

#: the benchmark root this package lies in
ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Spec:
    """What every family has; a family's spec adds its own fields."""
    family: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    rope_theta: float
    window: int = 0

    @property
    def vocab_pad(self) -> int:
        return (self.vocab + 127) // 128 * 128


def common(config: dict) -> dict:
    """The common fields of a file in the published keys of a decoder with
    attention (qwen3's, zamba2's)."""
    run = config["run"]
    d, heads = config["hidden_size"], config["num_attention_heads"]
    return dict(
        family=run["family"],
        layers=config["num_hidden_layers"],
        d=d,
        heads=heads,
        kv_heads=config["num_key_value_heads"],
        head_dim=run.get("attn_head_dim", config.get("head_dim",
                                                      d // heads)),
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
        eps=config["rms_norm_eps"],
        rope_theta=float(config["rope_theta"]),
        window=run.get("attn_window", 0),
    )


def by_name(root: Path, folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py`` under ``root``, loaded
    once a process as ``portbench.<folder>.<name>``."""
    module = f"portbench.{folder}.{name}"
    if module not in sys.modules:
        path = root / "portbench" / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(module, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module] = mod
        spec.loader.exec_module(mod)
    return sys.modules[module]


def family(name: str, root: Path = ROOT):
    """The module of model family ``name``."""
    return by_name(root, "families", name)


def family_of(s: Spec):
    """The module of the family that made spec ``s``."""
    return sys.modules[type(s).__module__]


def spec_of(config: dict, root: Path = ROOT) -> Spec:
    return family(config["run"]["family"], root).spec_of(config)


def program_config(config: dict, root: Path = ROOT):
    """The program's ``ModelConfig`` for ``config``: its registered
    architecture with the file's ``program.overrides``, checked against
    the file's sizes (the family's ``program_checks``)."""
    from repro_torch.configs import get_config
    prog, run = config["program"], config["run"]
    cfg = get_config(prog["arch"])
    if prog.get("overrides"):
        cfg = cfg.scaled(**prog["overrides"])
    want = family(run["family"], root).program_checks(
        spec_of(config, root), run)
    want.update(param_dtype=run["param_dtype"],
                compute_dtype=run["compute_dtype"], remat=run["remat"])
    got = {k: getattr(cfg, k) for k in want}
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if wrong:
        raise ValueError(f"the program's {prog['arch']} differs from "
                         f"{config['name']}'s file (program, file): {wrong}")
    return cfg
