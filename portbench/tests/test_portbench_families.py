"""Model families found by name (``portbench/families/<family>.py``).

The families the repository has read every number as they did before
they moved there: the layout, every drawn leaf bit for bit, the
reference's logits, row losses, training steps and decode, and the
counts, against ``families_recorded.json`` (sha256 of bytes, floats by
``float.hex``; recorded on an x86-64 CPU, whose BLAS sets the reference's
summation order).  A third family, ``ssm``, comes as new files of the
fixture root only, and its cells run through the harness (also
``test_portbench_harness`` and ``test_portbench_control``)."""
from __future__ import annotations

import ast
import hashlib
import json

import pytest
import torch

from conftest import FIXTURES, REPO
from portbench import counts, weights
from portbench.drivers.train_coded import alive_mask
from portbench.reference import model, serve, train
from portbench.reference.numerics import Numerics
from portbench.spec import family_of, program_config, spec_of

RECORDED = json.loads((REPO / "portbench" / "tests"
                       / "families_recorded.json").read_text())["readings"]


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def _config(name: str) -> dict:
    path = REPO / "portbench" / "configs" / f"{name}.json"
    if not path.exists():
        path = FIXTURES / "configs" / f"{name}.json"
    return json.loads(path.read_text())


def readings(name: str) -> dict:
    """What the reference and the counts read of configuration ``name``:
    at the fixture size and seed 5, or for qwen3-0.6b at the cells'
    shapes (five leaves drawn; the rest would take a minute on a CPU)."""
    s = spec_of(_config(name))
    shapes = weights.param_shapes(s)
    out = {"shapes": {k: list(v) for k, v in shapes.items()},
           "matmul_params": counts.matmul_params(s)}
    if name == "qwen3-0.6b":
        out["leaves"] = {n: _digest(weights.draw(s, n, shapes[n], 5, "cpu"))
                         for n in ("final_norm", "layers.q_norm", "layers.wk",
                                   "layers.wo", "layers.w_down")}
        out["flops_train"] = counts.model_flops(s, 4, 4096, True).hex()
        out["flops_prefill"] = counts.model_flops(s, 2, 32768, False).hex()
        out["decode_bytes"] = sum(counts.decode_bytes(s, 8, p)
                                  for p in range(32640, 32768)).hex()
        return out
    P = weights.draw_all(s, 5, "cpu")
    num = Numerics("fp32")
    toks = torch.randint(0, s.vocab, (2, 97),
                         generator=torch.Generator().manual_seed(3))
    lg = model.logits(num, P, model.hidden(s, num, P, toks[:, :-1]))
    loss = model.row_loss(s, num, P, toks[:, :-1], toks[:, 1:])
    mix = json.loads((FIXTURES / "traffic" / "tiny_train.json").read_text())
    steps = train.run_steps(s, mix, 5, lambda t: alive_mask(mix, 5, t), 2,
                            "cpu")
    out.update(
        leaves={k: _digest(v) for k, v in P.items()}, logits=_digest(lg),
        row_loss=[float(x).hex() for x in loss],
        steps={"losses": [x.hex() for x in steps["losses"]],
               "grad1": {k: v.hex() for k, v in steps["grad1"].items()},
               "change": {k: v.hex() for k, v in steps["change"].items()}},
        flops_train=counts.model_flops(s, 4, 96, True).hex(),
        flops_prefill=counts.model_flops(s, 2, 96, False).hex())
    if counts.decode_bytes(s, 2, 48) is not None:
        out["decode_bytes"] = [counts.decode_bytes(s, 2, p).hex()
                               for p in range(48, 64)]
        shape = (2, 64, s.kv_heads, s.head_dim)

        def prefix(layer):
            return tuple(weights.cache_layer(5, w, layer, shape,
                                             torch.bfloat16, "cpu")[:, :48]
                         for w in ("k", "v"))
        dl, k, v = serve.decode(s, P, toks[:, :6], 48, prefix)
        out["decode"] = {"logits": _digest(dl), "k": _digest(k),
                         "v": _digest(v)}
    return out


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-hybrid", "qwen3-0.6b"])
def test_moved_families_read_as_recorded(name):
    assert readings(name) == RECORDED[name]


def _files(base):
    return {p.relative_to(base): p.read_bytes()
            for p in base.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and p.suffix != ".pyc"}


def test_the_fixture_root_only_adds_files(root):
    """The fixture root's ``portbench/`` (the ssm family among its files)
    holds every file of the repository's, unchanged."""
    repo = {p: b for p, b in _files(REPO / "portbench").items()
            if p.parts[0] != "tests"}
    mine = _files(root / "portbench")
    assert {p: mine.get(p) for p in repo} == repo
    assert not (REPO / "portbench" / "families" / "ssm.py").exists()
    assert (root / "portbench" / "families" / "ssm.py") in \
        {root / "portbench" / p for p in set(mine) - set(repo)}


def _ssm(root):
    cfg = json.loads((root / "portbench" / "configs" / "tiny-ssm.json")
                     .read_text())
    return cfg, spec_of(cfg, root)


def test_the_ssm_family_is_found_under_the_fixture_root(root):
    cfg, s = _ssm(root)
    fam = family_of(s)
    assert fam.__name__ == "portbench.families.ssm"
    assert fam.__file__ == str(root / "portbench" / "families" / "ssm.py")
    assert s.heads == 0 and s.ssm_heads == 8 and s.d_inner == 128
    program_config(cfg, root)
    cfg = json.loads(json.dumps(cfg))
    cfg["program"]["overrides"]["ssm_state"] = 32
    with pytest.raises(ValueError, match="ssm_state"):
        program_config(cfg, root)


def test_ssm_counts(root):
    _, s = _ssm(root)
    mm = 3 * (2 * 64 * 128 + 2 * 64 * 16 + 64 * 8 + 128 * 64) + 64 * 512
    assert counts.matmul_params(s) == mm
    nc, tri = 96 // 16, 16 * 17 / 2
    scan = 2 * nc * (2 * tri * 16 + 8 * (2 * tri * 16 + 4 * 16 * 16 * 16))
    assert counts.model_flops(s, 2, 96, False) == pytest.approx(
        2 * mm * 2 * 96 + 3 * scan, rel=1e-12)
    assert counts.decode_bytes(s, 2, 48) is None


def _fp32(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["run"]["compute_dtype"] = "float32"
    cfg["program"]["overrides"]["compute_dtype"] = "float32"
    return cfg


def test_ssm_reference_matches_the_program(root):
    """The fixture family's reference against the program's mamba2-1.3b,
    both in fp32: the forward's logits and the first training steps."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.runtime.coded_step import CodedStepConfig, CodedTrainer
    cfg, _ = _ssm(root)
    cfg = _fp32(cfg)
    s, pcfg = spec_of(cfg, root), program_config(cfg, root)
    m = api.build(pcfg, "cpu")
    weights.fill(m, s, 5)
    toks = torch.randint(0, s.vocab, (2, 96),
                         generator=torch.Generator().manual_seed(3))
    got = api.forward(pcfg, m, toks)
    P = weights.draw_all(s, 5, "cpu")
    num = Numerics("fp32")
    want = model.logits(num, P, model.hidden(s, num, P, toks))
    assert torch.allclose(got, want, rtol=1e-4,
                          atol=1e-4 * float(want.abs().max()))

    mix = json.loads((FIXTURES / "traffic" / "tiny_train.json").read_text())
    mix["optimizer"]["warmup_steps"] = 1
    m = api.build(pcfg, "cpu", trainable=True)
    weights.fill(m, s, 77)
    opt_cfg = adamw.AdamWConfig(**mix["optimizer"])
    opt = adamw.init(opt_cfg, m)
    trainer = CodedTrainer(
        pcfg, DataConfig(s.vocab, mix["seq_len"], mix["unique_rows"], 77),
        CodedStepConfig(mix["n_workers"], mix["c"], mix["unique_rows"]),
        opt_cfg, alive_fn=lambda t: alive_mask(mix, 77, t))
    losses = []
    for step in range(3):
        m, opt, metrics = trainer.run_step(m, opt, step)
        losses.append(float(metrics["loss"]))
    ref = train.run_steps(s, mix, 77, lambda t: alive_mask(mix, 77, t), 3,
                          "cpu")
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    shapes = weights.param_shapes(s)
    for n, p in m.named_parameters():
        change = float((p - weights.draw(s, n, shapes[n], 77, "cpu")).norm())
        assert change == pytest.approx(ref["change"][n], rel=1e-3, abs=1e-9)


def test_a_family_law_draws_a_leaf_of_its_own(root, monkeypatch):
    _, s = _ssm(root)

    def zeros(spec, shape, g, device):
        return torch.zeros(shape, device=device)
    monkeypatch.setattr(family_of(s), "LAWS", {"out_proj": zeros},
                        raising=False)
    assert not weights.draw(s, "layers.out_proj", (3, 128, 64), 5,
                            "cpu").any()
    assert weights.draw(s, "layers.wz", (3, 64, 128), 5, "cpu").any()


def _family_words() -> set:
    """The families' names and leaves, but the roles every layout has
    (embedding, final norm, head) and those ``weights.draw`` draws by a
    law of their own (a norm, by its name's end)."""
    leaves = set()
    for name in ("tiny-dense", "tiny-hybrid"):
        s = spec_of(_config(name))
        leaves |= {n.split(".")[-1] for n in weights.param_shapes(s)}
        leaves.add(s.family)
    return leaves - {"embed", "final_norm", "lm_head", "norm", "A_log",
                     "D", "dt_bias"}


def test_only_the_families_name_a_family_or_its_leaves():
    words = _family_words()
    assert {"dense", "hybrid", "wq", "wz", "w_gate", "attn_norm"} <= words
    base = REPO / "portbench"
    for path in base.rglob("*.py"):
        if path.relative_to(base).parts[0] in ("families", "tests"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                assert node.value not in words and \
                    "shared_attn" not in node.value, (path, node.value)


def test_families_import_nothing_of_the_program():
    for path in (REPO / "portbench" / "families").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax", "jaxlib", "flax"), \
                    (path.name, n)

