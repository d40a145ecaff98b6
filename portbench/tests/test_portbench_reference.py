"""The plain reference against the program (``repro_torch``) on the CPU
at a tiny size, both in fp32: the forward's logits, the coded batch and
its decode weights, the first training steps, and decode over a drawn
cache prefix.  The reference itself imports nothing of the program."""
from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from conftest import FIXTURES
from portbench import weights
from portbench.reference import data, model, serve, train
from portbench.reference.numerics import Numerics
from portbench.spec import program_config, spec_of


def fp32(name: str) -> dict:
    cfg = json.loads((FIXTURES / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["run"]["compute_dtype"] = "float32"
    cfg["program"]["overrides"]["compute_dtype"] = "float32"
    return cfg


def program(cfg: dict, seed: int, trainable: bool = False):
    from repro_torch.models import api
    m = api.build(program_config(cfg), "cpu", trainable=trainable)
    weights.fill(m, spec_of(cfg), seed)
    return m


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-hybrid"])
def test_forward_logits_match_the_program(name):
    from repro_torch.models import api
    cfg = fp32(name)
    spec, pcfg = spec_of(cfg), program_config(cfg)
    toks = torch.randint(0, spec.vocab, (2, 96),
                         generator=torch.Generator().manual_seed(3))
    got = api.forward(pcfg, program(cfg, 5), toks)
    P = weights.draw_all(spec, 5, "cpu")
    num = Numerics("fp32")
    want = model.logits(num, P, model.hidden(spec, num, P, toks))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(
        want.abs().max()))


def test_coded_batch_and_weights_match_the_program():
    from repro_torch.core.coding import (FractionalRepetitionCode,
                                         gc_decode_weights)
    from repro_torch.data.pipeline import (DataConfig, coded_batch,
                                           expand_worker_weights)
    code = FractionalRepetitionCode(n=4, c=2)
    dcfg = DataConfig(vocab_size=512, seq_len=64, global_batch=2,
                      seed=2147483901)
    for step, alive in enumerate([[1, 1, 1, 1], [0, 1, 1, 0],
                                  [0, 0, 1, 1], [1, 0, 0, 0]]):
        alive = np.array(alive, bool)
        toks, labs, w = data.coded_rows(512, 64, 2, 4, 2, 2147483901, step,
                                        alive)
        ptoks, plabs = coded_batch(dcfg, step, code)
        assert np.array_equal(toks, ptoks) and np.array_equal(labs, plabs)
        try:
            a = gc_decode_weights(code, alive)
        except RuntimeError:
            a = np.zeros(4, np.float32)
            a[np.arange(code.num_groups) * code.c] = 1.0
        pw = expand_worker_weights(torch.from_numpy(a), 1, 2.0)
        assert np.array_equal(w, pw.numpy())


def test_schedule_matches_the_program():
    from repro_torch.optim import adamw
    mix = json.loads((FIXTURES / "traffic" / "tiny_train.json").read_text())
    cfg = adamw.AdamWConfig(**mix["optimizer"])
    for step in (1, 2, 3, 100, 5000, 10000, 20000):
        assert train.lr_at(mix["optimizer"], step) == pytest.approx(
            adamw.schedule(cfg, step), rel=1e-6)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-hybrid"])
def test_first_training_steps_match_the_program(name):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.coded_step import CodedStepConfig, CodedTrainer
    from portbench.drivers.train_coded import alive_mask
    cfg = fp32(name)
    mix = json.loads((FIXTURES / "traffic" / "tiny_train.json").read_text())
    mix["optimizer"]["warmup_steps"] = 1      # steps large enough to see
    spec, seed = spec_of(cfg), 77
    m = program(cfg, seed, trainable=True)
    opt_cfg = adamw.AdamWConfig(**mix["optimizer"])
    opt = adamw.init(opt_cfg, m)
    trainer = CodedTrainer(
        program_config(cfg), DataConfig(spec.vocab, mix["seq_len"],
                                        mix["unique_rows"], seed),
        CodedStepConfig(mix["n_workers"], mix["c"], mix["unique_rows"]),
        opt_cfg, alive_fn=lambda s: alive_mask(mix, seed, s))
    losses = []
    for step in range(3):
        m, opt, metrics = trainer.run_step(m, opt, step)
        losses.append(float(metrics["loss"]))
    ref = train.run_steps(spec, mix, seed, lambda s: alive_mask(mix, seed, s),
                          3, "cpu")
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    shapes = weights.param_shapes(spec)
    for n, p in m.named_parameters():
        change = float((p - weights.draw(spec, n, shapes[n], seed,
                                         "cpu")).norm())
        assert change == pytest.approx(ref["change"][n], rel=1e-3, abs=1e-9)


def test_decode_over_a_drawn_prefix_matches_the_program():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import api
    cfg = fp32("tiny-dense")
    spec, pcfg, seed = spec_of(cfg), program_config(cfg), 11
    b, s, p0, t = 2, 64, 40, 6
    fn = steps.build_decode_cell(pcfg, ShapeConfig("d", "decode", s, b),
                                 device="cpu").fn
    m = program(cfg, seed)
    kc, vc = api.init_cache(pcfg, b, s, "float32", "cpu")
    weights.fill_cache(kc, vc, seed)
    toks = torch.randint(0, spec.vocab, (b, t),
                         generator=torch.Generator().manual_seed(1))
    got = []
    for i in range(t):
        lg, (kc, vc) = fn(m, (kc, vc), toks[:, i:i + 1].int(), p0 + i)
        got.append(lg[:, 0])
    shape = (b, s, spec.kv_heads, spec.head_dim)

    def prefix(layer):
        return tuple(weights.cache_layer(seed, w, layer, shape,
                                         torch.float32, "cpu")[:, :p0]
                     for w in ("k", "v"))
    lg, k, v = serve.decode(spec, weights.draw_all(spec, seed, "cpu"), toks, p0,
                            prefix)
    scale = float(lg.abs().max())
    assert torch.allclose(torch.stack(got, 1), lg, atol=1e-4 * scale)
    assert torch.allclose(kc[:, :, p0:p0 + t], k, atol=1e-4, rtol=1e-4)
    assert torch.allclose(vc[:, :, p0:p0 + t], v, atol=1e-4, rtol=1e-4)


def test_reference_imports_nothing_of_the_program():
    import ast
    from conftest import REPO
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax", "jaxlib", "flax"), \
                    (path.name, n)
