"""The port's step cells (``launch.steps``), ``cache_shapes``,
``adamw.state_shapes`` and the family dispatch against the JAX package's,
on the CPU.

The reference's cells are built on its host mesh (``make_host_mesh``),
never lowered.  Every (architecture x applicable shape) cell's inputs are
compared leaf by leaf: shape and dtype.  The train cell's step (the
reference's ``Cell.fn``, un-jitted on concrete arrays) runs one and two
steps from the same parameters, optimizer state and numpy inputs in both
packages for the MoE and embedding-input families at the reduced size of
tests/test_models_smoke.py, experts and embedding inputs on; the prefill
and decode cells' steps likewise.  The card's test (marked ``gpu``)
drives a train cell through the flash kernel:

    python -m pytest -q -m gpu tests/test_torch_steps.py

The JAX package is imported inside the tests that compare with it.  Each
tolerance is stated where it is used.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch._device import generator
from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.convert import opt_state_to_port, params_to_port
from repro_torch.launch import steps
from repro_torch.models import api, ssm_lm, transformer
from repro_torch.optim import adamw

CPU = "cpu"
CELLS = [(arch, shape) for arch in ARCH_IDS if arch != "paper-matvec"
         for shape in applicable_shapes(get_config(arch))]
TRAIN_ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b", "hubert-xlarge",
               "internvl2-76b"]
# the tolerances of tests/test_torch_train.py's
# test_coded_trainer_three_steps_match_reference: loss and grad norm 1e-4
# relative, updated parameters 1e-5 absolute where no reference gradient
# lies within rounding of zero (AdamW's first steps move an element by
# ~lr * sign(g), and the sign of a gradient within rounding of zero is
# either package's)
STEP_RTOL, PARAM_ATOL, NEAR_ZERO = 1e-4, 1e-5, 1e-6
# bf16 parameters (internvl2-76b's): each package rounds its fp32 update
# to bf16, and where the two fp32 updates differ in their last bits across
# a rounding boundary the stored values differ by one bf16 step (2^-7 of
# the value at most); such elements must stay a small share (BF16_SHARE)
BF16_STEP, BF16_SHARE = 2.0 ** -7, 1e-3
# fp32 logits through a few hundred roundings in other orders: 1e-4 of
# max|logits| (tests/test_torch_models.py's MODEL_TOL)
MODEL_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)

# a copy of tests/test_models_smoke.py:18-41 (reduced dims, family bits kept)
REDUCE = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=211,
              flash_block_kv=32, remat="none", compute_dtype="float32",
              param_dtype="float32")


def reduced(arch: str, **overrides) -> ModelConfig:
    cfg = get_config(arch)
    kw = dict(REDUCE)
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)))
        kw.update(head_dim=16 if cfg.head_dim else None)
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.attn_every:
        kw.update(num_layers=5, attn_every=2, attn_window=16)
    if cfg.family in ("ssm",):
        kw.update(num_heads=0, num_kv_heads=0, d_ff=0)
    kw.update(overrides)
    return cfg.scaled(**kw)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _ref_cfg(cfg: ModelConfig):
    from repro.configs.base import ModelConfig as RefConfig
    return RefConfig(**dataclasses.asdict(cfg))


def _ref_shape(shape: ShapeConfig):
    from repro.configs.base import ShapeConfig as RefShape
    return RefShape(**dataclasses.asdict(shape))


def _leaves(tree, prefix=""):
    """{path: leaf} of a tree of dicts, tuples and named tuples, the
    paths of both packages' trees alike (a port dict key "layers.wq" and a
    reference path layers -> wq both read "layers.wq")."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        out = {}
        for k, v in zip(names, tree):
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _spec(leaf):
    return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")


def _np(t):
    return t.detach().float().cpu().numpy()


def _close_to_max(out, ref, tol):
    """|out - ref| <= tol * max|ref|, elementwise."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) + 1e-30
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol, rtol=0)


# --------------------------------------------------------------------------
# Specs: every cell, the cache and the optimizer state
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_match_reference(arch, shape):
    """The inputs of every (architecture x applicable shape) cell at the
    published size, leaf by leaf: the reference's shapes and dtypes as
    meta tensors (no storage).  The optimizer's step is the port's host
    counter 0 where the reference has an int32 scalar."""
    _jax()
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_cell as ref_build_cell
    ref = ref_build_cell(arch, shape, make_host_mesh())
    cell = steps.build_cell(arch, shape, device=CPU)
    assert (cell.arch, cell.shape, cell.kind, cell.donate) == \
        (ref.arch, ref.shape, ref.kind, ref.donate)
    assert cell.device == torch.device(CPU)
    ours, theirs = _leaves(cell.args), _leaves(ref.args)
    assert sorted(ours) == sorted(theirs)
    for path, leaf in ours.items():
        if path == "1.step":
            assert leaf == 0 and _spec(theirs[path]) == ((), "int32")
            continue
        assert leaf.device.type == "meta", path
        assert _spec(leaf) == _spec(theirs[path]), path


def test_the_cells_are_the_reference_set():
    """31 cells: ten architectures, each at its applicable shapes (no
    decode cell for the encoders, long_500k for the SSM families only)."""
    from repro.configs.base import ARCH_IDS as REF_IDS
    from repro.configs.base import applicable_shapes as ref_shapes
    from repro.configs.base import get_config as ref_get_config
    ref = [(a, s) for a in REF_IDS if a != "paper-matvec"
           for s in ref_shapes(ref_get_config(a))]
    assert CELLS == ref and len(CELLS) == 31


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b",
                                  "internvl2-76b", "hubert-xlarge",
                                  "mamba2-1.3b", "zamba2-1.2b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cache_shapes_match_reference(arch, dtype):
    _jax()
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as rapi
    ours = _leaves(api.cache_shapes(get_config(arch), 4, 1024, dtype))
    theirs = _leaves(rapi.cache_shapes(ref_get_config(arch), 4, 1024, dtype))
    assert sorted(ours) == sorted(theirs)
    for path, leaf in ours.items():
        assert leaf.device.type == "meta"
        assert _spec(leaf) == _spec(theirs[path]), path
    # the meta tree is init_cache's, leaf for leaf
    real = _leaves(api.init_cache(reduced(arch), 2, 16, dtype, device=CPU))
    meta = _leaves(api.cache_shapes(reduced(arch), 2, 16, dtype))
    assert {p: _spec(t) for p, t in real.items()} == \
        {p: _spec(t) for p, t in meta.items()}


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "zamba2-1.2b"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_state_shapes_match_reference(arch, moment_dtype):
    _jax()
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as rapi
    from repro.optim import adamw as radamw
    ref = radamw.state_shapes(radamw.AdamWConfig(moment_dtype=moment_dtype),
                              rapi.param_shapes(ref_get_config(arch)))
    cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
    ours = adamw.state_shapes(cfg, api.param_shapes(get_config(arch)))
    assert ours.step == 0 and _spec(ref.step) == ((), "int32")
    for field in ("mu", "nu"):
        mine, theirs = getattr(ours, field), _leaves(getattr(ref, field))
        assert sorted(mine) == sorted(theirs)
        for name, t in mine.items():
            assert t.device.type == "meta"
            assert _spec(t) == _spec(theirs[name]), name
    # the meta state is init's, name for name, on a module's parameters
    model = api.init_params(reduced(arch), generator(0, CPU))
    real = adamw.init(cfg, model)
    meta = adamw.state_shapes(cfg, model)
    assert {n: _spec(t) for n, t in real.mu.items()} == \
        {n: _spec(t) for n, t in meta.nu.items()}


@pytest.mark.parametrize("family", ["dense", "moe", "encoder", "vlm", "audio",
                                    "ssm", "hybrid", "mlp", ""])
def test_model_module_routes_as_the_reference(family):
    """ssm and hybrid to ``ssm_lm``, every other family (one the JAX
    package does not name too) to ``transformer``."""
    _jax()
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as rapi
    ours = api.model_module(get_config("qwen3-0.6b").scaled(family=family))
    theirs = rapi.model_module(ref_get_config("qwen3-0.6b").scaled(
        family=family))
    assert ours.__name__.rsplit(".", 1)[1] == \
        theirs.__name__.rsplit(".", 1)[1]
    assert ours is (ssm_lm if family in ("ssm", "hybrid") else transformer)


# --------------------------------------------------------------------------
# The steps against the reference's
# --------------------------------------------------------------------------

def _ref_params(cfg: ModelConfig, seed: int, trainable: bool):
    jax, _ = _jax()
    from repro.models import api as rapi
    params = jax.tree.map(np.asarray, rapi.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))
    return params, params_to_port(cfg, params, CPU, trainable=trainable)


def _cell_inputs(cfg: ModelConfig, seed: int, b: int, s: int):
    """Model inputs (token ids int32, or N(0, 1) embeddings in the compute
    dtype), int32 labels and per-example decode weights (one coded row of
    two dropped, the other doubled), with numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        x = rng.standard_normal((b, s, cfg.d_model)).astype(cfg.compute_dtype)
    else:
        x = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    weights = np.tile(np.asarray([2.0, 0.0], np.float32), b // 2)
    return x, labels, weights


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_cell_steps_match_reference(arch):
    """One and two steps of the train cell from the same state: the loss
    and grad norm of each within 1e-4 relative, the parameters after each
    within 1e-5 absolute (STEP_RTOL, PARAM_ATOL), the moments within 1e-4
    of their max.  internvl2-76b keeps its bf16 parameters (and so bf16
    gradients): a parameter may also differ by one bf16 step (BF16_STEP)
    where the two fp32 updates round to either side, in a small share of
    the elements (BF16_SHARE), and a moment, in as small a share, by up to
    one bf16 step of its largest value (the step of a bf16 gradient it
    accumulated)."""
    jax, jnp = _jax()
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_train_cell as ref_build
    from repro.optim import adamw as radamw
    from repro.runtime.coded_step import weighted_loss_fn as ref_loss
    keep = {"param_dtype": get_config(arch).param_dtype}
    cfg = reduced(arch, **keep)
    assert bool(cfg.num_experts) == (get_config(arch).family == "moe")
    assert cfg.embedding_inputs == (arch in ("hubert-xlarge", "internvl2-76b"))
    shape = ShapeConfig("train_small", "train", 16, 4)
    opt_cfg = adamw.AdamWConfig(**OPT)
    rcfg = _ref_cfg(cfg)
    ref_cell = ref_build(rcfg, _ref_shape(shape), make_host_mesh(),
                         radamw.AdamWConfig(**OPT))
    cell = steps.build_train_cell(cfg, shape, opt_cfg, device=CPU)
    params, model = _ref_params(cfg, 5, trainable=True)
    r_opt = radamw.init(radamw.AdamWConfig(**OPT), params)
    p_opt = opt_state_to_port(r_opt, CPU)
    rp = jax.tree.map(jnp.asarray, params)
    near_zero = None
    for step in range(2):
        x, labels, w = _cell_inputs(cfg, 10 + step, 4, 16)
        assert _spec(torch.from_numpy(x)) == _spec(cell.args[2])
        g = jax.grad(ref_loss(rcfg))(rp, jnp.asarray(x), jnp.asarray(labels),
                                     jnp.asarray(w))
        tiny = {n: (np.abs(a) <= NEAR_ZERO) & (a != 0) for n, a in
                _leaves(jax.tree.map(lambda t: np.asarray(t, np.float32),
                                     g)).items()}
        near_zero = tiny if near_zero is None else {
            n: near_zero[n] | tiny[n] for n in tiny}
        rp, r_opt, rm = ref_cell.fn(rp, r_opt, jnp.asarray(x),
                                    jnp.asarray(labels), jnp.asarray(w))
        model, p_opt, pm = cell.fn(model, p_opt, torch.from_numpy(x),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(w))
        assert set(pm) == set(rm) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=STEP_RTOL)
        assert pm["lr"] == float(rm["lr"])
        assert p_opt.step == int(r_opt.step) == step + 1
        ref_p = _leaves(jax.tree.map(lambda t: np.asarray(t, np.float32), rp))
        ref_dt = _leaves(jax.tree.map(lambda t: str(t.dtype), rp))
        skipped = total = rounded = 0
        bf16 = cfg.param_dtype == "bfloat16"
        for name, p in model.named_parameters():
            assert str(p.dtype).removeprefix("torch.") == ref_dt[name] == \
                cfg.param_dtype
            ok = ~near_zero[name]
            skipped += int((~ok).sum())
            total += ok.size
            ours, theirs = _np(p)[ok], ref_p[name][ok]
            np.testing.assert_allclose(ours, theirs, atol=PARAM_ATOL,
                                       rtol=BF16_STEP if bf16 else 0)
            rounded += int((np.abs(ours - theirs) > PARAM_ATOL).sum())
        assert skipped < 0.01 * total, (skipped, total)
        assert rounded <= BF16_SHARE * total if bf16 else rounded == 0
        for mine, theirs in ((p_opt.mu, r_opt.mu), (p_opt.nu, r_opt.nu)):
            theirs = _leaves(theirs)
            for name, t in mine.items():
                want = np.asarray(theirs[name], np.float32)
                scale = float(np.abs(want).max())
                np.testing.assert_allclose(
                    _np(t), want, rtol=0,
                    atol=(BF16_STEP if bf16 else 1e-4) * scale)
                off = int((np.abs(_np(t) - want) > 1e-4 * scale).sum())
                assert off <= BF16_SHARE * want.size if bf16 else off == 0


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "hubert-xlarge",
                                  "internvl2-76b", "zamba2-1.2b"])
def test_prefill_and_decode_cells_match_reference(arch):
    """The prefill cell's logits and three decode-cell steps (where the
    architecture has a decode cell) against the reference's cells' steps:
    1e-4 of max|logits| (MODEL_TOL)."""
    jax, jnp = _jax()
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import (build_decode_cell as ref_decode,
                                    build_prefill_cell as ref_prefill)
    cfg = reduced(arch)
    params, model = _ref_params(cfg, 6, trainable=False)
    mesh = make_host_mesh()
    shape = ShapeConfig("prefill_small", "prefill", 12, 2)
    x, _, _ = _cell_inputs(cfg, 6, 2, 12)
    out = steps.build_prefill_cell(cfg, shape, CPU).fn(model,
                                                       torch.from_numpy(x))
    ref = ref_prefill(_ref_cfg(cfg), _ref_shape(shape), mesh).fn(
        params, jnp.asarray(x))
    _close_to_max(_np(out), np.asarray(ref), MODEL_TOL)
    if "decode_32k" not in applicable_shapes(cfg):
        return
    shape = ShapeConfig("decode_small", "decode", 8, 2)
    cell = steps.build_decode_cell(cfg, shape, CPU)
    rcell = ref_decode(_ref_cfg(cfg), _ref_shape(shape), mesh)
    cache = cell.materialize(0)[1]
    ref_cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                             rcell.args[1])
    for t in range(3):
        tok = x[:, t:t + 1]
        lg, cache = cell.fn(model, cache, torch.from_numpy(tok),
                            torch.tensor(t, dtype=torch.int32))
        ref_lg, ref_cache = rcell.fn(params, ref_cache, jnp.asarray(tok),
                                     jnp.asarray(t, jnp.int32))
        _close_to_max(_np(lg), np.asarray(ref_lg), MODEL_TOL)


# --------------------------------------------------------------------------
# The port's own: materialize, the default device
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-76b",
                                  "dbrx-132b", "mamba2-1.3b"])
def test_materialized_inputs_fit_the_specs_and_run(arch):
    cfg = reduced(arch)
    shapes = [ShapeConfig("t", "train", 16, 4),
              ShapeConfig("p", "prefill", 16, 2)]
    if "decode_32k" in applicable_shapes(cfg):
        shapes.append(ShapeConfig("d", "decode", 16, 2))
    for shape in shapes:
        build = {"train": steps.build_train_cell,
                 "prefill": steps.build_prefill_cell,
                 "decode": steps.build_decode_cell}[shape.kind]
        cell = build(cfg, shape, device=CPU)
        args = cell.materialize(3)
        specs, real = _leaves(cell.args[1:]), _leaves(args[1:])
        assert sorted(specs) == sorted(real)
        for path, spec in specs.items():
            if isinstance(spec, torch.Tensor):
                assert _spec(real[path]) == _spec(spec), path
                assert real[path].device.type == CPU
        assert {n: _spec(t) for n, t in _leaves(cell.args[0]).items()} == \
            {n: _spec(p) for n, p in args[0].named_parameters()}
        out = cell.fn(*args)
        if shape.kind == "train":
            assert out[1].step == 1 and np.isfinite(float(out[2]["loss"]))
            assert all(p.requires_grad for p in args[0].parameters())
        else:
            logits = out[0] if shape.kind == "decode" else out
            assert logits.shape[:2] == (2, 1 if shape.kind == "decode"
                                        else 16)
            assert torch.isfinite(logits).all()
    if cfg.embedding_inputs:
        x = steps.build_prefill_cell(cfg, shapes[1], CPU).materialize(3)[1]
        assert x.dtype == torch.float32 and x.shape == (2, 16, cfg.d_model)


def test_build_cell_takes_overrides_and_defaults_to_the_card():
    cell = steps.build_cell("dbrx-132b", "train_4k",
                            overrides=dict(num_layers=1), device=CPU)
    assert cell.cfg.num_layers == 1 and cell.args[0]["layers"][
        "w_gate"].shape == (1, 16, 6144, 10752)
    assert cell.args[2].shape == (SHAPES["train_4k"].global_batch, 4096)
    assert cell.opt_cfg == steps.default_opt_cfg()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            steps.build_cell("qwen3-0.6b", "prefill_32k")


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_cell_on_card_matches_the_host(cuda, arch):
    """One train-cell step in fp32 under ``remat="full"`` on the card
    (the flash kernel forward and its recompute, two launches a layer)
    against the same step on the host: loss 1e-5 relative, parameters
    1e-4 of each leaf's max."""
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(arch, remat="full")
    if cfg.num_experts:
        cfg = cfg.scaled(capacity_factor=cfg.num_experts
                         / cfg.experts_per_token)
    shape = ShapeConfig("t", "train", 24, 4)
    host = steps.build_train_cell(cfg, shape, device=CPU)
    card = steps.build_train_cell(cfg, shape, device=cuda)
    args = host.materialize(4)
    model = copy.deepcopy(args[0]).to(cuda)
    inputs = [t.to(cuda) for t in args[2:]]
    launches = flash_attention.launches
    model, _, m = card.fn(model, adamw.init(card.opt_cfg, model), *inputs)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 2 * cfg.num_layers
    ref_model, _, ref_m = host.fn(*args)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
    ref = dict(ref_model.named_parameters())
    for n, p in model.named_parameters():
        _close_to_max(_np(p), _np(ref[n]), 1e-4)
