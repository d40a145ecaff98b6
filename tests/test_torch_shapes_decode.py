"""The decode cells at the production depths against the JAX package's, on
the CPU: decode_32k's position 32,767 and long_500k's 524,287, past one
attention window (4096) and one SSM chunk (256).

The models are tiny in width (``tests/test_torch_steps.py``'s ``reduced``:
d_model 64, 4 heads of dim 16, 2 layers, 5 for the hybrid) and keep the
production ``ssm_chunk`` 256 and ``attn_window`` 4096, so that the
transformer's cache holds 32,768 positions and the hybrid's ring its 4096
slots.  The parameters are the port's ``init_params`` (the reference's
laws) in both packages; each cache or state is drawn with numpy (it
stands in for a prefill) and loaded into both.  The caches are fp32: a
key rounded to the other bf16 neighbour would move the next steps by
more than the logits' tolerance.  From each position three steps run in
both packages (a transformer whose cache ends at the position runs the
three that end there); each step's logits and the caches after the last
must agree within 1e-4 of their max (``MODEL_TOL``).

The reference's cells run under ``jax.disable_jit()`` (its layer scan as
a Python loop, every operation on its own): compiled, XLA rewrites
``1 / theta ** x`` in ``rope_frequencies`` to ``theta ** -x`` and rounds
the inverse frequencies otherwise, and its rotary angles at position
524,287 then move by up to 2.7e-3 (head dim 16) from its own eager
program's.  The port is held to the program as written.

The JAX package is imported inside the tests.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch._device import generator
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.models import api, layers
from test_torch_steps import (MODEL_TOL, _jax, _leaves, _np,
                              _ref_cfg, _ref_shape, reduced)

CPU = "cpu"
BATCH, STEPS = 2, 3
# (arch, position, the cache's max_len)
CASES = [("qwen3-0.6b", 4095, 32_768), ("qwen3-0.6b", 4096, 32_768),
         ("qwen3-0.6b", 32_767, 32_768),
         ("zamba2-1.2b", 4095, 32_768), ("zamba2-1.2b", 4096, 32_768),
         ("zamba2-1.2b", 32_767, 32_768), ("zamba2-1.2b", 524_287, 524_288),
         ("mamba2-1.3b", 32_767, 32_768), ("mamba2-1.3b", 524_287, 524_288)]
# positions of the rotary check: the cells' depths and the step past
ROPE_POSITIONS = (4095, 32_767, 524_287, 524_288)
# the rotated values against the reference's eager program: cos and sin of
# the same fp32 angle from two libraries differ by an fp32 step or two
ROPE_ATOL = 1e-6


def deep(arch: str, **overrides):
    """``reduced(arch)`` with the config's own ``ssm_chunk`` and
    ``attn_window`` (256 and 4096 in the SSM families)."""
    full = get_config(arch)
    return reduced(arch, ssm_chunk=full.ssm_chunk,
                   attn_window=full.attn_window, **overrides)


def nested(model) -> dict:
    """The module's parameters as the reference's pytree of numpy arrays
    (``layers.wq`` -> ``{"layers": {"wq": ...}}``)."""
    tree = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().numpy().copy()
    return tree


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """(config, the reference's parameters, the port's module): the port's
    ``init_params`` (the reference's laws) from seed 26, the same arrays
    in both packages (the reference's own ``init_params`` takes 3-9 s a
    family on the CPU)."""
    cfg = deep(arch)
    model = api.init_params(cfg, generator(26, CPU))
    params = nested(model)
    assert sorted(_leaves(params)) == sorted(_leaves(api.param_shapes(cfg)))
    return cfg, params, model


def _random_cache(rcell, seed: int) -> dict:
    """{path: fp32 numpy array} for each leaf of the reference cell's cache:
    standard normals."""
    rng = np.random.default_rng(seed)
    return {path: rng.standard_normal(leaf.shape).astype(np.float32)
            for path, leaf in _leaves(rcell.args[1]).items()}


def _fill(tree, arrays: dict, put, prefix: str = ""):
    """``tree`` (dicts and tuples) with each leaf replaced by
    ``put(arrays[its path])``."""
    if isinstance(tree, dict):
        return {k: _fill(v, arrays, put, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_fill(v, arrays, put, f"{prefix}{i}.")
                     for i, v in enumerate(tree))
    return put(arrays[prefix[:-1]])


def _within(out, ref, tol: float, what: str) -> None:
    """max |out - ref| <= tol * max |ref|."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
    print(f"{what}: max|diff| / max|ref| {err / scale:.3e}")
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("arch,pos,max_len", CASES)
def test_decode_cell_at_depth_matches_reference(arch, pos, max_len):
    """Three decode-cell steps from ``pos`` over a random fp32 cache of
    ``max_len``: each step's logits and every cache leaf after the last
    within MODEL_TOL of their max."""
    jax, jnp = _jax()
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_decode_cell as ref_decode
    cfg, params, model = _model(arch)
    assert cfg.attn_window == (4096 if cfg.attn_every else 0)
    assert cfg.ssm_chunk == 256 or not cfg.ssm_state
    shape = ShapeConfig("decode_deep", "decode", max_len, BATCH)
    cell = steps.build_decode_cell(cfg, shape, CPU)
    rcell = ref_decode(_ref_cfg(cfg), _ref_shape(shape), make_host_mesh())
    arrays = _random_cache(rcell, pos)
    ref_cache = _fill(rcell.args[1], arrays, jnp.asarray)
    # a copy: the port writes its cache in place, and the reference's
    # arrays may alias the numpy buffers
    cache = _fill(rcell.args[1], arrays, lambda a: torch.from_numpy(a.copy()))
    # the hybrid's ring holds the window, whatever the length
    if cfg.attn_every:
        assert ref_cache["attn_k"].shape[2] == cfg.attn_window
    start = pos
    if cfg.family not in ("ssm", "hybrid") and pos + STEPS > max_len:
        start = max_len - STEPS         # the last three slots, ending at pos
    rng = np.random.default_rng(pos + 1)
    for t in range(start, start + STEPS):
        tok = rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
        logits, cache = cell.fn(model, cache, torch.from_numpy(tok), t)
        with jax.disable_jit():
            ref_logits, ref_cache = rcell.fn(params, ref_cache,
                                             jnp.asarray(tok),
                                             jnp.asarray(t, jnp.int32))
        assert logits.shape == ref_logits.shape
        _within(_np(logits), ref_logits, MODEL_TOL, f"logits at {t}")
    assert start <= pos < start + STEPS
    ours, theirs = _leaves(cache), _leaves(ref_cache)
    assert sorted(ours) == sorted(theirs)
    for path, leaf in ours.items():
        _within(_np(leaf), theirs[path], MODEL_TOL, f"cache {path}")


HEADS = sorted({(get_config(a).resolved_head_dim, get_config(a).rope_theta)
                for a in ARCH_IDS if get_config(a).num_heads})


@pytest.mark.parametrize("head_dim,theta", HEADS)
def test_rope_frequencies_are_the_reference_bits(head_dim, theta):
    """The inverse frequencies of every (head dim, theta) of the configs
    equal the reference's eager ones bit for bit: one float32 step of one
    frequency is 0.03 rad of angle at position 524,287."""
    jax, jnp = _jax()
    from repro.models import layers as ref_layers
    ours = layers.rope_frequencies(head_dim, theta).numpy()
    theirs = np.asarray(ref_layers.rope_frequencies(head_dim, theta))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("head_dim,theta", HEADS)
def test_rope_at_depth_matches_reference(head_dim, theta):
    """``apply_rope`` at the cells' depths against the reference's eager
    program, within ROPE_ATOL for N(0, 1) inputs."""
    jax, jnp = _jax()
    from repro.models import layers as ref_layers
    x = np.random.default_rng(head_dim).standard_normal(
        (2, len(ROPE_POSITIONS), 4, head_dim)).astype(np.float32)
    pos = np.tile(np.asarray(ROPE_POSITIONS, np.int32), (2, 1))
    ours = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta).numpy()
    theirs = np.asarray(ref_layers.apply_rope(jnp.asarray(x),
                                              jnp.asarray(pos), theta))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=ROPE_ATOL)
