"""The rest of the model zoo against the JAX package's, on the CPU: the MoE
family (dbrx-132b, qwen3-moe-235b-a22b), the embedding-input families
(hubert-xlarge, internvl2-76b), the other dense configs (deepseek-7b,
yi-9b, llama3-405b) and the paper-matvec LM placeholder; flash attention's
plain version at head dim 80; the frontends.

The same inputs, made with numpy from a seed, go through both packages:
``moe_ffn`` over a grid of experts, top-k, group sizes and capacity
factors (drops included) and with a tied router; each new config, cut as
tests/test_models_smoke.py:26-40 cuts it, through the reference's
parameters (``convert.params_to_port``): forward logits, decode steps
(not for the encoder), loss and gradients; the checkpoint layout both
ways for a MoE and an embedding-input model.  The card's tests (marked
``gpu``) drive the same models through the flash kernel:

    python -m pytest -q -m gpu tests/test_torch_zoo.py

The JAX package is imported inside the tests that compare with it.  Each
tolerance is stated where it is used.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as pckpt
from repro_torch._device import generator
from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_to_port
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention, ops)
from repro_torch.launch import serve as pserve
from repro_torch.models import api, frontends
from repro_torch.models import moe as pmoe
from repro_torch.models.transformer import padded_vocab

CPU = "cpu"
NEW_ARCHS = ["dbrx-132b", "qwen3-moe-235b-a22b", "hubert-xlarge",
             "internvl2-76b", "deepseek-7b", "yi-9b", "llama3-405b"]
# fp32 on both sides, sums in other orders: the forward and decode logits
# within 1e-4 of max|logits| (tests/test_torch_models.py's MODEL_TOL); the
# loss within 1e-4 relative and each gradient within 1e-5 of its max
# (tests/test_torch_ssm.py's LOSS_RTOL, GRAD_TOL)
MODEL_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-4, 1e-5
# decode logits against the reference's and against prefill: 2e-4 of
# max|logits|, tests/test_models_smoke.py:114's bound
DECODE_TOL = 2e-4
# moe_ffn in fp32: one layer, sums of a few dozen products in other orders
MOE_TOL = 1e-5
# moe_ffn in bf16: both sides round the expert products, the SwiGLU and
# the combine to bf16 (2^-8 of each value) at their own places; a few such
# steps of max|y|
MOE_BF16_TOL = 3e-2
# the plain flash version against the reference's Pallas kernel run in
# interpret mode: fp32, tests/test_kernels.py:48's 2e-5
FLASH_TOL = 2e-5

# a copy of tests/test_models_smoke.py:18-41 (reduced dims, family bits kept)
REDUCE = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=211,
              flash_block_kv=32, remat="none", compute_dtype="float32",
              param_dtype="float32")


def reduced(arch: str) -> ModelConfig:
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
    return cfg.scaled(**kw)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _ref_cfg(cfg: ModelConfig):
    from repro.configs.base import ModelConfig as RefConfig
    return RefConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg: ModelConfig, seed: int = 0, trainable: bool = False):
    """The reference's parameters (numpy) for ``cfg`` and the port's module
    holding the same values."""
    jax, _ = _jax()
    from repro.models import api as rapi
    params = jax.tree.map(np.asarray, rapi.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))
    return params, params_to_port(cfg, params, CPU, trainable=trainable)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _np(t):
    return t.detach().float().cpu().numpy()


def _close_to_max(out, ref, tol):
    """|out - ref| <= tol * max|ref|, elementwise."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) + 1e-30
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol, rtol=0)


def _inputs(cfg: ModelConfig, seed: int, b: int, s: int):
    """Model inputs (token ids, or N(0, 1) embeddings for an embedding-input
    family) and labels, with numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return x, rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _torch_in(x):
    t = torch.from_numpy(x)
    return t if t.is_floating_point() else t.long()


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------

def test_arch_ids_are_the_reference_list():
    from repro.configs.base import ARCH_IDS as REF_IDS
    assert ARCH_IDS == REF_IDS


@pytest.mark.parametrize("arch", NEW_ARCHS + ["paper-matvec"])
def test_config_equals_reference_field_for_field(arch):
    from repro.configs.base import applicable_shapes as ref_shapes
    from repro.configs.base import get_config as ref_get_config
    ours, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.resolved_head_dim == ref.resolved_head_dim
    assert applicable_shapes(ours) == ref_shapes(ref)


def test_paper_matvec_job_config_equals_reference():
    from repro.configs.paper_matvec import CONFIG as REF
    from repro_torch.configs import CONFIG
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(REF)
    assert get_config("paper-matvec").family == "dense"


def test_encoder_families_have_no_decode_cell():
    assert "decode_32k" not in applicable_shapes(get_config("hubert-xlarge"))
    assert "decode_32k" in applicable_shapes(get_config("internvl2-76b"))
    assert "long_500k" not in applicable_shapes(get_config("dbrx-132b"))


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "paper-matvec"])
def test_param_shapes_match_reference_at_full_size(arch):
    """Every architecture at its published size, as meta tensors: the
    reference's names, shapes and dtypes (no storage)."""
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as rapi
    ref = _flat(rapi.param_shapes(ref_get_config(arch)))
    ours = _flat(api.param_shapes(get_config(arch)))
    assert sorted(ref) == sorted(ours)
    for name, t in ours.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[name].shape), name
        assert str(t.dtype).removeprefix("torch.") == str(ref[name].dtype)


# --------------------------------------------------------------------------
# moe_ffn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("group", [1, 7, 16, 256, 1000])
@pytest.mark.parametrize("experts,top_k", [(4, 1), (8, 2), (16, 4),
                                           (128, 8)])
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 16.0])
def test_expert_capacity_matches_reference(group, experts, top_k, factor):
    from repro.models.moe import expert_capacity
    assert pmoe.expert_capacity(group, experts, top_k, factor) == \
        expert_capacity(group, experts, top_k, factor)


def _moe_inputs(seed, e, d=32, f=48, b=2, s=32, zero_router=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = (np.zeros((d, e), np.float32) if zero_router else
              rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d))
    wg = rng.standard_normal((e, d, f)).astype(np.float32) / np.sqrt(d)
    wu = rng.standard_normal((e, d, f)).astype(np.float32) / np.sqrt(d)
    wd = rng.standard_normal((e, f, d)).astype(np.float32) / np.sqrt(f)
    return x, router, wg, wu, wd


def _dropped(x, router, top_k, factor, group):
    """(token, slot) pairs the port's routing drops, and its capacity."""
    xt = torch.from_numpy(x)
    tokens = xt.shape[0] * xt.shape[1]
    g = min(group, tokens)
    cap = pmoe.expert_capacity(g, router.shape[1], top_k, factor)
    dispatch, _ = pmoe.route(xt.reshape(tokens // g, g, -1),
                             torch.from_numpy(router), top_k, cap)
    return tokens * top_k - int(dispatch.sum()), cap, g


@pytest.mark.parametrize("factor", [0.5, 1.25])
@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("experts,top_k", [(4, 1), (4, 2), (8, 1), (8, 2)])
def test_moe_ffn_matches_reference(experts, top_k, group, factor):
    """64 tokens in groups of 16 (four groups) or 64 (the token count);
    a (token, expert) pair past the capacity is dropped on both sides, and
    where the groups route more pairs than the experts have slots, some
    are."""
    _, jnp = _jax()
    from repro.models.moe import moe_ffn as ref_moe
    seed = experts * 100 + top_k * 10 + group + int(factor * 4)
    args = _moe_inputs(seed, experts)
    out = pmoe.moe_ffn(*map(torch.from_numpy, args), top_k=top_k,
                       capacity_factor=factor, group_size=group)
    ref = ref_moe(*map(jnp.asarray, args), top_k=top_k,
                  capacity_factor=factor, group_size=group)
    assert out.shape == ref.shape == args[0].shape
    _close_to_max(_np(out), np.asarray(ref), MOE_TOL)
    dropped, cap, g = _dropped(args[0], args[1], top_k, factor, group)
    if g * top_k > experts * cap:
        assert dropped > 0, (g, top_k, experts, cap)
    if factor == 0.5 and group == 64:
        assert dropped > 0


def test_moe_ffn_drops_differ_with_the_capacity():
    """At factor 0.5 the same inputs drop more pairs than at 1.25, and the
    outputs differ where they do (the drop is real, not a no-op)."""
    args = _moe_inputs(3, 8)
    t = list(map(torch.from_numpy, args))
    low = _dropped(args[0], args[1], 2, 0.5, 64)[0]
    high = _dropped(args[0], args[1], 2, 1.25, 64)[0]
    assert low > high >= 0 and low > 0
    assert not torch.allclose(pmoe.moe_ffn(*t, top_k=2, capacity_factor=0.5,
                                           group_size=64),
                              pmoe.moe_ffn(*t, top_k=2, capacity_factor=1.25,
                                           group_size=64))


@pytest.mark.parametrize("experts,top_k", [(8, 2), (4, 1)])
def test_moe_ffn_tied_router_picks_the_reference_experts(experts, top_k):
    """Zero router weights tie every probability: jax.lax.top_k keeps the
    lower expert, so every token goes to experts 0..k-1, whose queues
    overflow; the port picks the same experts and drops the same pairs."""
    _, jnp = _jax()
    from repro.models.moe import moe_ffn as ref_moe
    args = _moe_inputs(11, experts, zero_router=True)
    out = pmoe.moe_ffn(*map(torch.from_numpy, args), top_k=top_k,
                       capacity_factor=1.25, group_size=16)
    ref = ref_moe(*map(jnp.asarray, args), top_k=top_k, capacity_factor=1.25,
                  group_size=16)
    _close_to_max(_np(out), np.asarray(ref), MOE_TOL)
    xt = torch.from_numpy(args[0]).reshape(4, 16, -1)
    cap = pmoe.expert_capacity(16, experts, top_k, 1.25)
    dispatch, combine = pmoe.route(xt, torch.from_numpy(args[1]), top_k, cap)
    per_expert = dispatch.sum(dim=(0, 1, 3))
    assert per_expert[:top_k].tolist() == [4 * min(cap, 16)] * top_k
    assert float(per_expert[top_k:].sum()) == 0.0
    # slots fill in token order: tokens 0..cap-1 of each group are kept
    kept = dispatch.sum(dim=(2, 3))
    assert torch.equal(kept[:, :cap], torch.full((4, cap), float(top_k)))
    assert float(kept[:, cap:].sum()) == 0.0
    # the kept pairs' weights are the renormalised 1/k
    np.testing.assert_allclose(_np(combine.sum(dim=(2, 3))[:, :cap]), 1.0,
                               rtol=1e-6)


def test_moe_ffn_bf16_matches_reference():
    """bf16 inputs and weights on both sides (the router's softmax in
    fp32), within MOE_BF16_TOL of max|y|."""
    jax, jnp = _jax()
    from repro.models.moe import moe_ffn as ref_moe
    args = _moe_inputs(5, 8)
    out = pmoe.moe_ffn(*(torch.from_numpy(a).to(torch.bfloat16)
                         for a in args), top_k=2, capacity_factor=1.25,
                       group_size=16)
    ref = ref_moe(*(jnp.asarray(a, jnp.bfloat16) for a in args), top_k=2,
                  capacity_factor=1.25, group_size=16)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close_to_max(_np(out), np.asarray(ref.astype(jnp.float32)),
                  MOE_BF16_TOL)


def test_moe_ffn_rejects_a_ragged_group():
    args = list(map(torch.from_numpy, _moe_inputs(0, 4)))
    with pytest.raises(ValueError, match="divisible"):
        pmoe.moe_ffn(*args, top_k=1, group_size=24)


# --------------------------------------------------------------------------
# The new configs, reduced
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_to_port_carries_every_parameter(arch):
    cfg = reduced(arch)
    params, model = _ref_params(cfg, 0)
    flat = _flat(params)
    ours = dict(model.named_parameters())
    assert sorted(flat) == sorted(ours)
    for name, p in ours.items():
        assert np.array_equal(p.detach().numpy(), flat[name]), name
    assert ("embed" in ours) == (not cfg.embedding_inputs)
    if cfg.num_experts:
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        assert ours["layers.router"].shape == (2, d, e)
        assert ours["layers.w_down"].shape == (2, e, f, d)


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("S", [12, 16])
def test_forward_matches_reference(arch, S):
    """Prefill logits, fp32, within MODEL_TOL of max|logits|; the flash
    kernel's plain version on the CPU (no launch)."""
    _, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced(arch)
    params, model = _ref_params(cfg, 2)
    x, _ = _inputs(cfg, S, 2, S)
    before = flash_attention.launches
    out = api.forward(cfg, model, _torch_in(x))
    assert flash_attention.launches == before
    ref = rapi.forward(_ref_cfg(cfg), params, jnp.asarray(x))
    assert out.shape == ref.shape == (2, S, padded_vocab(cfg))
    _close_to_max(_np(out), np.asarray(ref), MODEL_TOL)


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS
                                  if a != "hubert-xlarge"])
def test_decode_step_matches_reference(arch):
    """Five decode steps: the logits of each and the cache after."""
    jax, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced(arch)
    params, model = _ref_params(cfg, 1)
    B, S, steps = 2, 8, 5
    x, _ = _inputs(cfg, 7, B, steps)
    cache = api.init_cache(cfg, B, S, dtype="float32", device=CPU)
    ref_cache = rapi.init_cache(_ref_cfg(cfg), B, S, dtype="float32")
    for t in range(steps):
        lg, cache = api.decode_step(cfg, model, cache,
                                    _torch_in(x[:, t:t + 1]), t)
        ref_lg, ref_cache = rapi.decode_step(
            _ref_cfg(cfg), params, ref_cache, jnp.asarray(x[:, t:t + 1]),
            jnp.asarray(t))
        assert lg.shape == ref_lg.shape == (B, 1, padded_vocab(cfg))
        _close_to_max(_np(lg), np.asarray(ref_lg), MODEL_TOL)
    for ours, theirs in zip(cache, ref_cache):
        _close_to_max(_np(ours), np.asarray(theirs), MODEL_TOL)


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS
                                  if a != "hubert-xlarge"])
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full forward logits, in the
    port alone, within tests/test_models_smoke.py:114's 2e-4; for MoE the
    capacity factor is raised to E / k so that nothing drops on either
    side (with drops, a prefill and a decode step route other groups)."""
    cfg = reduced(arch)
    if cfg.num_experts:
        cfg = cfg.scaled(capacity_factor=cfg.num_experts
                         / cfg.experts_per_token)
    model = api.init_params(cfg, generator(2, CPU))
    x, _ = _inputs(cfg, 12, 2, 12)
    full = api.forward(cfg, model, _torch_in(x))
    cache = api.init_cache(cfg, 2, 12, dtype="float32", device=CPU)
    outs = []
    for t in range(12):
        lg, cache = api.decode_step(cfg, model, cache, _torch_in(x[:, t:t + 1]),
                                    t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, dim=1)), _np(full),
                               rtol=2e-4, atol=2e-4)


def test_encoder_has_no_decode_step():
    """The encoder has no decode cell (``applicable_shapes``), but its
    decode step is the reference's: causal over the cache whatever
    ``cfg.causal`` says.  Eight steps of frames: the logits of each and
    the cache after, within DECODE_TOL of max|logits|."""
    jax, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced("hubert-xlarge")
    assert not cfg.causal and "decode_32k" not in applicable_shapes(cfg)
    params, model = _ref_params(cfg, 4)
    B, S = 2, 8
    x, _ = _inputs(cfg, 8, B, S)
    cache = api.init_cache(cfg, B, S, dtype="float32", device=CPU)
    ref_cache = rapi.init_cache(_ref_cfg(cfg), B, S, dtype="float32")
    for t in range(S):
        lg, cache = api.decode_step(cfg, model, cache,
                                    _torch_in(x[:, t:t + 1]), t)
        ref_lg, ref_cache = rapi.decode_step(
            _ref_cfg(cfg), params, ref_cache, jnp.asarray(x[:, t:t + 1]),
            jnp.asarray(t))
        assert lg.shape == ref_lg.shape == (B, 1, padded_vocab(cfg))
        _close_to_max(_np(lg), np.asarray(ref_lg), DECODE_TOL)
    for ours, theirs in zip(cache, ref_cache):
        _close_to_max(_np(ours), np.asarray(theirs), DECODE_TOL)
    # causal: the last step is the causal prefill's last row, not the
    # bidirectional forward's
    full = api.forward(cfg.scaled(causal=True), model, _torch_in(x))
    _close_to_max(_np(lg[:, 0]), _np(full[:, -1]), DECODE_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jax, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced(arch)
    params, model = _ref_params(cfg, 3, trainable=True)
    x, labs = _inputs(cfg, 3, 2, 16)
    ref_val, ref_g = jax.jit(jax.value_and_grad(
        lambda p: rapi.loss_fn(_ref_cfg(cfg), p, jnp.asarray(x),
                               jnp.asarray(labs))))(params)
    val = api.loss_fn(cfg, model, _torch_in(x), torch.from_numpy(labs))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(val, list(model.parameters()))
    np.testing.assert_allclose(float(val.detach()), float(ref_val),
                               rtol=LOSS_RTOL)
    ref_flat = _flat(jax.tree.map(np.asarray, ref_g))
    assert sorted(ref_flat) == sorted(names)
    for name, g in zip(names, grads):
        _close_to_max(_np(g), ref_flat[name], GRAD_TOL)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "hubert-xlarge"])
def test_checkpoint_layout_both_ways(arch, tmp_path):
    """A MoE and an embedding-input model (no ``embed``): the reference
    writes and the port restores the same leaves, and the other way."""
    jax, _ = _jax()
    from repro import checkpoint as rckpt
    cfg = reduced(arch)
    params, model = _ref_params(cfg, 4)
    rckpt.save(str(tmp_path / "ref"), 1, {"p": params})
    like = api.init_params(cfg, generator(0, CPU))
    got, _ = pckpt.restore(str(tmp_path / "ref"), 1, {"p": like}, device=CPU)
    flat = _flat(params)
    assert sorted(got["p"]) == sorted(flat)
    for name, a in flat.items():
        assert torch.equal(got["p"][name], torch.from_numpy(a.copy()))
    pckpt.save(str(tmp_path / "port"), 2, {"p": model})
    back, _ = rckpt.restore(str(tmp_path / "port"), 2, {"p": params})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves({"p": params})):
        np.testing.assert_array_equal(a, b)


def test_moe_serve_loop_gives_the_reference_tokens():
    """The hedged serving loop runs a MoE model: the port's greedy tokens
    equal the reference's decode loop (serve.py:76-95) replayed on the same
    weights and prompt."""
    jax, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced("qwen3-moe-235b-a22b")
    params, model = _ref_params(cfg, 5)
    batch, plen, gen = 3, 6, 6
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (batch, plen))
    res = pserve.serve(cfg, model, torch.from_numpy(toks), gen)
    rcfg = _ref_cfg(cfg)
    cache = rapi.init_cache(rcfg, batch, plen + gen, dtype="float32")
    step = jax.jit(lambda p, c, t, i: rapi.decode_step(rcfg, p, c, t, i))
    for i in range(plen):
        logits, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1]),
                             jnp.asarray(i))
    ref_out = []
    for i in range(gen):
        nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        ref_out.append(np.asarray(nxt)[:, 0])
        logits, cache = step(params, cache, nxt, jnp.asarray(plen + i))
    np.testing.assert_array_equal(res.tokens, np.stack(ref_out, axis=1))


# --------------------------------------------------------------------------
# Flash attention's head-dim-80 route (hubert-xlarge's d 1280 / 16 heads)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
def test_plain_flash_at_head_dim_80_matches_pallas_interpret(causal, H, KV):
    """The port's plain version (what the wrapper runs on the CPU) against
    the reference's Pallas kernel in interpret mode, fp32, S 128 in blocks
    of 64."""
    _, jnp = _jax()
    from repro.kernels.flash_attention.ops import flash_attention as ref_fa
    rng = np.random.default_rng(80 + H + KV + int(causal))
    q = rng.standard_normal((2, 128, H, 80)).astype(np.float32)
    k = rng.standard_normal((2, 128, KV, 80)).astype(np.float32)
    v = rng.standard_normal((2, 128, KV, 80)).astype(np.float32)
    ref = np.asarray(ref_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, bq=64, bkv=64, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for out in (attention_ref(tq, tk, tv, causal),
                flash_attention(tq, tk, tv, causal)):
        np.testing.assert_allclose(_np(out), ref, rtol=FLASH_TOL,
                                   atol=FLASH_TOL)


def test_head_dim_80_passes_the_card_checks():
    """The card path's checks take D = 80 (meta tensors, no card), but not
    under a bf16 sliding window, whose kernel has no D = 80."""
    assert 80 in ops.HEAD_DIMS and 80 not in ops.WINDOW_HEAD_DIMS
    q, k, v = (torch.empty(s, device="meta") for s in
               ((1, 8, 4, 80), (1, 8, 2, 80), (1, 8, 2, 80)))
    ops._check(q, k, v, True)
    ops._check(q, k, v, True, window=4)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ops._check(qb, kb, vb, False, window=4)   # ignored without causal
    with pytest.raises(ValueError, match="sliding window"):
        ops._check(qb, kb, vb, True, window=4)


# --------------------------------------------------------------------------
# Frontends
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,arch,std", [
    ("frame", "hubert-xlarge", lambda d: d ** -0.5),
    ("patch", "internvl2-76b", lambda d: 0.02)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_frontend_shape_dtype_scale_and_seed(kind, arch, std, dtype):
    cfg = get_config(arch)
    make = getattr(frontends, f"synthetic_{kind}_embeddings")
    x = make(cfg, generator(0, CPU), 2, 64, dtype)
    assert x.shape == (2, 64, cfg.d_model)
    assert x.dtype == getattr(torch, dtype) and x.device.type == "cpu"
    assert abs(float(x.float().std()) / std(cfg.d_model) - 1) < 0.05
    assert abs(float(x.float().mean())) < 0.05 * std(cfg.d_model)
    assert torch.equal(x, make(cfg, generator(0, CPU), 2, 64, dtype))
    assert not torch.equal(x, make(cfg, generator(1, CPU), 2, 64, dtype))


def test_frontend_default_dtype_is_the_reference_bf16():
    import inspect
    from repro.models import frontends as rfront
    for name in ("synthetic_frame_embeddings", "synthetic_patch_embeddings"):
        ours = inspect.signature(getattr(frontends, name))
        theirs = inspect.signature(getattr(rfront, name))
        assert ours.parameters["dtype"].default == \
            theirs.parameters["dtype"].default == "bfloat16"


def test_frontend_embeddings_drive_the_model():
    """hubert's frames and internvl2's patches as a reduced model's
    inputs: finite logits of the padded vocab."""
    for arch, make in (("hubert-xlarge", frontends.synthetic_frame_embeddings),
                       ("internvl2-76b",
                        frontends.synthetic_patch_embeddings)):
        cfg = reduced(arch)
        model = api.init_params(cfg, generator(0, CPU))
        x = make(cfg, generator(3, CPU), 2, 10, "float32")
        out = api.forward(cfg, model, x)
        assert out.shape == (2, 10, padded_vocab(cfg))
        assert torch.isfinite(out).all()


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "hubert-xlarge",
                                  "internvl2-76b"])
def test_forward_on_card_matches_the_host(cuda, arch):
    """The prefill forward on the card launches the flash kernel once a
    layer and agrees with the same weights on the CPU (plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(arch).scaled(num_layers=3)
    if arch == "hubert-xlarge":
        cfg = cfg.scaled(num_heads=4, num_kv_heads=4, d_model=320)  # D 80
    model = api.init_params(cfg, generator(4, CPU))
    x, _ = _inputs(cfg, 4, 2, 20)
    ref = api.forward(cfg, model, _torch_in(x))
    model.to(cuda)
    before = flash_attention.launches
    out = api.forward(cfg, model, _torch_in(x).to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    _close_to_max(_np(out), _np(ref), MODEL_TOL)
