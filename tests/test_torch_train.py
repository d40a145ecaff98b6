"""The port's coded data-parallel training path against the JAX package's,
on the CPU.

The same inputs, made with numpy from a seed, go through both packages:
the training attention (``FlashTrain``: forward, lse and the recompute
backward), the losses, AdamW, the data pipeline, the coded gradient, the
``CodedTrainer`` (three steps from one converted state, the same
injected straggler masks), the elastic re-plan, the checkpoint layout
both ways, the trainer actuator and the ``launch.train`` CLI.  The card's
tests (marked ``gpu``) drive the lse-writing kernel and the training
step's launches:

    python -m pytest -q -m gpu tests/test_torch_train.py

The JAX package is imported inside the tests that compare with it, so
the card's tests also run on a machine without JAX.  Each tolerance is
stated where it is used.
"""
import dataclasses
import os
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as pckpt
from repro_torch._device import generator
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.control import TrainerActuator
from repro_torch.convert import opt_state_to_port, params_to_port
from repro_torch.core.coding import gc_decode_weights
from repro_torch.core.distributions import BiModal, Pareto, ShiftedExp
from repro_torch.core.policy import Policy, RetryPolicy
from repro_torch.data import pipeline as pdata
from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_lse)
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.models import api, layers
from repro_torch.optim import adamw
from repro_torch.runtime import (CodedStepConfig, CodedTrainer, Telemetry,
                                 make_eval_step, make_train_step,
                                 resize_plan, round_unique_batch,
                                 weighted_loss_fn)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"

# tests/test_runtime.py:18-21: the reference's own small dense config
CFG = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=257,
                  flash_block_kv=16, remat="none",
                  compute_dtype="float32", param_dtype="float32")


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _tiny():
    """``launch.train``'s TINY scale of qwen3-0.6b, in both packages."""
    from repro.configs.base import get_config as ref_get_config
    from repro.launch.train import TINY as REF_TINY
    assert REF_TINY == pserve.TINY
    cfg = get_config("qwen3-0.6b")
    return cfg.scaled(**{k: v for k, v in pserve.TINY.items()
                         if hasattr(cfg, k)}), \
        ref_get_config("qwen3-0.6b").scaled(**REF_TINY)


def _ref_params(ref_cfg, seed=0):
    """The reference's parameters (numpy) and the port's trainable module
    holding the same values."""
    jax, _ = _jax()
    from repro.models import api as rapi
    params = jax.tree.map(np.asarray, rapi.init_params(
        ref_cfg, jax.random.PRNGKey(seed)))
    return params, params_to_port(_port_cfg(ref_cfg), params, CPU,
                                  trainable=True)


def _port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(ref_cfg))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _np(t):
    return t.detach().float().cpu().numpy()


def _close_to_max(out, ref, tol):
    """|out - ref| <= tol * max|ref|, elementwise."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) + 1e-30
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol, rtol=0)


# --------------------------------------------------------------------------
# (a) FlashTrain against jax.grad through the reference's attention
# --------------------------------------------------------------------------

# (B, S, H, KV, D, causal, block_kv): GQA n_rep 1 and 2, causal and not,
# S ragged against block_kv, block_kv < S
FLASH_CASES = [(2, 64, 4, 4, 16, True, 16), (2, 64, 4, 2, 16, False, 16),
               (2, 50, 4, 2, 16, True, 16), (1, 37, 4, 4, 32, False, 8),
               (2, 45, 8, 2, 16, True, 32)]
# fp32 on both sides, sums in other orders (blocks, einsum paths)
FLASH_ATOL, FLASH_RTOL = 2e-5, 1e-4


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_train_matches_reference_vjp(case):
    jax, jnp = _jax()
    from repro.models import layers as rl
    B, S, H, KV, D, causal, bk = case
    rng = np.random.default_rng(sum(case[:5]) + causal)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    dout = rng.standard_normal((B, S, H, D), dtype=np.float32)

    def ref_loss(q_, k_, v_):
        out = rl.attention(q_, k_, v_, causal=causal, block_kv=bk)
        return (out * dout).sum(), out
    (_, ref_out), ref_grads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    n_rep = H // KV
    _, (_, _, _, _, ref_lse) = rl._flash_train_fwd(
        jnp.asarray(q), rl._repeat_kv(jnp.asarray(k), n_rep),
        rl._repeat_kv(jnp.asarray(v), n_rep), causal, 0, bk)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = layers.FlashTrain.apply(tq, tk, tv, causal, bk)
    # the port's attention takes FlashTrain when an input requires grad
    out2 = layers.attention(tq, tk, tv, causal=causal, block_kv=bk)
    assert torch.equal(out, out2) and out2.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for got, want in [(out, ref_out), (lse, ref_lse), *zip(grads, ref_grads)]:
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=FLASH_ATOL, rtol=FLASH_RTOL)


def test_attention_without_grad_takes_the_forward_alone():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16),
                                                    dtype=np.float32))
               for _ in range(3))
    out = layers.attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        out2 = layers.attention(q.requires_grad_(True), k, v)
    assert out2.grad_fn is None and torch.equal(out, out2)
    o, lse = attention_lse_ref(q, k, v, True)
    o2, lse2 = flash_attention_lse(q, k, v, True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    # the two plain versions normalise in another order: fp32 rounding
    torch.testing.assert_close(o, flash_attention(q, k, v, True),
                               atol=1e-6, rtol=1e-6)
    # the sliding window (ported with the hybrid) takes the same routes:
    # the kernel's plain version without a gradient, its lse route in
    # FlashTrain's forward
    q = q.detach()
    assert torch.equal(layers.attention(q, k, v, window=4),
                       attention_ref(q, k, v, True, 4))
    o, lse = flash_attention_lse(q, k, v, True, 4)
    o2, lse2 = attention_lse_ref(q, k, v, True, 4)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(layers.attention(q.requires_grad_(True), k, v,
                                        window=4).detach(), o)
    assert not torch.equal(o, attention_lse_ref(q, k, v, True)[0])


# --------------------------------------------------------------------------
# (b) losses: value and gradient against jax.value_and_grad
# --------------------------------------------------------------------------

# fp32 on both sides; loss values to 1e-5 relative, gradients to 1e-4 of
# each leaf's max |grad| (two layers of sums in other orders)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_reference(masked):
    jax, jnp = _jax()
    from repro.models.layers import cross_entropy_loss as ref_ce
    rng = np.random.default_rng(3 + masked)
    logits = rng.standard_normal((2, 9, 33), dtype=np.float32) * 3
    labels = rng.integers(0, 33, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    ref_val, ref_g = jax.value_and_grad(
        lambda x: ref_ce(x, labels, None if mask is None else mask))(logits)
    t = torch.from_numpy(logits).requires_grad_(True)
    val = layers.cross_entropy_loss(
        t, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(val, t)
    np.testing.assert_allclose(float(val.detach()), float(ref_val),
                               rtol=LOSS_RTOL)
    _close_to_max(_np(g), ref_g, GRAD_TOL)


def test_weighted_loss_and_grads_match_reference_at_tiny():
    jax, jnp = _jax()
    from repro.runtime.coded_step import weighted_loss_fn as ref_wl
    cfg, ref_cfg = _tiny()
    params, model = _ref_params(ref_cfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    w = rng.random(4).astype(np.float32) * 2
    ref_val, ref_g = jax.value_and_grad(ref_wl(ref_cfg))(
        params, jnp.asarray(toks), jnp.asarray(labs), jnp.asarray(w))
    val = weighted_loss_fn(cfg)(model, torch.from_numpy(toks),
                                torch.from_numpy(labs), torch.from_numpy(w))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(val, list(model.parameters()))
    np.testing.assert_allclose(float(val.detach()), float(ref_val),
                               rtol=LOSS_RTOL)
    ref_flat = _flat(jax.tree.map(np.asarray, ref_g))
    assert sorted(ref_flat) == sorted(names)
    for name, g in zip(names, grads):
        _close_to_max(_np(g), ref_flat[name], GRAD_TOL)
    # api.loss_fn is the unweighted mean
    from repro.models import api as rapi
    np.testing.assert_allclose(
        float(api.loss_fn(cfg, model, torch.from_numpy(toks),
                          torch.from_numpy(labs)).detach()),
        float(rapi.loss_fn(ref_cfg, params, jnp.asarray(toks),
                           jnp.asarray(labs))), rtol=LOSS_RTOL)


def test_remat_full_equals_none_and_dots_raises():
    """``remat="full"`` recomputes each layer in the backward and
    ``"dots"`` recomputes all but the projections' outputs: the same loss
    and gradients as keeping the activations, bit for bit on the CPU;
    ``"dots"`` also gives the reference's ``"dots"`` loss and gradients
    (LOSS_RTOL, GRAD_TOL).  (It raised before ``"dots"`` was ported; the
    name stays.)"""
    jax, jnp = _jax()
    from repro.configs.base import ModelConfig as RefConfig
    from repro.models import api as rapi
    ref_cfg = RefConfig(**dataclasses.asdict(CFG.scaled(remat="dots")))
    params, model = _ref_params(ref_cfg, seed=1)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 257, (2, 20)).astype(np.int32)
    labs = rng.integers(0, 257, (2, 20)).astype(np.int32)
    out = []
    for remat in ("none", "full", "dots"):
        cfg = CFG.scaled(remat=remat)
        loss = api.loss_fn(cfg, model, torch.from_numpy(toks),
                           torch.from_numpy(labs))
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    for other in out[1:]:
        assert torch.equal(out[0][0], other[0])
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], other[1]))
    ref_val, ref_g = jax.value_and_grad(
        lambda p: rapi.loss_fn(ref_cfg, p, jnp.asarray(toks),
                               jnp.asarray(labs)))(params)
    np.testing.assert_allclose(float(out[2][0].detach()), float(ref_val),
                               rtol=LOSS_RTOL)
    ref_flat = _flat(jax.tree.map(np.asarray, ref_g))
    for (name, _), g in zip(model.named_parameters(), out[2][1]):
        _close_to_max(_np(g), ref_flat[name], GRAD_TOL)


def test_serving_forward_takes_no_gradient_and_ssm_training_raises():
    model = api.init_params(CFG, generator(2, CPU), trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    assert not any(p.requires_grad for p in
                   api.init_params(CFG, generator(2, CPU)).parameters())
    toks = torch.zeros((1, 8), dtype=torch.long)
    assert api.forward(CFG, model, toks).grad_fn is None
    assert api.train_forward(CFG, model, toks).grad_fn is not None
    # the SSM family now trains: its loss takes a gradient
    ssm = get_config("mamba2-1.3b").scaled(num_layers=1, d_model=64,
                                           ssm_state=16, ssm_head_dim=16,
                                           vocab_size=128, ssm_chunk=8)
    ssm_model = api.init_params(ssm, generator(0, CPU), trainable=True)
    assert api.forward(ssm, ssm_model, toks).grad_fn is None
    assert api.loss_fn(ssm, ssm_model, toks, toks).grad_fn is not None
    # a family the JAX package does not name trains as the transformer, as
    # the reference's model_module sends it
    assert torch.equal(api.loss_fn(CFG.scaled(family="mlp"), model, toks,
                                   toks),
                       api.loss_fn(CFG, model, toks, toks))


def test_param_shapes_match_reference():
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as rapi
    for arch in ("qwen3-0.6b", "mamba2-1.3b"):
        ref = _flat_meta(rapi.param_shapes(ref_get_config(arch)))
        ours = _flat_meta(api.param_shapes(get_config(arch)))
        assert sorted(ref) == sorted(ours)
        for name, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[name].shape)
            assert str(t.dtype).removeprefix("torch.") == str(ref[name].dtype)


def _flat_meta(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_meta(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# --------------------------------------------------------------------------
# (c) AdamW against the reference
# --------------------------------------------------------------------------

# the same fp32 arithmetic in the same order; rounding may differ by an
# ulp where one side fuses a multiply-add: 1e-6 relative (of each
# tensor's max for elements near zero)
ADAM_TOL = 1e-6
ADAM_CFG = dict(lr=1e-2, warmup_steps=10, decay_steps=100, weight_decay=0.1,
                min_lr_ratio=0.1)


def _adam_state(seed, clip):
    rng = np.random.default_rng(seed)
    shapes = {"b": (5,), "w": (4, 5), "layers.x": (3, 2, 2)}
    p = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    g = {n: (rng.standard_normal(s) * (3.0 if clip else 0.05)
             ).astype(np.float32) for n, s in shapes.items()}
    m = {n: rng.standard_normal(s).astype(np.float32) * 0.1
         for n, s in shapes.items()}
    v = {n: rng.random(s).astype(np.float32) * 0.01 for n, s in shapes.items()}
    return p, g, m, v


@pytest.mark.parametrize("prev_step", [0, 9, 60])      # step 1, warmup, decay
@pytest.mark.parametrize("clip", [False, True])
def test_apply_updates_matches_reference(prev_step, clip):
    jax, jnp = _jax()
    from repro.optim import adamw as radamw
    p, g, m, v = _adam_state(prev_step + 7 * clip, clip)
    rcfg = radamw.AdamWConfig(**ADAM_CFG)
    rp, rstate, rmet = radamw.apply_updates(
        rcfg, p, g, radamw.OptState(jnp.asarray(prev_step, jnp.int32), m, v))
    t = lambda d: {n: torch.from_numpy(a.copy()) for n, a in d.items()}  # noqa: E731
    pp, pstate, pmet = adamw.apply_updates(
        adamw.AdamWConfig(**ADAM_CFG), t(p), t(g),
        adamw.OptState(prev_step, t(m), t(v)))
    assert pstate.step == int(rstate.step) == prev_step + 1
    assert (float(pmet["grad_norm"]) > 1.0) == clip
    np.testing.assert_allclose(float(pmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=ADAM_TOL)
    assert pmet["lr"] == float(rmet["lr"])
    for ours, theirs in [(pp, rp), (pstate.mu, rstate.mu),
                         (pstate.nu, rstate.nu)]:
        for name in p:
            want = np.asarray(theirs[name])
            np.testing.assert_allclose(
                _np(ours[name]), want, rtol=ADAM_TOL,
                atol=ADAM_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_matches_reference(step):
    jax, jnp = _jax()
    from repro.optim import adamw as radamw
    cfg = dict(ADAM_CFG, lr=3e-4)
    assert adamw.schedule(adamw.AdamWConfig(**cfg), step) == float(
        radamw.schedule(radamw.AdamWConfig(**cfg), jnp.asarray(step)))


def test_clip_global_norm_and_accumulation_match_reference():
    jax, jnp = _jax()
    from repro.optim import adamw as radamw
    g = {"a": np.asarray([3.0, 4.0], np.float32),
         "b": np.asarray([[12.0]], np.float32)}               # norm 13
    ours, gn = adamw.clip_by_global_norm(
        {n: torch.from_numpy(a) for n, a in g.items()}, 1.0)
    theirs, rgn = radamw.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-7)
    for n in g:
        np.testing.assert_allclose(_np(ours[n]), np.asarray(theirs[n]),
                                   rtol=1e-6)
    # tests/test_substrate.py:96-110's accumulation case
    xs = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    rl, rg = radamw.accumulate_grads(
        lambda p, micro: (p["w"][:2] * micro).sum() ** 2 / 100.0,
        {"w": jnp.ones((4,))}, jnp.asarray(xs), 4)
    w = {"w": torch.ones(4, requires_grad=True)}
    pl, pg = adamw.accumulate_grads(
        lambda p, micro: (p["w"][:2] * micro).sum() ** 2 / 100.0,
        w, torch.from_numpy(xs), 4)
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-6)
    np.testing.assert_allclose(_np(pg["w"]), np.asarray(rg["w"]), rtol=1e-6)


def test_init_and_moment_dtype():
    model = api.init_params(CFG, generator(0, CPU), trainable=True)
    st = adamw.init(adamw.AdamWConfig(moment_dtype="bfloat16"), model)
    assert st.step == 0
    assert list(st.mu) == [n for n, _ in model.named_parameters()]
    assert all(t.dtype == torch.bfloat16 and not t.any()
               for t in st.nu.values())
    g = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    _, st2, _ = adamw.apply_updates(adamw.AdamWConfig(moment_dtype="bfloat16"),
                                    model, g, st)
    assert st2.step == 1 and st2.mu["embed"].dtype == torch.bfloat16
    assert float(st2.mu["embed"].float().abs().max()) > 0


# --------------------------------------------------------------------------
# (d) the data pipeline, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(257, 16, 8, 0),
                                                  (151936, 33, 12, 3),
                                                  (512, 128, 6, 11)])
def test_data_pipeline_is_the_reference_bit_for_bit(vocab, seq, batch, seed):
    from repro.core.coding import FractionalRepetitionCode as RefCode
    from repro.data import pipeline as rdata
    from repro_torch.core.coding import FractionalRepetitionCode
    rcfg = rdata.DataConfig(vocab, seq, batch, seed)
    pcfg = pdata.DataConfig(vocab, seq, batch, seed)
    for step in (0, 1, 17):
        for part, parts in ((0, 1), (1, 2), (2, 3)):
            if batch % parts:
                continue
            for a, b in zip(pdata.synthetic_batch(pcfg, step, part, parts),
                            rdata.synthetic_batch(rcfg, step, part, parts)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    it_p, it_r = pdata.batch_iterator(pcfg, 4), rdata.batch_iterator(rcfg, 4)
    for _ in range(2):
        for a, b in zip(next(it_p), next(it_r)):
            np.testing.assert_array_equal(a, b)
    for n, c in ((6, 2), (6, 3), (6, 1)):
        if batch % (n // c):
            continue
        code, rcode = FractionalRepetitionCode(n, c), RefCode(n, c)
        for a, b in zip(pdata.coded_batch(pcfg, 2, code),
                        rdata.coded_batch(rcfg, 2, rcode)):
            np.testing.assert_array_equal(a, b)
        alive = np.ones(n, bool)
        alive[0] = c == 1          # a straggler wherever its group survives
        coef = gc_decode_weights(code, alive)
        rows, unique = batch * c // n, batch
        w = pdata.decode_example_weights(code, coef, rows, unique)
        np.testing.assert_array_equal(
            w, rdata.decode_example_weights(rcode, coef, rows, unique))
        np.testing.assert_array_equal(
            pdata.expand_worker_weights(torch.from_numpy(coef), rows,
                                        n * rows / unique).numpy(), w)


# --------------------------------------------------------------------------
# (e) the coded gradient equals the plain gradient (tests/test_runtime.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,alive", [
    (4, 2, [1, 0, 1, 1]),
    (4, 4, [0, 0, 1, 0]),
    (8, 2, [1, 1, 0, 1, 1, 0, 1, 1]),
    (6, 1, [1, 1, 1, 1, 1, 1]),
])
def test_coded_gradient_exact(n, c, alive):
    """Coded gradient with stragglers == plain gradient over unique data
    (the reference's tolerances: fp32 accumulation order differs between
    layouts, ~1e-4 relative noise)."""
    groups = n // c
    step_cfg = CodedStepConfig(n_workers=n, c=c, unique_batch=2 * groups)
    data_cfg = pdata.DataConfig(vocab_size=257, seq_len=16,
                                global_batch=step_cfg.unique_batch)
    code = step_cfg.code
    toks_c, labs_c = pdata.coded_batch(data_cfg, 0, code)
    a = gc_decode_weights(code, np.asarray(alive, bool))
    w = pdata.decode_example_weights(code, a, step_cfg.per_worker_rows,
                                     step_cfg.unique_batch)
    model = api.init_params(CFG, generator(0, CPU), trainable=True)
    lf = weighted_loss_fn(CFG)
    g_coded = torch.autograd.grad(
        lf(model, torch.from_numpy(toks_c), torch.from_numpy(labs_c),
           torch.from_numpy(w)), list(model.parameters()))
    parts = [pdata.synthetic_batch(data_cfg, 0, part=j,
                                   num_parts=code.num_groups)
             for j in range(code.num_groups)]
    toks_u = np.concatenate([p[0] for p in parts])
    labs_u = np.concatenate([p[1] for p in parts])
    g_plain = torch.autograd.grad(
        lf(model, torch.from_numpy(toks_u), torch.from_numpy(labs_u),
           torch.ones(len(toks_u))), list(model.parameters()))
    for a_, b_ in zip(g_coded, g_plain):
        np.testing.assert_allclose(_np(a_), _np(b_), rtol=5e-4, atol=1e-5)


# --------------------------------------------------------------------------
# (f) CodedTrainer, three steps from one state, against the reference
# --------------------------------------------------------------------------

# n 4, c 2: all alive, one straggler, a whole group straggled (barrier)
TRAINER_MASKS = [np.ones(4, bool), np.array([1, 0, 1, 1], bool),
                 np.array([0, 0, 1, 1], bool)]


def test_coded_trainer_three_steps_match_reference():
    """Per-step loss within 1e-4 relative and the parameters after step 3
    within 1e-5 absolute.  AdamW's first steps are ~lr * sign(g): an
    element whose gradient lies within rounding of zero may step the
    other way in one package, so the parameters are compared where no
    step's reference gradient has 0 < |g| <= 1e-6 (exact zeros, the
    embedding rows of unseen tokens, are compared; the rest is counted and
    must be a small share)."""
    jax, jnp = _jax()
    from repro.data import DataConfig as RefData
    from repro.optim import adamw as radamw
    from repro.runtime import CodedStepConfig as RefStep
    from repro.runtime import CodedTrainer as RefTrainer
    from repro.runtime.coded_step import weighted_loss_fn as ref_wl
    cfg, ref_cfg = _tiny()
    params, model = _ref_params(ref_cfg, seed=1)
    opt_kw = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
    r_opt = radamw.init(radamw.AdamWConfig(**opt_kw), params)
    p_opt = opt_state_to_port(r_opt, CPU)
    assert p_opt.step == 0 and sorted(p_opt.mu) == sorted(
        n for n, _ in model.named_parameters())
    masks = lambda s: TRAINER_MASKS[s]  # noqa: E731
    rtr, probe = (RefTrainer(ref_cfg, RefData(cfg.vocab_size, 32, 8),
                             RefStep(4, 2, 8), radamw.AdamWConfig(**opt_kw),
                             alive_fn=masks, jit=False) for _ in range(2))
    ptr = CodedTrainer(cfg, pdata.DataConfig(cfg.vocab_size, 32, 8),
                       CodedStepConfig(4, 2, 8), adamw.AdamWConfig(**opt_kw),
                       alive_fn=masks)
    small = None
    rp = jax.tree.map(jnp.asarray, params)
    for step in range(3):
        # the reference's gradient of this step, for the near-zero mask
        toks, labs = pdata.coded_batch(ptr.data_cfg, step, ptr.step_cfg.code)
        w = probe.weights_for(masks(step))
        g = _flat(jax.tree.map(np.asarray, jax.grad(ref_wl(ref_cfg))(
            rp, jnp.asarray(toks), jnp.asarray(labs), jnp.asarray(w))))
        tiny = {n: (np.abs(x) <= 1e-6) & (x != 0) for n, x in g.items()}
        small = tiny if small is None else {n: small[n] | tiny[n]
                                            for n in tiny}
        rp, r_opt, rm = rtr.run_step(rp, r_opt, step)
        model, p_opt, pm = ptr.run_step(model, p_opt, step)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    assert (ptr.decode_failures, ptr.stragglers_dropped) == \
        (rtr.decode_failures, rtr.stragglers_dropped) == (1, 1)
    assert p_opt.step == int(r_opt.step) == 3
    ref_flat = _flat(jax.tree.map(np.asarray, rp))
    skipped = total = 0
    for name, p in model.named_parameters():
        keep = ~small[name]
        skipped += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(_np(p)[keep], ref_flat[name][keep],
                                   atol=1e-5, rtol=0)
    assert skipped < 0.01 * total, (skipped, total)


def test_eval_and_train_step_makers():
    model = api.init_params(CFG, generator(3, CPU), trainable=True)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 257, (2, 16)))
    labs = torch.from_numpy(rng.integers(0, 257, (2, 16)))
    ev = make_eval_step(CFG)(model, toks, labs)
    assert ev.grad_fn is None
    np.testing.assert_allclose(
        float(ev), float(api.loss_fn(CFG, model, toks, labs).detach()),
        rtol=1e-6)
    st = adamw.init(adamw.AdamWConfig(), model)
    before = model.embed.detach().clone()
    model, st, m = make_train_step(CFG, adamw.AdamWConfig())(
        model, st, toks, labs, torch.ones(2))
    assert set(m) == {"loss", "grad_norm", "lr"} and st.step == 1
    assert not torch.equal(before, model.embed)
    np.testing.assert_allclose(float(m["loss"]), float(ev), rtol=1e-6)


# --------------------------------------------------------------------------
# (g) barrier fallback, the retry re-poll, a step_cfg swap
# --------------------------------------------------------------------------

def _small_trainer(alive_fn, retry=None, telemetry=None):
    cfg = CFG.scaled(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                     d_ff=64)
    return cfg, CodedTrainer(cfg, pdata.DataConfig(257, 16, 8),
                             CodedStepConfig(n_workers=4, c=2,
                                             unique_batch=8),
                             adamw.AdamWConfig(lr=1e-3), alive_fn=alive_fn,
                             retry=retry, telemetry=telemetry)


def test_group_wipeout_falls_back_to_the_barrier():
    dead = np.array([0, 0, 1, 1], bool)
    cfg, tr = _small_trainer(lambda s: dead)
    model = api.init_params(cfg, generator(0, CPU), trainable=True)
    opt = adamw.init(tr.opt_cfg, model)
    model, opt, m = tr.run_step(model, opt, 0)
    assert tr.decode_failures == 1 and tr.stragglers_dropped == 0
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_array_equal(tr.decode_coefficients(dead), [1, 0, 1, 0])


@pytest.mark.parametrize("second", [[1, 0, 1, 1], [0, 0, 1, 1]])
def test_retry_repoll_matches_reference(second):
    """One re-poll after the first backoff delay: it rescues the step when
    the late worker arrives, else the barrier fallback follows; the
    counters and the telemetry's retries equal the reference's."""
    from repro.core.policy import RetryPolicy as RefRetry
    from repro.runtime import Telemetry as RefTelemetry
    from repro.configs.base import ModelConfig as RefConfig
    from repro.data import DataConfig as RefData
    from repro.optim import adamw as radamw
    from repro.runtime import CodedStepConfig as RefStep
    from repro.runtime import CodedTrainer as RefTrainer

    def masks():
        polls = []

        def alive_fn(step):
            polls.append(step)
            return np.array([0, 0, 1, 1] if len(polls) == 1 else second, bool)
        return alive_fn, polls

    out = []
    for port in (True, False):
        fn, polls = masks()
        tel = Telemetry(min_samples=2) if port else RefTelemetry(min_samples=2)
        if port:
            _, tr = _small_trainer(fn, RetryPolicy(max_attempts=3,
                                                   backoff_base=0.5), tel)
        else:
            tr = RefTrainer(RefConfig(**dataclasses.asdict(_small_trainer(
                None)[0])), RefData(257, 16, 8), RefStep(4, 2, 8),
                radamw.AdamWConfig(lr=1e-3), alive_fn=fn, jit=False,
                retry=RefRetry(max_attempts=3, backoff_base=0.5),
                telemetry=tel)
        alive = tr.gather_alive(0)
        tr.decode_coefficients(alive)
        tr.gather_alive(1)                            # the masks stay bad
        tel.record_outcomes(np.ones(4, bool), np.zeros(4, bool))
        out.append((alive.tolist(), tr.decode_retries, tr.retry_wait,
                    tr.decode_failures, len(polls),
                    tel.fleet_health().retries_per_task))
    assert out[0] == out[1]
    bad = second == [0, 0, 1, 1]          # the second step's gather too
    assert out[0][1] == 1 + bad and out[0][2] == pytest.approx(
        (1 + bad) * RetryPolicy(backoff_base=0.5).delay(0))
    assert out[0][3] == bad


def test_step_cfg_swap_rebuilds_the_step():
    cfg, tr = _small_trainer(None)
    model = api.init_params(cfg, generator(0, CPU), trainable=True)
    opt = adamw.init(tr.opt_cfg, model)
    old_fn = tr.step_fn
    tr.step_cfg = CodedStepConfig(n_workers=4, c=4, unique_batch=4)
    assert tr.step_fn is not old_fn and tr.data_cfg.global_batch == 4
    toks, _ = pdata.coded_batch(tr.data_cfg, 0, tr.step_cfg.code)
    assert toks.shape == (16, 16)                     # 4 unique x c 4
    model, opt, m = tr.run_step(model, opt, 0)
    assert opt.step == 1 and np.isfinite(float(m["loss"]))


# --------------------------------------------------------------------------
# (h) elastic re-planning equals the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("old,new_n,dist", [
    ((8, 2, 8), 6, None), ((8, 2, 8), 6, "bimodal"), ((8, 4, 6), 12, None),
    ((8, 2, 9), 4, "sexp"), ((12, 3, 8), 9, "pareto"), ((8, 8, 5), 16, None)])
@pytest.mark.parametrize("keep", [True, False])
def test_resize_plan_matches_reference(old, new_n, dist, keep):
    from repro.core.distributions import BiModal as RB, Pareto as RP
    from repro.core.distributions import ShiftedExp as RS
    from repro.runtime import CodedStepConfig as RefStep
    from repro.runtime.elastic import resize_plan as ref_resize
    from repro.runtime.elastic import round_unique_batch as ref_round
    dists = {None: (None, None), "bimodal": (BiModal(8.0, 0.25),
                                             RB(8.0, 0.25)),
             "sexp": (ShiftedExp(1.0, 2.0), RS(1.0, 2.0)),
             "pareto": (Pareto(1.0, 2.5), RP(1.0, 2.5))}
    ours_d, ref_d = dists[dist]
    delta = None if dist in (None, "sexp") else 1.0
    ours = resize_plan(CodedStepConfig(*old), new_n, dist=ours_d, delta=delta,
                       keep_unique_batch=keep, device=CPU)
    ref = ref_resize(RefStep(*old), new_n, dist=ref_d, delta=delta,
                     keep_unique_batch=keep)
    assert (ours.n_workers, ours.c, ours.unique_batch) == \
        (ref.n_workers, ref.c, ref.unique_batch)
    for ub, g in ((9, 4), (8, 4), (1, 3), (0, 5)):
        assert round_unique_batch(ub, g) == ref_round(ub, g)
    with pytest.raises(ValueError):
        round_unique_batch(8, 0)


def test_failure_adjusted_model_matches_reference():
    from repro.runtime.elastic import failure_adjusted_model as ref_fam
    from repro_torch.runtime import failure_adjusted_model
    for eps in (0.0, 0.1, 0.99):
        ours, ref = failure_adjusted_model(eps), ref_fam(eps)
        assert (ours.B, ours.eps) == (ref.B, ref.eps)


# --------------------------------------------------------------------------
# (i) checkpoints: the reference's layout, both ways
# --------------------------------------------------------------------------

def _train_state(seed):
    """The reference's {"p": params, "o": OptState} with non-zero moments
    and step, as numpy."""
    jax, jnp = _jax()
    from repro.optim import adamw as radamw
    _, ref_cfg = _tiny()
    params, _ = _ref_params(ref_cfg, seed)
    rng = np.random.default_rng(seed)
    mom = lambda: jax.tree.map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    return {"p": params, "o": radamw.OptState(np.asarray(7, np.int32), mom(),
                                              mom())}


def test_checkpoint_reference_writes_port_restores(tmp_path):
    from repro import checkpoint as rckpt
    state = _train_state(0)
    rckpt.save(str(tmp_path), 7, state)
    cfg, _ = _tiny()
    model = api.init_params(cfg, generator(0, CPU), trainable=True)
    like = {"p": model, "o": adamw.init(adamw.AdamWConfig(), model)}
    assert pckpt.latest_step(str(tmp_path)) == 7
    got, manifest = pckpt.restore(str(tmp_path), 7, like, device=CPU)
    assert manifest["step"] == 7 and got["o"].step == 7
    assert isinstance(got["o"], adamw.OptState)
    for tree, ours in ((state["p"], got["p"]), (state["o"].mu, got["o"].mu),
                       (state["o"].nu, got["o"].nu)):
        flat = _flat(tree)
        assert sorted(flat) == sorted(ours)
        for name, a in flat.items():
            assert torch.equal(ours[name], torch.from_numpy(a.copy()))


def test_checkpoint_port_writes_reference_restores(tmp_path):
    from repro import checkpoint as rckpt
    state = _train_state(1)
    cfg, _ = _tiny()
    model = params_to_port(cfg, state["p"], CPU, trainable=True)
    ours = {"p": model, "o": opt_state_to_port(state["o"], CPU)}
    pckpt.save(str(tmp_path), 3, ours, extra={"note": "port"})
    assert rckpt.is_intact(str(tmp_path), 3)
    got, manifest = rckpt.restore(str(tmp_path), 3, state)
    assert manifest["extra"] == {"note": "port"}
    assert np.asarray(got["o"].step).dtype == np.int32
    assert int(got["o"].step) == 7
    jax, _ = _jax()
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_atomic_latest_torn_and_shapes(tmp_path):
    """tests/test_substrate.py:62-82 and tests/test_fault_tolerance.py's
    torn-leaf, corrupt-manifest and stale-debris cases, on the port."""
    d = str(tmp_path)
    tree = {"a": np.arange(10), "b": {"c": np.ones((3, 3))}}
    pckpt.save(d, 5, tree)
    pckpt.save(d, 10, tree)
    os.makedirs(os.path.join(d, "step_000000015"))    # torn: no manifest
    assert pckpt.latest_step(d) == 10
    restored, man = pckpt.restore(d, 10, tree)
    np.testing.assert_array_equal(restored["a"], tree["a"])
    assert man["step"] == 10
    with pytest.raises(ValueError):
        pckpt.restore(d, 10, {"a": np.ones(3), "b": {"c": np.ones((3, 3))}})
    with pytest.raises(ValueError):
        pckpt.restore(d, 10, {"a": np.ones(10)})
    leaf = os.path.join(d, "step_000000010", "leaf_00000.npy")
    with open(leaf, "r+b") as f:
        f.truncate(os.path.getsize(leaf) // 2)
    assert not pckpt.is_intact(d, 10) and pckpt.is_intact(d, 5)
    assert pckpt.latest_step(d) == 5
    with open(os.path.join(d, "step_000000005", "manifest.json"), "w") as f:
        f.write("{not json")
    assert pckpt.latest_step(d) is None
    debris = os.path.join(d, ".tmp_step_000000007")
    os.makedirs(debris)
    pckpt.save(d, 7, tree)
    assert pckpt.latest_step(d) == 7 and not os.path.exists(debris)


def test_checkpoint_async_snapshots_before_in_place_updates(tmp_path):
    w = torch.ones(4, 4)
    fut = pckpt.save_async(str(tmp_path), 1, {"w": w, "n": 3})
    w.add_(1.0)                                       # after the snapshot
    fut.result()
    got, _ = pckpt.restore(str(tmp_path), 1, {"w": w, "n": 0})
    assert got["n"] == 3 and np.array_equal(got["w"], np.ones((4, 4)))
    with pytest.raises(TypeError):
        pckpt.save(str(tmp_path), 2, {"w": w.bfloat16()})


# --------------------------------------------------------------------------
# (j) TrainerActuator re-plans a port trainer as the reference's does
# --------------------------------------------------------------------------

def test_trainer_actuator_matches_reference():
    from repro.control import TrainerActuator as RefActuator
    from repro.core.policy import Policy as RefPolicy
    from repro.runtime import CodedStepConfig as RefStep

    class RefStub:
        step_cfg = RefStep(n_workers=12, c=12, unique_batch=8)

    _, tr = _small_trainer(None)
    tr.step_cfg = CodedStepConfig(n_workers=12, c=12, unique_batch=8)
    ours, ref = TrainerActuator(tr), RefActuator(RefStub())
    for k in (3, 4, 4, 6, 12, 3):
        fn = tr.step_fn
        before = tr.step_cfg
        ours.apply(Policy(12, k), None)
        ref.apply(RefPolicy(12, k), None)
        got, want = tr.step_cfg, ref.trainer.step_cfg
        assert (got.n_workers, got.c, got.unique_batch) == \
            (want.n_workers, want.c, want.unique_batch)
        assert (tr.step_fn is fn) == (got == before)     # rebuilt on change
        assert tr.data_cfg.global_batch == got.unique_batch
    assert ours.adjustments == ref.adjustments == [1, 4, 4, 1]


# --------------------------------------------------------------------------
# (k) the CLI and the example twins on the CPU
# --------------------------------------------------------------------------

def _same_start(monkeypatch, rtrain, losses):
    """Both packages' ``launch.train`` from the same state: the port's
    ``init_params`` hands it the reference's parameters (``PRNGKey(0)``,
    as the reference's ``launch.train`` draws them), both straggler simulators
    sample the same numpy task times (so the same masks and telemetry),
    and the reference's trainer appends each step's loss to ``losses``."""
    jax, _ = _jax()
    from repro.models import api as rapi

    def init_params(cfg, gen, trainable=False):
        params = jax.tree.map(np.asarray, rapi.init_params(
            _ref_cfg_of(cfg), jax.random.PRNGKey(0)))
        return params_to_port(cfg, params, CPU, trainable=trainable)

    def sample_times(self, step):
        rng = np.random.default_rng(1000 + step)
        return np.where(rng.random(self.n) < 0.2, 10.0, 1.0) * self.s

    class Recording(rtrain.CodedTrainer):
        def run_step(self, params, opt_state, step):
            out = super().run_step(params, opt_state, step)
            losses.append(float(out[2]["loss"]))
            return out

    monkeypatch.setattr(ptrain.api, "init_params", init_params)
    monkeypatch.setattr(ptrain.StragglerSim, "sample_times", sample_times)
    monkeypatch.setattr(rtrain.StragglerSim, "sample_times", sample_times)
    monkeypatch.setattr(rtrain, "CodedTrainer", Recording)


def _ref_cfg_of(cfg: ModelConfig):
    from repro.configs.base import ModelConfig as RefConfig
    return RefConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b",
                                  "qwen3-moe-235b-a22b", "hubert-xlarge",
                                  "internvl2-76b"])
def test_launch_train_on_the_cpu_plans_as_the_reference(arch, capsys,
                                                        tmp_path,
                                                        monkeypatch):
    """At ``--scale tiny`` every family is a token-input model (no experts,
    no embedding inputs; hubert stays bidirectional).  From the same
    parameters and straggler draws (``_same_start``) the port prints the
    reference's plan and re-plan lines, and its 12 losses are the
    reference's within 1e-4 relative (the coded trainer's tolerance,
    tests/test_torch_train.py::test_coded_trainer_three_steps_match_reference);
    its checkpoint resumes."""
    from repro.launch import train as rtrain
    ref_losses = []
    _same_start(monkeypatch, rtrain, ref_losses)
    argv = ["--arch", arch, "--scale", "tiny", "--steps", "12",
            "--replan-every", "4", "--ckpt-every", "6"]
    run = ptrain.main(["--device", CPU, "--ckpt-dir", str(tmp_path)] + argv)
    ours = capsys.readouterr().out.splitlines()
    rtrain.main(argv)
    ref = capsys.readouterr().out.splitlines()
    assert ours[0] == ref[0] == "redundancy plan: n=8 c=2 (rate 7/8)"
    assert [x for x in ours if x.startswith("re-plan")] == \
        [x for x in ref if x.startswith("re-plan")]
    assert any(line.startswith("step    10 loss") for line in ours)
    assert not run.cfg.num_experts and not run.cfg.embedding_inputs
    assert run.cfg.causal == (arch != "hubert-xlarge")
    assert len(run.history) == 12 and run.start == 0
    losses = [h["loss"] for h in run.history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert [h["step"] for h in run.history] == list(range(1, 13))
    assert pckpt.latest_step(str(tmp_path)) == 12
    resumed = ptrain.main(["--device", CPU, "--ckpt-dir", str(tmp_path)]
                          + argv[:4] + ["--steps", "14"] + argv[6:])
    assert "resumed from step 12" in capsys.readouterr().out
    assert resumed.start == 12 and len(resumed.history) == 2
    assert resumed.opt_state.step == 14
    assert ptrain.parse_dist("none") is None
    assert ptrain.exo_delta(ShiftedExp(1.0, 2.0), 1.0) is None


def test_launch_train_refuses_other_families_and_the_missing_card():
    """At ``--scale full`` an embedding-input config refuses ``launch.train``'s
    token batches and names the train cell; a tiny MoE trains."""
    for arch in ("hubert-xlarge", "internvl2-76b"):
        with pytest.raises(ValueError, match="build_train_cell"):
            ptrain.main(["--arch", arch, "--scale", "full", "--device",
                         CPU])
    run = ptrain.main(["--arch", "dbrx-132b", "--steps", "2", "--device",
                       CPU])
    assert run.cfg.family == "moe" and len(run.history) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ptrain.main(["--scale", "tiny", "--steps", "1"])


@pytest.mark.parametrize("name,argv,expect", [
    ("torch_train_coded_dp", ["--steps", "12", "--d-model", "64",
                              "--layers", "2", "--vocab", "512", "--seq",
                              "32", "--resize-at", "6"],
     "OK: loss decreased"),
    ("torch_adaptive_train", ["--steps", "80", "--flip-at", "30"],
     "OK: drift detected")])
def test_example_twins_on_the_cpu(name, argv, expect, tmp_path, capsys,
                                  monkeypatch):
    if name == "torch_train_coded_dp":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr("sys.argv", [name] + argv + ["--device", CPU])
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                   run_name="__main__")
    assert expect in capsys.readouterr().out


# --------------------------------------------------------------------------
# (l) on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,lse_tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 1e-2)])
def test_lse_forward_on_card_matches_plain(cuda, dtype, lse_tol):
    """The kernel's lse against the plain version's (1e-4 in fp32, 1e-2
    in bf16) and its o against the forward without lse, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for B, S, H, KV, D in ((2, 200, 4, 2, 32), (3, 129, 16, 8, 128)):
        q = torch.randn((B, S, H, D), generator=gen, device=cuda).to(dtype)
        k = torch.randn((B, S, KV, D), generator=gen, device=cuda).to(dtype)
        v = torch.randn((B, S, KV, D), generator=gen, device=cuda).to(dtype)
        before = flash_attention.launches
        o, lse = flash_attention_lse(q, k, v, True)
        assert flash_attention.launches == before + 1
        _, ref_lse = attention_lse_ref(q, k, v, True)
        torch.cuda.synchronize()
        assert float((lse - ref_lse).abs().max()) <= lse_tol
        assert torch.equal(o, flash_attention(q, k, v, True))


@pytest.mark.gpu
def test_training_step_on_card_launches_twice_a_layer(cuda):
    """Under ``remat="full"`` a step launches the kernel once a layer in
    the forward and once in the recompute; the loss and gradients agree
    with the same step on the CPU (plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CFG.scaled(remat="full", num_layers=3)
    model = api.init_params(cfg, generator(4, CPU), trainable=True)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 257, (4, 24)))
    labs = torch.from_numpy(rng.integers(0, 257, (4, 24)))
    w = torch.from_numpy(rng.random(4).astype(np.float32))
    lf = weighted_loss_fn(cfg)
    ref = lf(model, toks, labs, w)
    ref_g = torch.autograd.grad(ref, list(model.parameters()))
    model.to(cuda)
    before = flash_attention.launches
    loss = lf(model, toks.to(cuda), labs.to(cuda), w.to(cuda))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2 * cfg.num_layers
    np.testing.assert_allclose(float(loss.detach()), float(ref.detach()),
                               rtol=1e-5)
    for g, r in zip(grads, ref_g):
        _close_to_max(_np(g), _np(r), 1e-4)
