"""The port's SSM families against the JAX package's, on the CPU: mamba2
training through the scan (``SSDTrain``) and the zamba2 hybrid (serve and
train) with its sliding-window attention.

The same inputs, made with numpy from a seed, go through both packages at
the reference's reduced sizes (tests/test_models_smoke.py:26-40: 5 layers,
attn_every 2, window 16, chunk 8), with sequences longer than the window
so that it binds: the windowed attention, its lse and ``FlashTrain``'s
gradients; ``SSDTrain``'s gradients; mamba2's and zamba2's loss and
gradients under both remat settings; zamba2's forward logits, its decode
against its forward through a wrapping ring buffer and its caches; three
``CodedTrainer`` steps of each family; ``launch.train`` and
``launch.serve`` on these architectures; the hybrid's checkpoint in the
reference's layout both ways.  The card's tests (marked ``gpu``) drive the
windowed kernel and ``SSDTrain`` on the card:

    python -m pytest -q -m gpu tests/test_torch_ssm.py

The JAX package is imported inside the tests that compare with it.  Each
tolerance is stated where it is used.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as pckpt
from repro_torch._device import generator
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import opt_state_to_port, params_to_port
from repro_torch.data import pipeline as pdata
from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_lse)
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.models import api, layers
from repro_torch.models.mamba2 import SSDTrain
from repro_torch.optim import adamw
from repro_torch.runtime import CodedStepConfig, CodedTrainer

CPU = "cpu"
SSM_ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]

# a copy of tests/test_models_smoke.py:18-41 (reduced dims, family bits
# kept): zamba2 keeps 5 layers, a shared block every 2, a window of 16
REDUCE = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=211,
              flash_block_kv=32, remat="none", compute_dtype="float32",
              param_dtype="float32")


def reduced(arch: str) -> ModelConfig:
    cfg = get_config(arch)
    kw = dict(REDUCE)
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)))
        kw.update(head_dim=16 if cfg.head_dim else None)
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


def _ref_params(cfg: ModelConfig, seed: int = 0):
    """The reference's parameters (numpy) for ``cfg`` and the port's
    trainable module holding the same values."""
    jax, _ = _jax()
    from repro.models import api as rapi
    params = jax.tree.map(np.asarray, rapi.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))
    return params, params_to_port(cfg, params, CPU, trainable=True)


def _flat(tree, prefix=""):
    """A nested dictionary's leaves by dotted name (the port's names)."""
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


def _tokens(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))


# --------------------------------------------------------------------------
# (a) windowed attention and FlashTrain against the reference
# --------------------------------------------------------------------------

# (B, S, H, KV, D, window, block_kv): the window binding at several
# widths, a ragged last block (S % block_kv != 0), GQA, a window of 1
# (the diagonal alone), and W >= S (no window in effect)
WINDOW_CASES = [(2, 40, 4, 2, 16, 16, 32), (2, 64, 4, 4, 16, 8, 16),
                (1, 50, 4, 2, 32, 17, 16), (2, 45, 8, 2, 16, 1, 32),
                (1, 37, 4, 4, 16, 5, 8), (2, 24, 4, 2, 16, 24, 16),
                (1, 30, 4, 1, 16, 64, 32)]
# fp32 on both sides, sums in other orders (blocks, einsum paths): the
# FlashTrain tolerances of tests/test_torch_train.py
FLASH_ATOL, FLASH_RTOL = 2e-5, 1e-4


def _qkv(case, seed):
    B, S, H, KV, D = case[:5]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, S, KV, D), dtype=np.float32),
            rng.standard_normal((B, S, KV, D), dtype=np.float32),
            rng.standard_normal((B, S, H, D), dtype=np.float32))


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windowed_attention_and_lse_match_reference(case):
    """The prefill route (``layers.attention(..., window=W)`` without
    gradients, the kernel's plain version here) and the lse route
    (``flash_attention_lse``) against the reference's ``attention`` and
    ``_flash_train_fwd`` with the same window."""
    jax, jnp = _jax()
    from repro.models import layers as rl
    B, S, H, KV, D, W, bk = case
    q, k, v, _ = _qkv(case, seed=sum(case))
    ref = rl.attention(*map(jnp.asarray, (q, k, v)), causal=True,
                       block_kv=bk, window=W)
    n_rep = H // KV
    _, (_, _, _, _, ref_lse) = rl._flash_train_fwd(
        jnp.asarray(q), rl._repeat_kv(jnp.asarray(k), n_rep),
        rl._repeat_kv(jnp.asarray(v), n_rep), True, W, bk)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = layers.attention(tq, tk, tv, causal=True, block_kv=bk, window=W)
    o, lse = flash_attention_lse(tq, tk, tv, True, W)
    assert out.grad_fn is None and out.shape == (B, S, H, D)
    for got, want in ((out, ref), (o, ref), (lse, ref_lse)):
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=FLASH_ATOL, rtol=FLASH_RTOL)
    if W >= S:      # the window keeps every causal key: no window at all
        assert torch.equal(attention_ref(tq, tk, tv, True, W),
                           attention_ref(tq, tk, tv, True))
        o0, lse0 = flash_attention_lse(tq, tk, tv, True)
        assert torch.equal(o, o0) and torch.equal(lse, lse0)


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windowed_flash_train_matches_reference_vjp(case):
    """``FlashTrain`` with a window: o, lse and (dq, dk, dv) against
    ``jax.value_and_grad`` through the reference's windowed attention."""
    jax, jnp = _jax()
    from repro.models import layers as rl
    B, S, H, KV, D, W, bk = case
    q, k, v, dout = _qkv(case, seed=sum(case) + 1)

    def ref_loss(q_, k_, v_):
        out = rl.attention(q_, k_, v_, causal=True, block_kv=bk, window=W)
        return (out * dout).sum(), out
    (_, ref_out), ref_grads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = layers.FlashTrain.apply(tq, tk, tv, True, bk, W)
    out2 = layers.attention(tq, tk, tv, causal=True, block_kv=bk, window=W)
    assert out2.grad_fn is not None and torch.equal(out, out2)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for got, want in [(out, ref_out), *zip(grads, ref_grads)]:
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=FLASH_ATOL, rtol=FLASH_RTOL)


@pytest.mark.parametrize("sq", [1, 6])
def test_windowed_cache_branches_match_reference(sq):
    """The one-token and blockwise (``kv_len``) branches apply the window
    under ``causal`` as the reference's do."""
    jax, jnp = _jax()
    from repro.models import layers as rl
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, 48, 2, 16), dtype=np.float32)
            for _ in range(2))
    kw = dict(causal=True, q_offset=30, block_kv=16, kv_len=30 + sq,
              window=9)
    ref = rl.attention(*map(jnp.asarray, (q, k, v)),
                       **{**kw, "q_offset": jnp.asarray(30)})
    out = layers.attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)


def test_negative_window_raises():
    q, k, v, _ = map(torch.from_numpy, _qkv((1, 8, 2, 2, 16), seed=0))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, True, -1)
    with pytest.raises(ValueError, match="window"):
        flash_attention_lse(q, k, v, True, -3)
    from repro_torch.kernels.flash_attention import ops
    with pytest.raises(ValueError, match="window"):
        ops._check(*(t.to("meta") for t in (q, k, v)), True, -1)


# --------------------------------------------------------------------------
# (b) SSDTrain: the scan under a gradient
# --------------------------------------------------------------------------

# (B, S, H, P, N, chunk): several chunks, one chunk, P != N
SSD_CASES = [(2, 32, 3, 16, 8, 8), (1, 64, 2, 8, 16, 16),
             (2, 24, 4, 16, 16, 24), (1, 40, 2, 4, 8, 8)]


def _ssd_inputs(case, seed, dtype=np.float32):
    B, S, H, P, N = case[:5]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(dtype)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(dtype)
    Cm = rng.standard_normal((B, S, N)).astype(dtype)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_train_gradients_equal_plain_autograd(case):
    """On the CPU the forward is the plain chunked form and the backward
    its recompute under autograd: the same graph as autograd through
    ``ssd_chunked``, so the output and the gradients for x, dt, A, B and C
    are equal bit for bit (``torch.equal``)."""
    args, dy = _ssd_inputs(case, seed=sum(case))
    chunk = case[-1]
    a1 = [torch.from_numpy(a).requires_grad_(True) for a in args]
    a2 = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y1 = SSDTrain.apply(*a1, chunk)
    y2 = ssd_chunked(*a2, chunk)[0]
    assert torch.equal(y1, y2) and y1.grad_fn is not None
    g1 = torch.autograd.grad(y1, a1, torch.from_numpy(dy))
    g2 = torch.autograd.grad(y2, a2, torch.from_numpy(dy))
    for a, b in zip(g1, g2):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


def test_ssd_train_only_takes_the_gradients_asked_for():
    """Inputs that require no gradient get none, and the backward casts
    each gradient back to its input's dtype (bf16 x, B and C)."""
    args, dy = _ssd_inputs(SSD_CASES[0], seed=1)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in args)
    x, Bm, Cm = (t.bfloat16().requires_grad_(True) for t in (x, Bm, Cm))
    y = SSDTrain.apply(x, dt, A, Bm, Cm, 8)
    assert y.dtype == torch.bfloat16
    gx, gB, gC = torch.autograd.grad(y, (x, Bm, Cm),
                                     torch.from_numpy(dy).bfloat16())
    assert gx.dtype == gB.dtype == gC.dtype == torch.bfloat16
    leaves = [t.detach().float().requires_grad_(True) for t in (x, Bm, Cm)]
    y32 = ssd_chunked(leaves[0], dt, A, leaves[1], leaves[2], 8)[0]
    want = torch.autograd.grad(y32, leaves,
                               torch.from_numpy(dy).bfloat16().float())
    for got, w in zip((gx, gB, gC), want):
        assert torch.equal(got, w.bfloat16())


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_train_gradients_match_jax_grad(case):
    """Against ``jax.grad`` through the reference's ``ssd_chunked``:
    within 1e-5 of each gradient's max |g| (fp32 on both sides, the same
    chunked sums in other orders)."""
    jax, jnp = _jax()
    from repro.models.mamba2 import ssd_chunked as ref_ssd
    args, dy = _ssd_inputs(case, seed=sum(case) + 7)
    chunk = case[-1]
    ref_y, vjp = jax.vjp(lambda *a: ref_ssd(*a, chunk=chunk)[0],
                         *map(jnp.asarray, args))
    ref_g = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = SSDTrain.apply(*leaves, chunk)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    _close_to_max(_np(y), np.asarray(ref_y), 1e-5)
    for got, want in zip(grads, ref_g):
        _close_to_max(_np(got), np.asarray(want), 1e-5)


def test_ssd_train_gradient_is_finite_where_the_reference_overflows():
    """At the model's own law (dt 0.1, A down to -16) a chunk of 128
    overflows exp(lcum_t - lcum_s) above the diagonal: the reference's
    where-after-exp sends 0 * inf = NaN into its dt and A gradients.  The
    port masks the exponent first: the same y, and gradients equal to
    autograd through the sequential recurrence (``ssd_ref``) within 1e-4
    of each max |g|: another algorithm in fp32, whose A gradient sums 128
    steps' terms of both signs (2.8e-5 here)."""
    jax, jnp = _jax()
    from repro.models.mamba2 import ssd_chunked as ref_ssd
    from repro_torch.kernels.ssd_scan import ssd_ref
    (x, _, _, Bm, Cm), dy = _ssd_inputs((1, 128, 2, 4, 4), seed=3)
    dt = np.full((1, 128, 2), 0.1, np.float32)
    A = np.array([-16.0, -1.0], np.float32)
    args = (x, dt, A, Bm, Cm)
    _, vjp = jax.vjp(lambda *a: ref_ssd(*a, chunk=128)[0],
                     *map(jnp.asarray, args))
    ref_g = vjp(jnp.asarray(dy))
    assert not np.isfinite(np.asarray(ref_g[1])).all()
    assert not np.isfinite(np.asarray(ref_g[2])).all()
    a1 = [torch.from_numpy(v).requires_grad_(True) for v in args]
    a2 = [torch.from_numpy(v).requires_grad_(True) for v in args]
    y1 = SSDTrain.apply(*a1, 128)
    y2 = ssd_ref(*a2)[0]
    g1 = torch.autograd.grad(y1, a1, torch.from_numpy(dy))
    g2 = torch.autograd.grad(y2, a2, torch.from_numpy(dy))
    _close_to_max(_np(y1), _np(y2), 1e-5)
    for got, want in zip(g1, g2):
        assert torch.isfinite(got).all()
        _close_to_max(_np(got), _np(want), 1e-4)


def test_mamba2_block_routes_through_ssd_train_only_under_grad(monkeypatch):
    cfg = reduced("mamba2-1.3b")
    model = api.init_params(cfg, generator(0, CPU), trainable=True)
    toks = torch.from_numpy(_tokens(cfg, 0, 2, 20)[0])
    seen = []
    orig = SSDTrain.apply
    monkeypatch.setattr(SSDTrain, "apply",
                        lambda *a: seen.append(True) or orig(*a))
    assert api.forward(cfg, model, toks).grad_fn is None
    assert not seen
    assert api.train_forward(cfg, model, toks).grad_fn is not None
    assert len(seen) == cfg.num_layers


# --------------------------------------------------------------------------
# (c) the families' loss, gradients, forward and decode
# --------------------------------------------------------------------------

# loss within 1e-4 relative; gradients within 1e-5 of each leaf's max
# |grad| (fp32 on both sides, the same functions summed in other orders)
LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    jax, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced(arch).scaled(remat=remat)
    params, model = _ref_params(cfg, seed=3)
    toks, labs = _tokens(cfg, 3, 2, 40)       # S 40 > window 16
    ref_val, ref_g = jax.jit(jax.value_and_grad(
        lambda p: rapi.loss_fn(_ref_cfg(cfg), p, jnp.asarray(toks),
                               jnp.asarray(labs))))(params)
    val = api.loss_fn(cfg, model, torch.from_numpy(toks),
                      torch.from_numpy(labs))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(val, list(model.parameters()))
    np.testing.assert_allclose(float(val.detach()), float(ref_val),
                               rtol=LOSS_RTOL)
    ref_flat = _flat(jax.tree.map(np.asarray, ref_g))
    assert sorted(ref_flat) == sorted(names)
    for name, g in zip(names, grads):
        _close_to_max(_np(g), ref_flat[name], GRAD_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_remat_full_equals_none_bit_for_bit(arch):
    """``"full"`` and ``"dots"`` (which keeps each mamba layer's
    projections and recomputes the rest, the scan kernel's call included)
    give the loss and gradients of ``"none"`` bit for bit on the CPU;
    ``"dots"``'s equal the reference's ``"dots"`` ones (LOSS_RTOL,
    GRAD_TOL).  (``"dots"`` raised before it was ported.)"""
    jax, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced(arch)
    params, model = _ref_params(cfg, seed=1)
    toks, labs = _tokens(cfg, 1, 2, 24)
    out = []
    for remat in ("none", "full", "dots"):
        loss = api.loss_fn(cfg.scaled(remat=remat), model,
                           torch.from_numpy(toks), torch.from_numpy(labs))
        out.append((loss, torch.autograd.grad(loss,
                                              list(model.parameters()))))
    for other in out[1:]:
        assert torch.equal(out[0][0], other[0])
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], other[1]))
    ref_val, ref_g = jax.jit(jax.value_and_grad(
        lambda p: rapi.loss_fn(_ref_cfg(cfg.scaled(remat="dots")), p,
                               jnp.asarray(toks), jnp.asarray(labs))))(params)
    np.testing.assert_allclose(float(out[2][0].detach()), float(ref_val),
                               rtol=LOSS_RTOL)
    ref_flat = _flat(jax.tree.map(np.asarray, ref_g))
    for (name, _), g in zip(model.named_parameters(), out[2][1]):
        _close_to_max(_np(g), ref_flat[name], GRAD_TOL)


def test_zamba2_forward_matches_reference():
    """Logits of the hybrid's prefill (S 40 > window 16) within 2e-4
    (tests/test_models_smoke.py:114's bound), elementwise."""
    jax, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced("zamba2-1.2b")
    params, model = _ref_params(cfg, seed=4)
    toks, _ = _tokens(cfg, 4, 2, 40)
    ref = rapi.forward(_ref_cfg(cfg), params, jnp.asarray(toks))
    out = api.forward(cfg, model, torch.from_numpy(toks))
    assert out.grad_fn is None
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_zamba2_decode_matches_forward_and_reference_caches():
    """Token-by-token decode over S 40 with window 16 (the ring buffer
    wraps twice) reproduces the full forward within 2e-4
    (tests/test_models_smoke.py:114); the caches have the reference's
    shapes and, after the same 20 steps (one wrap), its values (2e-4)."""
    jax, jnp = _jax()
    from repro.models import api as rapi
    cfg = reduced("zamba2-1.2b")
    rcfg = _ref_cfg(cfg)
    params, model = _ref_params(cfg, seed=5)
    B, S = 2, 40
    toks, _ = _tokens(cfg, 5, B, S)
    full = api.forward(cfg, model, torch.from_numpy(toks))
    cache = api.init_cache(cfg, B, S, dtype="float32", device=CPU)
    ref_cache = rapi.init_cache(rcfg, B, S, dtype="float32")
    ours = jax.tree.map(lambda t: tuple(t.shape), cache)
    assert ours == jax.tree.map(lambda a: tuple(a.shape), ref_cache)
    assert ours["attn_k"] == (2, B, 16, 2, 16)
    rp = jax.tree.map(jnp.asarray, params)
    ref_step = jax.jit(lambda c, tok, pos: rapi.decode_step(rcfg, rp, c, tok,
                                                            pos))
    outs = []
    for t in range(S):
        lg, cache = api.decode_step(cfg, model, cache,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
        outs.append(lg[:, 0])
        if t < 20:
            _, ref_cache = ref_step(ref_cache, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(t))
        if t == 19:
            got = jax.tree.map(_np, cache)
            for name, want in _flat(jax.tree.map(np.asarray,
                                                 ref_cache)).items():
                np.testing.assert_allclose(_flat(got)[name], want,
                                           rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(torch.stack(outs, dim=1)), _np(full),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_param_shapes_match_reference(arch):
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as rapi
    ref = rapi.param_shapes(ref_get_config(arch))
    ref = {n: (tuple(a.shape), str(a.dtype)) for n, a in _flat(ref).items()}
    ours = _flat(api.param_shapes(get_config(arch)))
    assert sorted(ref) == sorted(ours)
    for name, t in ours.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
            ref[name]
    if arch == "zamba2-1.2b":
        assert ours["shared_attn.wq"].shape == (2048, 32, 64)
        assert ours["layers.A_log"].shape == (38, 64)


# --------------------------------------------------------------------------
# (d) the coded trainer, the CLIs and the checkpoint
# --------------------------------------------------------------------------

TRAINER_MASKS = [np.ones(4, bool), np.array([1, 0, 1, 1], bool),
                 np.array([0, 0, 1, 1], bool)]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_coded_trainer_three_steps_match_reference(arch):
    """Three ``CodedTrainer`` steps from one converted state, the same
    injected straggler masks, 8 coded rows of 32 tokens (> window 16):
    per-step loss and grad norm within 1e-4 relative, the parameters after
    step 3 within 1e-5 absolute where no step's reference gradient lies
    within rounding of zero (0 < |g| <= 1e-6; AdamW's first steps are
    ~lr * sign(g)), as tests/test_torch_train.py's dense case."""
    jax, jnp = _jax()
    from repro.data import DataConfig as RefData
    from repro.optim import adamw as radamw
    from repro.runtime import CodedStepConfig as RefStep
    from repro.runtime import CodedTrainer as RefTrainer
    from repro.runtime.coded_step import weighted_loss_fn as ref_wl
    cfg = reduced(arch)
    ref_cfg = _ref_cfg(cfg)
    params, model = _ref_params(cfg, seed=1)
    opt_kw = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
    r_opt = radamw.init(radamw.AdamWConfig(**opt_kw), params)
    p_opt = opt_state_to_port(r_opt, CPU)
    masks = lambda s: TRAINER_MASKS[s]  # noqa: E731
    rtr, probe = (RefTrainer(ref_cfg, RefData(cfg.vocab_size, 32, 8),
                             RefStep(4, 2, 8), radamw.AdamWConfig(**opt_kw),
                             alive_fn=masks, donate=False)
                  for _ in range(2))
    ptr = CodedTrainer(cfg, pdata.DataConfig(cfg.vocab_size, 32, 8),
                       CodedStepConfig(4, 2, 8), adamw.AdamWConfig(**opt_kw),
                       alive_fn=masks)
    small = None
    rp = jax.tree.map(jnp.asarray, params)
    ref_grad = jax.jit(jax.grad(ref_wl(ref_cfg)))
    for step in range(3):
        toks, labs = pdata.coded_batch(ptr.data_cfg, step, ptr.step_cfg.code)
        w = probe.weights_for(masks(step))
        g = _flat(jax.tree.map(np.asarray, ref_grad(
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


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_launch_train_on_the_cpu_plans_as_the_reference(arch, capsys):
    """``launch.train --arch mamba2-1.3b|zamba2-1.2b --scale tiny`` trains
    (TINY sets attn_every 0, so zamba2 runs as a pure SSM, as in the
    reference) and prints the reference's plan line."""
    from repro.launch import train as rtrain
    argv = ["--arch", arch, "--scale", "tiny", "--steps", "6",
            "--seq-len", "32"]
    run = ptrain.main(["--device", CPU] + argv)
    ours = capsys.readouterr().out.splitlines()
    rtrain.main(argv[:4] + ["--steps", "1", "--seq-len", "32"])
    ref = capsys.readouterr().out.splitlines()
    assert ours[0] == ref[0] == "redundancy plan: n=8 c=2 (rate 7/8)"
    assert run.cfg.family == get_config(arch).family
    assert run.cfg.attn_every == 0 and not hasattr(run.params, "shared_attn")
    losses = [h["loss"] for h in run.history]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_launch_serve_zamba2_at_tiny_is_a_pure_ssm(capsys):
    """The reference's TINY scale sets attn_every 0: ``launch.serve --arch
    zamba2-1.2b`` serves the hybrid's config with no shared block, in both
    packages."""
    from repro.launch.serve import TINY as REF_TINY
    assert REF_TINY == pserve.TINY and REF_TINY["attn_every"] == 0
    res = pserve.main(["--arch", "zamba2-1.2b", "--device", CPU, "--batch",
                       "2", "--prompt-len", "8", "--gen", "4"])
    assert res.tokens.shape == (2, 4)
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_serve_loop_runs_the_hybrid_with_a_wrapping_ring():
    """``serve`` on the reduced hybrid itself (shared block every 2 layers,
    window 16) over 12 + 12 tokens: its greedy tokens are those of the
    full forward's argmax, step by step."""
    cfg = reduced("zamba2-1.2b").scaled(attn_window=8)
    model = api.init_params(cfg, generator(6, CPU))
    prompt = torch.from_numpy(_tokens(cfg, 6, 2, 12)[0]).long()
    res = pserve.serve(cfg, model, prompt, 12)
    seq = torch.cat([prompt, torch.from_numpy(res.tokens)], dim=1)
    logits = api.forward(cfg, model, seq)
    want = torch.argmax(logits[:, 11:-1], dim=-1).numpy()
    assert (res.tokens == want).mean() >= 0.95, (res.tokens, want)


@pytest.mark.parametrize("direction", ["reference_writes", "port_writes"])
def test_hybrid_checkpoint_both_ways(direction, tmp_path):
    """The hybrid's three-level tree (layers, shared_attn, the top leaves)
    and its AdamW state restore in the other package bit for bit."""
    jax, _ = _jax()
    from repro import checkpoint as rckpt
    from repro.optim import adamw as radamw
    cfg = reduced("zamba2-1.2b")
    params, model = _ref_params(cfg, seed=7)
    rng = np.random.default_rng(7)
    mom = lambda: jax.tree.map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    state = {"p": params, "o": radamw.OptState(np.asarray(5, np.int32),
                                               mom(), mom())}
    if direction == "reference_writes":
        rckpt.save(str(tmp_path), 5, state)
        like = {"p": model, "o": adamw.init(adamw.AdamWConfig(), model)}
        got, manifest = pckpt.restore(str(tmp_path), 5, like, device=CPU)
        assert manifest["step"] == 5 and got["o"].step == 5
        for tree, ours in ((state["p"], got["p"]), (state["o"].mu,
                                                    got["o"].mu),
                           (state["o"].nu, got["o"].nu)):
            flat = _flat(tree)
            assert sorted(flat) == sorted(ours)
            assert any(n.startswith("shared_attn.") for n in flat)
            for name, a in flat.items():
                assert torch.equal(ours[name], torch.from_numpy(a.copy()))
    else:
        ours = {"p": model, "o": opt_state_to_port(state["o"], CPU)}
        pckpt.save(str(tmp_path), 5, ours)
        assert rckpt.is_intact(str(tmp_path), 5)
        got, _ = rckpt.restore(str(tmp_path), 5, state)
        assert int(got["o"].step) == 5
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# (e) on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# |out - ref| <= atol + rtol |ref|: fp32 2e-5, bf16 one bf16 step
# (tests/test_torch_flash_attention.py's card tolerances)
CARD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 1e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window", [
    ((1, 300, 300, 4, 2, 64), 17), ((2, 200, 330, 4, 2, 32), 129),
    ((1, 1000, 1000, 4, 4, 128), 64), ((2, 513, 513, 2, 1, 16), 1),
    ((1, 256, 256, 4, 2, 64), 4096)])
def test_windowed_kernel_matches_plain_version_on_card(cuda, dtype, shape,
                                                       window):
    B, Sq, Sk, H, KV, D = shape
    gen = torch.Generator(device=cuda).manual_seed(Sq + window)
    q = torch.randn((B, Sq, H, D), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((B, Sk, KV, D), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    before = flash_attention.launches
    o, lse = flash_attention_lse(q, k, v, True, window)
    o2 = flash_attention(q, k, v, True, window)
    ref, ref_lse = attention_lse_ref(q, k, v, True, window)
    assert flash_attention.launches == before + 2
    atol, rtol = CARD_TOL[dtype]
    assert torch.equal(o, o2)
    assert float(((o.float() - ref.float()).abs()
                  / (atol + rtol * ref.float().abs())).max()) <= 1
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert float((lse - ref_lse).abs().max()) <= lse_tol


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype", [((2, 64, 3, 16, 8, 16), torch.float32),
                                        ((2, 512, 8, 64, 64, 256),
                                         torch.bfloat16)])
def test_ssd_train_on_card_matches_plain_autograd(cuda, case, dtype):
    """The kernel's forward under ``SSDTrain`` against the plain chunked
    form (fp32 2e-5 / bf16 1e-2 of max|y|, the kernel's card
    tolerances), and its gradients (the same plain recompute) against
    autograd through the plain form, within 1e-5 of max|g|."""
    args, dy = _ssd_inputs(case, seed=11)
    chunk = case[-1]
    dev = [torch.from_numpy(a).to(cuda) for a in args]
    dev = [t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(dev)]
    dyt = torch.from_numpy(dy).to(cuda).to(dtype)
    a1 = [t.clone().requires_grad_(True) for t in dev]
    a2 = [t.clone().requires_grad_(True) for t in dev]
    before = ssd_scan.launches
    y1 = SSDTrain.apply(*a1, chunk)
    assert ssd_scan.launches == before + 1
    y2 = ssd_chunked(*a2, chunk)[0]
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    scale = float(y2.float().abs().max())
    assert float((y1.float() - y2.float()).abs().max()) <= tol * scale
    for a, b in zip(torch.autograd.grad(y1, a1, dyt),
                    torch.autograd.grad(y2, a2, dyt)):
        assert a.dtype == b.dtype
        s = float(b.float().abs().max()) + 1e-30
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * s
