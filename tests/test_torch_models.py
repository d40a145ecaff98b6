"""The port's serving path against the JAX package's, on the CPU.

Layers (rms_norm, apply_rope, swiglu, each branch of attention), then the
reduced qwen3-0.6b and mamba2-1.3b configs: the reference's
``init_params`` go through ``convert.params_to_port``, and ``forward``
logits, ``decode_step`` logits and caches, and prefill against decode are
compared in fp32.  Then the hedged serving loop.  The card's tests (marked
``gpu``) drive the same path through the kernels:

    python -m pytest -q -m gpu tests/test_torch_models.py

Tolerances: 2e-5 for single layers (fp32, sums in another order); 1e-4
relative to max|logits| for two-layer forward and decode logits against
the reference (the same fp32 function through a few hundred more
roundings); 2e-4 for prefill against decode, the reference's own bound
(tests/test_models_smoke.py:114).
"""
import numpy as np
import pytest
import torch

from repro_torch._device import generator
from repro_torch.configs import get_config
from repro_torch.convert import params_to_port
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import serve
from repro_torch.models import api, layers
from repro_torch.models.transformer import padded_vocab

LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
DECODE_TOL = 2e-4                   # tests/test_models_smoke.py:114
ARCHS = ["qwen3-0.6b", "mamba2-1.3b"]

# a copy of tests/test_models_smoke.py:18-41 (reduced dims, family bits kept)
REDUCE = dict(
    num_layers=2, d_model=64, d_ff=128, vocab_size=211,
    flash_block_kv=32, remat="none", compute_dtype="float32",
    param_dtype="float32",
)


def reduced(arch: str):
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


def _close(out, ref, tol, relative_to_max=False):
    out = out.detach().float().cpu().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    if relative_to_max:
        scale = float(np.abs(ref).max()) + 1e-12
        np.testing.assert_allclose(out / scale, ref / scale, atol=tol)
    else:
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as ref
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32) * 3
    w = rng.standard_normal(48, dtype=np.float32)
    _close(layers.rms_norm(_t(x), _t(w), 1e-6),
           ref.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), LAYER_TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as ref
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = rng.integers(0, 4000, (2, 7))
    _close(layers.apply_rope(_t(x), torch.from_numpy(pos), theta),
           ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), LAYER_TOL)
    _close(layers.rope_frequencies(16, theta),
           ref.rope_frequencies(16, theta), 1e-7)


def test_swiglu_matches_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as ref
    rng = _rng(2)
    x, wg, wu, wd = (rng.standard_normal(s, dtype=np.float32) * 0.3
                     for s in ((2, 5, 32), (32, 64), (32, 64), (64, 32)))
    _close(layers.swiglu(*map(_t, (x, wg, wu, wd))),
           ref.swiglu(*map(jnp.asarray, (x, wg, wu, wd))), LAYER_TOL)


def _qkv(seed, sq, sk, h=4, kv=2, hd=16):
    rng = _rng(seed)
    return (rng.standard_normal((2, sq, h, hd), dtype=np.float32),
            rng.standard_normal((2, sk, kv, hd), dtype=np.float32),
            rng.standard_normal((2, sk, kv, hd), dtype=np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_full_sequence_branch_matches_reference(causal):
    """Prefill: the flash kernel's plain version on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as ref
    q, k, v = _qkv(3, 40, 40)
    before = flash_attention.launches
    out = layers.attention(*map(_t, (q, k, v)), causal=causal, q_offset=0,
                           block_kv=16)
    assert flash_attention.launches == before
    _close(out, ref.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              q_offset=0, block_kv=16), LAYER_TOL)


@pytest.mark.parametrize("pos", [0, 9, 23])
def test_attention_decode_branch_matches_reference(pos):
    """One query row over a cache of 24 slots, ``pos + 1`` of them valid."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as ref
    q, k, v = _qkv(4, 1, 24)
    out = layers.attention(*map(_t, (q, k, v)), causal=True, q_offset=pos,
                           kv_len=pos + 1)
    _close(out, ref.attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              q_offset=jnp.asarray(pos),
                              kv_len=jnp.asarray(pos + 1)), LAYER_TOL)


@pytest.mark.parametrize("block_kv", [8, 10, 64])
def test_attention_blockwise_kv_len_branch_matches_reference(block_kv):
    """Several query rows written at ``q_offset`` into a longer cache, keys
    in blocks (one that does not divide the cache, one wider than it)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as ref
    q, k, v = _qkv(5, 6, 30)
    out = layers.attention(*map(_t, (q, k, v)), causal=True, q_offset=11,
                           block_kv=block_kv, kv_len=17)
    _close(out, ref.attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              q_offset=jnp.asarray(11), block_kv=block_kv,
                              kv_len=jnp.asarray(17)), LAYER_TOL)


def test_attention_window_raises():
    q, k, v = map(_t, _qkv(6, 8, 8))
    with pytest.raises(NotImplementedError, match="window"):
        layers.attention(q, k, v, window=4)


def test_init_laws():
    g = generator(0, "cpu")
    z = layers.truncated_normal(g, (200_000,))
    assert float(z.abs().max()) <= 3.0
    # the variance of a standard normal truncated at +-3
    assert abs(float(z.std()) - 0.98658) < 0.01
    w = layers.dense_init(g, (256, 64), 256)
    assert abs(float(w.std()) - 0.98658 / 16) < 0.003
    m = api.init_params(reduced("mamba2-1.3b"), g)
    A = -torch.exp(m.layers.A_log)
    assert float(A.min()) >= -16.0 and float(A.max()) < -1.0 + 1e-6
    dt = torch.nn.functional.softplus(m.layers.dt_bias)
    assert 1e-3 - 1e-6 <= float(dt.min()) and float(dt.max()) <= 1e-1 + 1e-6
    assert torch.equal(m.layers.D, torch.ones_like(m.layers.D))


# --------------------------------------------------------------------------
# Models at the reduced configs
# --------------------------------------------------------------------------

def _reference(arch, seed):
    jax = pytest.importorskip("jax")
    from repro.models import api as ref_api
    cfg = reduced(arch)
    params = ref_api.init_params(cfg, jax.random.PRNGKey(seed))
    numpy_params = jax.tree.map(np.asarray, params)
    return cfg, ref_api, params, params_to_port(cfg, numpy_params, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_port_carries_every_parameter(arch):
    jax = pytest.importorskip("jax")
    cfg, _, params, model = _reference(arch, 0)
    flat = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(params)}
    ours = dict(model.named_parameters())
    assert len(flat) == len(ours)
    for name, p in ours.items():
        key = "".join(f"['{part}']" for part in name.split("."))
        assert np.array_equal(p.numpy(), flat[key]), name
    assert ours["embed"].shape == (padded_vocab(cfg), cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_port_rejects_missing_extra_and_misshaped(arch):
    jax = pytest.importorskip("jax")
    from repro.models import api as ref_api
    cfg = reduced(arch)
    params = jax.tree.map(np.asarray,
                          ref_api.init_params(cfg, jax.random.PRNGKey(0)))
    missing = dict(params, layers=dict(params["layers"]))
    name = sorted(missing["layers"])[0]
    del missing["layers"][name]
    with pytest.raises(ValueError, match=name):
        params_to_port(cfg, missing, "cpu")
    with pytest.raises(ValueError, match="extra_weight"):
        params_to_port(cfg, dict(params, extra_weight=np.zeros(3)), "cpu")
    with pytest.raises(ValueError, match="lm_head"):
        params_to_port(cfg, dict(params, lm_head=params["lm_head"][:, :8]),
                       "cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [12, 16])
def test_forward_matches_reference(arch, S):
    """S = 12 pads the mamba2 scan's last chunk of 8; S = 16 does not."""
    jnp = pytest.importorskip("jax.numpy")
    cfg, ref_api, params, model = _reference(arch, 2)
    toks = _rng(S).integers(0, cfg.vocab_size, (2, S))
    before = (flash_attention.launches, ssd_scan.launches)
    out = api.forward(cfg, model, torch.from_numpy(toks))
    assert (flash_attention.launches, ssd_scan.launches) == before
    ref = ref_api.forward(cfg, params, jnp.asarray(toks))
    assert out.shape == ref.shape == (2, S, padded_vocab(cfg))
    _close(out, ref, MODEL_TOL, relative_to_max=True)


def _leaves(cache):
    if isinstance(cache, dict):
        return [x for k in sorted(cache) for x in _leaves(cache[k])]
    if isinstance(cache, (tuple, list)):
        return [x for c in cache for x in _leaves(c)]
    return [cache]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """Five decode steps: the logits of each and the whole cache after."""
    jnp = pytest.importorskip("jax.numpy")
    cfg, ref_api, params, model = _reference(arch, 1)
    B, S, steps = 2, 8, 5
    toks = _rng(7).integers(0, cfg.vocab_size, (B, steps))
    cache = api.init_cache(cfg, B, S, dtype="float32", device="cpu")
    ref_cache = ref_api.init_cache(cfg, B, S, dtype="float32")
    for t in range(steps):
        lg, cache = api.decode_step(cfg, model, cache,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
        ref_lg, ref_cache = ref_api.decode_step(
            cfg, params, ref_cache, jnp.asarray(toks[:, t:t + 1]),
            jnp.asarray(t))
        assert lg.shape == ref_lg.shape == (B, 1, padded_vocab(cfg))
        _close(lg, ref_lg, MODEL_TOL, relative_to_max=True)
    ours, theirs = _leaves(cache), _leaves(ref_cache)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape
        _close(a, b, MODEL_TOL, relative_to_max=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full forward logits, in the
    port alone (tests/test_models_smoke.py:97-114), and the prompt-by-decode
    cache agrees with the reference's."""
    cfg = reduced(arch)
    model = api.init_params(cfg, generator(2, "cpu"))
    B, S = 2, 12
    toks = torch.from_numpy(_rng(12).integers(0, cfg.vocab_size, (B, S)))
    full = api.forward(cfg, model, toks)
    cache = api.init_cache(cfg, B, S, dtype="float32", device="cpu")
    outs = []
    for t in range(S):
        lg, cache = api.decode_step(cfg, model, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy(), DECODE_TOL)


def test_unported_families_raise():
    qwen = get_config("qwen3-0.6b")
    with pytest.raises(NotImplementedError, match="MoE"):
        api.init_params(qwen.scaled(num_experts=4, experts_per_token=2),
                        generator(0, "cpu"))
    with pytest.raises(NotImplementedError, match="hybrid"):
        api.init_params(reduced("mamba2-1.3b").scaled(attn_every=2),
                        generator(0, "cpu"))
    with pytest.raises(NotImplementedError, match="family 'moe'"):
        api.forward(qwen.scaled(family="moe"), None, None)
    with pytest.raises(KeyError, match="zamba2"):
        get_config("zamba2-1.2b")


# --------------------------------------------------------------------------
# The hedged serving loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["pareto:0.05:1.8", "pareto:1:2.5",
                                  "sexp:1:5", "bimodal:10:0.3"])
def test_hedge_plan_matches_reference(spec):
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve
    from repro.launch.train import parse_dist as ref_parse
    dist, ref_dist = serve.parse_dist(spec), ref_parse(spec)
    for r in (1, 2, 3, 4):
        assert serve.hedge_gain(dist, r) == ref_serve.hedge_gain(ref_dist, r)
    for max_r in (2, 4, 6):
        assert serve.plan_replicas(dist, max_r) == \
            ref_serve.plan_replicas(ref_dist, max_r)
    assert serve.parse_dist("none") is None


@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_serve_loop_gives_the_reference_tokens(arch, capsys):
    """The reference's ``serve.main`` at TINY scale and the port's
    ``serve.serve`` on the same weights and prompt generate the same greedy
    tokens: all of them against the reference's loop (serve.py:76-95)
    replayed step by step, and the 16 that its ``main`` prints."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs.base import get_config as ref_get_config
    from repro.launch import serve as ref_serve
    from repro.launch.train import TINY as REF_TINY
    from repro.models import api as ref_api
    assert serve.TINY == REF_TINY
    batch, plen, gen = 4, 32, 32
    ref_serve.main(["--arch", arch])
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("sample:")]
    cfg = ref_get_config(arch).scaled(**REF_TINY)
    key = jax.random.PRNGKey(0)                      # serve.py:69-71
    params = ref_api.init_params(cfg, key)
    toks = jax.random.randint(key, (batch, plen), 1, cfg.vocab_size)
    model = params_to_port(get_config(arch).scaled(**serve.TINY),
                           jax.tree.map(np.asarray, params), "cpu")
    res = serve.serve(model.cfg, model, torch.from_numpy(np.array(toks)),
                      gen, serve.parse_dist("pareto:0.05:1.8"), r=2)
    assert res.tokens.shape == (batch, gen)
    assert printed == [f"sample: {res.tokens[0][:16].tolist()}"]
    cache = ref_api.init_cache(cfg, batch, plen + gen, dtype="float32")
    step = jax.jit(lambda p, c, t, i: ref_api.decode_step(cfg, p, c, t, i))
    for i in range(plen):
        logits, cache = step(params, cache, toks[:, i:i + 1], jnp.asarray(i))
    ref_out = []
    for i in range(gen):
        nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        ref_out.append(np.asarray(nxt)[:, 0])
        logits, cache = step(params, cache, nxt, jnp.asarray(plen + i))
    np.testing.assert_array_equal(res.tokens, np.stack(ref_out, axis=1))
    assert res.sim_latency > 0 and res.unhedged > res.sim_latency / gen


def test_serve_main_runs_on_the_cpu_when_asked(capsys):
    res = serve.main(["--arch", "mamba2-1.3b", "--gen", "4",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "hedging plan: r = 2" in out and "sample:" in out
    assert res.tokens.shape == (4, 4)
    assert ((0 <= res.tokens) & (res.tokens < 512)).all()


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_card_launches_one_kernel_per_layer(cuda, arch):
    """The prefill forward on the card goes through the kernel once per
    layer, agrees with the same weights on the CPU (plain versions), and
    with token-by-token decode on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(arch).scaled(num_layers=3)
    model = api.init_params(cfg, generator(4, "cpu"))
    toks = torch.from_numpy(_rng(4).integers(0, cfg.vocab_size, (2, 20)))
    ref = api.forward(cfg, model, toks)
    model.to(cuda)
    counter = flash_attention if cfg.family == "dense" else ssd_scan
    before = counter.launches
    out = api.forward(cfg, model, toks.to(cuda))
    torch.cuda.synchronize()
    assert counter.launches == before + cfg.num_layers
    _close(out, ref.numpy(), MODEL_TOL, relative_to_max=True)
    cache = api.init_cache(cfg, 2, 20, dtype="float32", device=cuda)
    outs = []
    for t in range(20):
        lg, cache = api.decode_step(cfg, model, cache,
                                    toks[:, t:t + 1].to(cuda), t)
        outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), out.cpu().numpy(), DECODE_TOL)


@pytest.mark.gpu
def test_serve_main_on_card(cuda, capsys):
    res = serve.main(["--gen", "8"])
    assert "hedging plan" in capsys.readouterr().out
    assert res.tokens.shape == (4, 8)
