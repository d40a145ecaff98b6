"""The port's flash attention: its plain version against the JAX package's
Pallas kernel (interpret mode) and oracle, and its CUDA kernel against the
plain version on the card.

The JAX package is imported inside the tests that compare with it, so the
card's tests (marked ``gpu``) also run on a machine without JAX:

    python -m pytest -q -m gpu tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops

BLOCKS = [(64, 64), (128, 256), (32, 128)]     # tests/test_kernels.py:32
GRID = (2, 256, 4, 2, 32)                      # (B, S, H, KV, D), :36
TOL = {"float32": 2e-5, "bfloat16": 5e-2}      # :48 and :60
# The CUDA kernel against its plain version in bf16 (atol, rtol): both
# compute in fp32 and round the output once, so they differ by at most one
# bf16 step (2^-7 |o|) plus fp32 summation-order noise.
CARD_TOL_BF16 = (1e-3, 1e-2)
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, Sq, Sk, H, KV, D, seed):
    """q, k, v as float32 numpy arrays, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, D), dtype=np.float32)
    return q, k, v


def _port(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPE[dtype])
            for a in arrays]


def _assert_close(out, ref, tol, rtol=None):
    out = out.float().cpu().numpy()
    ref = ref.float().cpu().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=tol if rtol is None else rtol,
                               atol=tol)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_kernel(blocks, causal):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import \
        flash_attention as pallas_flash_attention
    B, S, H, KV, D = GRID
    arrays = _inputs(B, S, S, H, KV, D, seed=sum(blocks) + causal)
    ref = pallas_flash_attention(*map(jnp.asarray, arrays), causal=causal,
                                 bq=blocks[0], bkv=blocks[1], interpret=True)
    out = flash_attention(*_port(arrays, "float32"), causal=causal)
    assert out.shape == (B, S, H, D) and out.dtype == torch.float32
    _assert_close(out, np.asarray(ref), TOL["float32"])


def test_plain_version_matches_pallas_kernel_bf16():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import \
        flash_attention as pallas_flash_attention
    arrays = _inputs(1, 128, 128, 2, 2, 64, seed=3)
    ref = pallas_flash_attention(
        *[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays], causal=True,
        bq=64, bkv=64, interpret=True)
    out = flash_attention(*_port(arrays, "bfloat16"), causal=True)
    assert out.dtype == torch.bfloat16
    _assert_close(out, np.asarray(ref, np.float32), TOL["bfloat16"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(200, 200), (37, 37), (5, 70)])
def test_plain_version_matches_oracle_on_ragged_and_offset_rows(causal, Sq,
                                                                Sk):
    """Ragged lengths and Sq < Sk (q rows at key positions Sk - Sq + i)
    against the JAX oracle on the MHA layout, and against the model's own
    full-sequence attention (``layers._flash_train``) where Sq == Sk."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    from repro.models.layers import _flash_train
    H, KV, D = 4, 2, 16
    q, k, v = _inputs(2, Sq, Sk, H, KV, D, seed=Sq + Sk)
    out = flash_attention(*_port((q, k, v), "float32"), causal=causal)
    kk = np.repeat(k, H // KV, axis=2)
    vv = np.repeat(v, H // KV, axis=2)
    if Sq == Sk:
        ref = _flash_train(*map(jnp.asarray, (q, kk, vv)), causal, 0, 32)
        _assert_close(out, np.asarray(ref), TOL["float32"])
        ref = jax_ref(*[jnp.asarray(a.transpose(0, 2, 1, 3))
                        for a in (q, kk, vv)], causal)
        _assert_close(out, np.asarray(ref).transpose(0, 2, 1, 3),
                      TOL["float32"])
    else:
        # pad q at the front so the oracle's square mask puts row i at
        # key position Sk - Sq + i, and keep the last Sq rows
        qp = np.concatenate([np.zeros((2, Sk - Sq, H, D), np.float32), q], 1)
        ref = jax_ref(*[jnp.asarray(a.transpose(0, 2, 1, 3))
                        for a in (qp, kk, vv)], causal)
        _assert_close(out, np.asarray(ref).transpose(0, 2, 1, 3)[:, -Sq:],
                      TOL["float32"])


def test_wrapper_takes_plain_version_for_cpu_tensors():
    q, k, v = _port(_inputs(1, 40, 40, 4, 1, 32, seed=1), "float32")
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v), attention_ref(q, k, v))
    assert flash_attention.launches == before    # the count is for the kernel


class _Elsewhere(torch.Tensor):
    """A tensor on a device that is neither the CPU, CUDA nor meta (shape
    and dtype only: any operation on it raises)."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, dtype=t.dtype, device=torch.device("xla"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)


def test_wrapper_rejects_other_devices():
    q, k, v = _port(_inputs(1, 8, 8, 2, 1, 16, seed=2), "float32")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(*map(_Elsewhere, (q, k, v)))
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.to("meta"), v)
    # meta is the dry run's: the kernel's output, unlaunched
    before = flash_attention.launches
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert flash_attention.launches == before


def test_checks_reject_what_the_kernel_does_not_take():
    """The card path's checks, run on meta tensors (no card needed)."""
    q, k, v = (t.to("meta") for t in
               _port(_inputs(1, 8, 8, 4, 2, 16, seed=4), "float32"))
    ops._check(q, k, v, True)
    with pytest.raises(TypeError):
        ops._check(q.half(), k.half(), v.half(), True)
    with pytest.raises(TypeError):
        ops._check(q, k.to(torch.bfloat16), v, True)
    with pytest.raises(ValueError, match="head dim"):
        ops._check(q[..., :8], k[..., :8], v[..., :8], True)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops._check(q[:, :, :3], k, v, True)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        ops._check(q, k[:, :4], v[:, :4], True)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(q.transpose(1, 2), k, v, False)


def test_checks_reject_unaligned_bf16():
    """The bf16 kernel copies 16-byte pieces of each row."""
    q, k, v = _port(_inputs(1, 8, 8, 4, 2, 16, seed=4), "bfloat16")
    ops._check(q, k, v, True)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:]
    shifted = shifted.view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ops._check(shifted, k, v, True)


# --------------------------------------------------------------------------
# The numerics of the card's bf16 schedule, emulated on the CPU
# --------------------------------------------------------------------------

LOG2E = 1.4426950408889634
BKV = 64        # keys per K/V tile (csrc/flash_attention.cu, wg::BKV)


def _emulate_bf16_schedule(q, k, v, causal, split_p=True):
    """What ``flash_fwd_wgmma`` computes, in PyTorch on the CPU: fp32
    scores of the bf16 inputs, scaled after the product; an online softmax
    over tiles of BKV keys with exp2 and log2(e) folded into the scale; P
    rounded to bf16 before P V, as hi + lo parts (``split_p``) or hi alone;
    l summed from the unrounded p; o = acc / max(l, 1e-30) rounded once."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    head = torch.arange(h) // (h // kv)
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    c = scale * LOG2E
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()[:, :, head])
    if causal:
        qpos = (sk - sq) + torch.arange(sq)
        s = torch.where(qpos[:, None] >= torch.arange(sk)[None, :], s,
                        torch.tensor(-1e30))
    vv = v.float()[:, :, head].permute(0, 2, 1, 3)      # (B, H, Sk, D)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, BKV):
        st = s[..., k0:k0 + BKV]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        p = torch.exp2(st * c - m_new * c)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vv[:, :, k0:k0 + BKV]
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vv[:, :, k0:k0 + BKV]
        acc = acc * corr + pv
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3).to(q.dtype)


def _excess(out, ref, atol, rtol):
    """max |out - ref| / (atol + rtol |ref|): at most 1 within tolerance."""
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_bf16_schedule_numerics_within_card_tolerance(D):
    """The card's bf16 numerics against the plain version, at the card's
    own tolerance: (B1, S512, H4, KV2, D128), and D 16/32/64 at S 512."""
    q, k, v = _port(_inputs(1, 512, 512, 4, 2, D, seed=D), "bfloat16")
    for causal in (True, False):
        out = _emulate_bf16_schedule(q, k, v, causal)
        assert out.dtype == torch.bfloat16
        assert _excess(out, attention_ref(q, k, v, causal),
                       *CARD_TOL_BF16) <= 1


def test_bf16_schedule_numerics_on_ragged_and_offset_rows():
    for Sq, Sk, causal in [(200, 200, True), (65, 130, True), (5, 70, True),
                           (129, 129, False)]:
        q, k, v = _port(_inputs(2, Sq, Sk, 4, 2, 64, seed=Sq), "bfloat16")
        out = _emulate_bf16_schedule(q, k, v, causal)
        assert _excess(out, attention_ref(q, k, v, causal),
                       *CARD_TOL_BF16) <= 1


def test_one_bf16_p_would_break_the_card_tolerance():
    """Why P goes to the tensor cores as hi + lo: rounded once to bf16,
    each weight carries 2^-9 of itself into o, which early causal rows
    (few keys, no averaging) cannot absorb under 1e-3 abs + 1e-2 rel."""
    q, k, v = _port(_inputs(1, 512, 512, 4, 2, 128, seed=128), "bfloat16")
    ref = attention_ref(q, k, v, True)
    one = _emulate_bf16_schedule(q, k, v, True, split_p=False)
    two = _emulate_bf16_schedule(q, k, v, True)
    assert _excess(one, ref, *CARD_TOL_BF16) > 1
    assert _excess(two, ref, *CARD_TOL_BF16) <= 0.7


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    (2, 256, 256, 4, 2, 32),     # the reference grid
    (2, 200, 200, 4, 2, 32),     # ragged S
    (1, 70, 70, 2, 1, 16),
    (2, 5, 70, 4, 4, 64),        # Sq < Sk
    (1, 130, 130, 16, 8, 128),   # qwen3's heads, ragged
])
def test_kernel_matches_plain_version_on_card(cuda, causal, shape):
    B, Sq, Sk, H, KV, D = shape
    q, k, v = _port(_inputs(B, Sq, Sk, H, KV, D, seed=Sq + D), "float32",
                    cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    _assert_close(out, attention_ref(q, k, v, causal), TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 128, 128, 2, 2, 64),
                                   (2, 300, 300, 16, 8, 128)])
def test_kernel_matches_plain_version_on_card_bf16(cuda, shape):
    B, Sq, Sk, H, KV, D = shape
    q, k, v = _port(_inputs(B, Sq, Sk, H, KV, D, seed=3), "bfloat16", cuda)
    out = flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    _assert_close(out, attention_ref(q, k, v, True), *CARD_TOL_BF16)


@pytest.mark.gpu
def test_kernel_checks_inputs(cuda):
    q, k, v = _port(_inputs(1, 16, 16, 4, 2, 32, seed=5), "float32", cuda)
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, v, False)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q.cpu(), k, v)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                        v[..., :24].contiguous())
    assert flash_attention.launches == before
    assert ops.flash_attention is flash_attention


@pytest.mark.gpu
def test_card_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ops, "attention_ref", refuse)
    q, k, v = _port(_inputs(1, 64, 64, 4, 2, 32, seed=6), "float32", cuda)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.device.type == "cuda"


def _bf16_on_card(cuda, B, Sq, Sk, H, KV, D, causal, seed):
    q, k, v = _port(_inputs(B, Sq, Sk, H, KV, D, seed=seed), "bfloat16", cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    _assert_close(out, attention_ref(q, k, v, causal), *CARD_TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq", [1, 5, 63, 64, 65, 127, 128, 129, 200, 300])
def test_wgmma_schedule_matches_plain_version(cuda, D, causal, Sq):
    """Every head dim, both masks, q tiles (128 rows) and K/V tiles (64
    keys) cut at every edge."""
    _bf16_on_card(cuda, 2, Sq, Sq, 4, 2, D, causal, seed=Sq + D)


@pytest.mark.gpu
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
@pytest.mark.parametrize("Sq,Sk", [(1, 64), (5, 70), (63, 200), (65, 129),
                                   (128, 300), (129, 130)])
def test_wgmma_schedule_causal_offsets(cuda, D, Sq, Sk):
    """Causal rows at key positions Sk - Sq + i, Sk > Sq."""
    _bf16_on_card(cuda, 2, Sq, Sk, 4, 2, D, True, seed=Sq * Sk)


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV", [(8, 8), (8, 4), (16, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_schedule_gqa(cuda, H, KV, causal, D):
    """GQA ratios H/KV of 1, 2 and 8: KV head h // (H/KV) read in place."""
    _bf16_on_card(cuda, 2, 200, 200, H, KV, D, causal, seed=H * KV)
