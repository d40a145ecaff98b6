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


def test_wrapper_rejects_other_devices():
    q, k, v = _port(_inputs(1, 8, 8, 2, 1, 16, seed=2), "float32")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.to("meta"), v)


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
