"""The port's SSD scan: its chunked plain version against the JAX package's
Pallas kernel (interpret mode), the JAX ``ssd_chunked`` (y and the final
state) and the sequential oracle, and its CUDA kernel against the plain
version on the card.

The JAX package is imported inside the tests that compare with it, so the
card's tests (marked ``gpu``) also run on a machine without JAX:

    python -m pytest -q -m gpu tests/test_torch_ssd_scan.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_ref, ssd_scan
from repro_torch.kernels.ssd_scan import ops

CHUNKS = [4, 16, 64]                             # tests/test_kernels.py:65
SHAPES = [(2, 64, 3, 16, 8), (1, 128, 2, 32, 16)]  # :66
TOL = 2e-5                                       # of max|y|, :79
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, S, H, P, N, seed):
    """x, dt, A, Bm, Cm as float32 numpy arrays, drawn from ``seed`` with
    the reference test's laws: dt = softplus(normal), A = -exp(normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _port(arrays, dtype="float32", device="cpu"):
    """x, Bm and Cm in ``dtype``; dt and A stay float32."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(device) for a in arrays)
    d = TORCH_DTYPE[dtype]
    return x.to(d), dt, A, Bm.to(d), Cm.to(d)


def _assert_close(out, ref, tol, scale=None):
    out = out.float().cpu().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = ref.float().cpu().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) + 1e-9 if scale is None else scale
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_kernel(chunk, shape):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
    arrays = _inputs(*shape, seed=chunk + shape[1])
    ref = pallas_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                          interpret=True)
    out = ssd_scan(*_port(arrays), chunk=chunk)
    assert out.shape == shape[:4] and out.dtype == torch.float32
    _assert_close(out, np.asarray(ref), TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_chunked_matches_reference_and_oracle(chunk, shape):
    """y and h_final of the port's ssd_chunked against the JAX
    ``models/mamba2.py::ssd_chunked`` (from a zero and from a given initial
    state) and against the sequential oracles of both packages."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd_scan import ssd_ref as jax_ssd_ref
    from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
    arrays = _inputs(*shape, seed=100 + chunk + shape[1])
    y, h = ssd_chunked(*_port(arrays), chunk=chunk)
    jy, jh = jax_ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    _assert_close(y, np.asarray(jy), TOL)
    _assert_close(h, np.asarray(jh), TOL)
    oy, oh = ssd_ref(*_port(arrays))
    joy, joh = jax_ssd_ref(*map(jnp.asarray, arrays))
    _assert_close(oy, np.asarray(joy), TOL)
    _assert_close(oh, np.asarray(joh), TOL)
    _assert_close(y, oy, TOL)
    _assert_close(h, oh, TOL)
    B, S, H, P, N = shape
    h0 = np.random.default_rng(chunk).standard_normal(
        (B, H, P, N)).astype(np.float32)
    y0, h1 = ssd_chunked(*_port(arrays), chunk=chunk, h0=torch.from_numpy(h0))
    jy0, jh1 = jax_ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk,
                               h0=jnp.asarray(h0))
    _assert_close(y0, np.asarray(jy0), TOL)
    _assert_close(h1, np.asarray(jh1), TOL)


def test_ssd_chunked_bf16_keeps_dtype_and_tracks_fp32():
    arrays = _inputs(1, 64, 2, 16, 8, seed=9)
    y16, _ = ssd_chunked(*_port(arrays, "bfloat16"), chunk=16)
    y32, _ = ssd_chunked(*_port(arrays), chunk=16)
    assert y16.dtype == torch.bfloat16
    _assert_close(y16, y32, 2e-2)      # bf16 inputs and output, fp32 inside


def test_wrapper_takes_plain_version_for_cpu_tensors():
    args = _port(_inputs(1, 32, 2, 16, 8, seed=1))
    before = ssd_scan.launches
    assert torch.equal(ssd_scan(*args, chunk=8), ssd_chunked(*args, 8)[0])
    assert ssd_scan.launches == before     # the count is for the kernel


def test_wrapper_rejects_other_devices():
    args = _port(_inputs(1, 16, 2, 16, 8, seed=2))
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan(*[a.to("meta") for a in args], chunk=8)
    with pytest.raises(ValueError, match="one device"):
        ssd_scan(args[0], args[1].to("meta"), *args[2:], chunk=8)


def test_checks_reject_what_the_kernel_does_not_take():
    """The card path's checks, run on meta tensors (no card needed)."""
    x, dt, A, Bm, Cm = (t.to("meta") for t in
                        _port(_inputs(2, 64, 3, 16, 8, seed=4)))
    ops._check(x, dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="chunk"):
        ops._check(x, dt, A, Bm, Cm, 24)
    with pytest.raises(TypeError):
        ops._check(x.half(), dt, A, Bm.half(), Cm.half(), 16)
    with pytest.raises(TypeError):
        ops._check(x, dt.to(torch.bfloat16), A, Bm, Cm, 16)
    with pytest.raises(TypeError):
        ops._check(x, dt, A, Bm.to(torch.bfloat16), Cm, 16)
    with pytest.raises(ValueError, match="head dim"):
        ops._check(x[..., :8], dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="mismatch"):
        ops._check(x, dt[:, :, :2], A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(x.transpose(0, 1).contiguous().transpose(0, 1), dt, A,
                   Bm, Cm, 16)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", CHUNKS + [8, 128])
@pytest.mark.parametrize("shape", SHAPES + [(2, 256, 4, 64, 128),
                                            (1, 128, 3, 32, 40)])
def test_kernel_matches_plain_version_on_card(cuda, chunk, shape):
    args = _port(_inputs(*shape, seed=chunk + shape[1]), "float32", cuda)
    chunk = min(chunk, shape[1])
    before = ssd_scan.launches
    out = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert out.shape == shape[:4] and out.dtype == torch.float32
    _assert_close(out, ssd_chunked(*args, chunk)[0], TOL)
    _assert_close(out, ssd_ref(*args)[0], TOL)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card_bf16_mamba_law(cuda):
    """bf16 x, B, C at the model's own laws: A in [-16, -1) and dt in
    [1e-3, 1e-1], so lcum falls far below -88 inside a chunk of 256."""
    B, S, H, P, N = 1, 512, 4, 64, 128
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = rng.uniform(1e-3, 1e-1, (B, S, H)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    args = _port((x, dt, A, Bm, Cm), "bfloat16", cuda)
    out = ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    _assert_close(out, ssd_chunked(*args, 256)[0], 1e-2)


@pytest.mark.gpu
def test_kernel_checks_inputs(cuda):
    args = _port(_inputs(1, 32, 2, 16, 8, seed=5), "float32", cuda)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(*args, chunk=12)
    with pytest.raises(ValueError, match="one device"):
        ssd_scan(args[0].cpu(), *args[1:], chunk=8)
    with pytest.raises(TypeError):
        ssd_scan(args[0], args[1].double(), *args[2:], chunk=8)
    assert ssd_scan.launches == before
    assert ops.ssd_scan is ssd_scan


@pytest.mark.gpu
def test_kernel_refuses_state_that_does_not_fit_one_block(cuda):
    """P x N = 16 x 512 needs more shared memory than a block has: the
    kernel reports it, the wrapper raises and counts no launch."""
    x, dt, A, _, _ = _port(_inputs(1, 32, 2, 16, 8, seed=7), "float32", cuda)
    big = torch.zeros((1, 32, 512), device=cuda)
    before = ssd_scan.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_scan(x, dt, A, big, big, chunk=16)
    assert ssd_scan.launches == before


@pytest.mark.gpu
def test_card_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ops, "ssd_chunked", refuse)
    args = _port(_inputs(1, 32, 2, 16, 8, seed=6), "float32", cuda)
    out = ssd_scan(*args, chunk=8)
    torch.cuda.synchronize()
    assert out.device.type == "cuda"
