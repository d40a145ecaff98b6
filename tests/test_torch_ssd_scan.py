"""The port's SSD scan: its chunked plain version against the JAX package's
Pallas kernel (interpret mode), the JAX ``ssd_chunked`` (y and the final
state) and the sequential oracle; the bf16 tensor-core schedule of the CUDA
kernels emulated on the CPU; and the CUDA kernels against the plain version
on the card.

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
# bf16 x, B and C on the card: 1e-2 of max|y| (y is rounded to bf16), and
# the bf16 schedule is held to half of it
CARD_TOL_BF16 = 1e-2
MAMBA_SHAPE = (1, 512, 4, 64, 128)     # mamba2-1.3b's P and N; B, S, H cut
GRID_BF16 = [(shape, chunk) for shape in SHAPES for chunk in CHUNKS + [8]] + \
    [((1, 128, 3, 32, 40), chunk) for chunk in (8, 64, 128)]
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


def _mamba_inputs(B, S, H, P, N, seed):
    """The model's laws: A in [-16, -1) and dt in [1e-3, 1e-1], so lcum falls
    far below -88 inside a chunk of 256."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = rng.uniform(1e-3, 1e-1, (B, S, H)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, H).astype(np.float32)
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
# The bf16 schedule of csrc/ssd_scan.cu, emulated on the CPU
# --------------------------------------------------------------------------

def _operand(v, parts):
    """v as the tensor cores see it: fp32 (parts 0), bf16(v) (1), or
    bf16(v) + bf16(v - bf16(v)) (2)."""
    if parts == 0:
        return v
    hi = v.bfloat16().float()
    return hi if parts == 1 else hi + (v - hi).bfloat16().float()


def _emulate_bf16_schedule(x, dt, A, Bm, Cm, chunk, parts=None, lag=1):
    """What the bf16 schedule computes, in its four steps, in fp32:

    1. G = C B^T per chunk (exact products of the bf16 inputs);
    2. each chunk's own state s_c = (x w)^T B, w_s = exp(l_{Q-1} - l_s) dt_s;
    3. the states passed in fp32: h_c = h_{c-1} exp(l_{Q-1}) + s_c;
    4. y_t = exp(l_t) C_t h_{c-lag}^T + sum_{s<=t} W_ts x_s with
       W = G o exp(l_t - l_s) o dt_s.

    ``parts`` maps each fp32 operand of a product ("W", "h" and "xw") to the
    bf16 parts it reaches the tensor cores as (``_operand``); None keeps all
    in fp32, the factorisation alone.  ``lag`` 1 is the schedule; 0 feeds
    chunk c the state after it, a planted fault.  y in x's dtype."""
    parts = parts or {}
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc = s // chunk
    xs = x.float().reshape(b, nc, chunk, h, p)
    Bs = Bm.float().reshape(b, nc, chunk, n)
    Cs = Cm.float().reshape(b, nc, chunk, n)
    dts = dt.float().reshape(b, nc, chunk, h)
    lc = torch.cumsum(dts * A.float(), dim=2)                    # (b,nc,Q,h)
    G = torch.einsum("bctn,bcsn->bcts", Cs, Bs)                  # step 1
    w = torch.exp(lc[:, :, -1:] - lc) * dts
    xw = _operand(xs * w[..., None], parts.get("xw", 0))
    own = torch.einsum("bcshp,bcsn->bchpn", xw, Bs)              # step 2
    states, run = [], torch.zeros_like(own[:, 0])
    for c in range(nc):                                          # step 3
        after = run * torch.exp(lc[:, c, -1])[..., None, None] + own[:, c]
        states.append(run if lag else after)
        run = after
    hin = _operand(torch.stack(states, 1), parts.get("h", 0))
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    decay = torch.exp(lc[:, :, :, None] - lc[:, :, None])        # (b,nc,t,s,h)
    W = torch.where(causal[None, None, :, :, None],
                    G[..., None] * decay * dts[:, :, None], torch.zeros(()))
    W = _operand(W, parts.get("W", 0))                           # step 4
    y = torch.einsum("bctsh,bcshp->bcthp", W, xs) + \
        torch.einsum("bctn,bchpn->bcthp", Cs, hin) * torch.exp(lc)[..., None]
    return y.reshape(b, s, h, p).to(x.dtype)


SPLIT_ALL = {"W": 2, "h": 2, "xw": 2}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_factorisation_matches_ssd_chunked(chunk, shape):
    """The four steps alone, in fp32, equal the chunked form to 2e-5; fed
    the state after each chunk instead of the one before it, they do not."""
    args = _port(_inputs(*shape, seed=300 + chunk + shape[1]))
    ref = ssd_chunked(*args, chunk)[0]
    _assert_close(_emulate_bf16_schedule(*args, chunk), ref, TOL)
    off = _emulate_bf16_schedule(*args, chunk, lag=0)
    scale = float(ref.abs().max())
    assert float((off - ref).abs().max()) > 100 * TOL * scale


@pytest.mark.parametrize("shape,chunk", GRID_BF16 + [(MAMBA_SHAPE, 256)])
def test_bf16_schedule_within_half_the_card_tolerance(shape, chunk):
    """The schedule as the card runs it (bf16 x, B, C; W, h and x w as hi +
    lo) reads at most half the card's limit against the plain version and
    the JAX oracle, on the reference grid and at the mamba2 laws."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd_scan import ssd_ref as jax_ssd_ref
    mamba = shape == MAMBA_SHAPE
    arrays = (_mamba_inputs if mamba else _inputs)(*shape, seed=chunk + 7)
    args = _port(arrays, "bfloat16")
    out = _emulate_bf16_schedule(*args, chunk, SPLIT_ALL)
    assert out.dtype == torch.bfloat16
    limit = 0.5 * CARD_TOL_BF16
    _assert_close(out, ssd_chunked(*args, chunk)[0], limit)
    exact = [np.asarray(a.float()) for a in args]    # the bf16 values, fp32
    _assert_close(out, np.asarray(jax_ssd_ref(*map(jnp.asarray, exact))[0]),
                  limit)


@pytest.mark.parametrize("parts", [{"W": 2, "h": 1, "xw": 1},
                                   {"W": 2, "h": 2, "xw": 1},
                                   {"W": 2, "h": 1, "xw": 2}])
def test_fewer_bf16_splits_would_read_over_half_the_limit(parts):
    """Why all three fp32 operands go to the tensor cores as hi + lo: with
    any of h and x w rounded once, a reference-grid input reads more than
    half the limit, where the full split reads under a third of it."""
    shape, chunk = (1, 128, 3, 32, 40), 8
    seed = 5136 if parts["xw"] == 2 else 4136
    args = _port(_inputs(*shape, seed=seed), "bfloat16")
    ref = ssd_chunked(*args, chunk)[0].float()
    scale = float(ref.abs().max())

    def reads(p):
        out = _emulate_bf16_schedule(*args, chunk, p).float()
        return float((out - ref).abs().max()) / (CARD_TOL_BF16 * scale)

    assert reads(parts) > 0.5
    assert reads(SPLIT_ALL) < 1 / 3


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
@pytest.mark.parametrize("shape,chunk", GRID_BF16 + [((2, 256, 4, 64, 128), 128),
                                                     ((1, 96, 2, 16, 8), 96),
                                                     ((1, 120, 2, 32, 16), 40)])
def test_bf16_schedule_matches_plain_version_on_card(cuda, shape, chunk):
    """The tensor-core schedule at every head dim, ragged chunks (4, 8, 40,
    96) and state widths (8, 40), within half the card's limit."""
    args = _port(_inputs(*shape, seed=chunk + shape[1]), "bfloat16", cuda)
    before = ssd_scan.launches
    out = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert out.shape == shape[:4] and out.dtype == torch.bfloat16
    _assert_close(out, ssd_chunked(*args, chunk)[0], 0.5 * CARD_TOL_BF16)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card_bf16_mamba_law(cuda):
    """bf16 x, B, C at the model's own laws: A in [-16, -1) and dt in
    [1e-3, 1e-1], so lcum falls far below -88 inside a chunk of 256."""
    args = _port(_mamba_inputs(*MAMBA_SHAPE, seed=11), "bfloat16", cuda)
    out = ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    _assert_close(out, ssd_chunked(*args, 256)[0], CARD_TOL_BF16)


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
    """What the kernels refuse, reported by them: the wrapper raises and
    counts no launch.  fp32: P x N = 16 x 512 needs more shared memory than
    a block has.  bf16: a state of P x N = 16 x 1024 > 8192 entries, N not a
    multiple of 8, and an operand off a 16-byte boundary."""
    x, dt, A, _, _ = _port(_inputs(1, 32, 2, 16, 8, seed=7), "float32", cuda)
    big = torch.zeros((1, 32, 512), device=cuda)
    x16 = x.bfloat16()
    before = ssd_scan.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_scan(x, dt, A, big, big, chunk=16)
    wide = torch.zeros((1, 32, 1024), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_scan(x16, dt, A, wide, wide, chunk=16)
    odd = torch.zeros((1, 32, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_scan(x16, dt, A, odd, odd, chunk=16)
    shifted = torch.zeros(x16.numel() + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view(x16.shape)
    narrow = torch.zeros((1, 32, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_scan(shifted, dt, A, narrow, narrow, chunk=16)
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
