"""The port's coded matmul: its plain version against the JAX package's
Pallas kernel (interpret mode), and its CUDA kernel against the plain
version on the card.

The JAX package is imported inside the tests that compare with it, so the
card's tests (marked ``gpu``) also run on a machine without JAX:

    python -m pytest -q -m gpu tests/test_torch_coded_matmul.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.coding import decode_blocks, encode_blocks, mds_generator
from repro_torch.kernels.coded_matmul import coded_matmul, coded_matmul_ref
from repro_torch.kernels.coded_matmul import kernel, ops

GRID = [(4, 2), (6, 3), (8, 8), (5, 1)]          # tests/test_kernels.py:15
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}        # tests/test_kernels.py:26
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, k, M, K, N, seed):
    """G, A, X as float32 numpy arrays, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    G = mds_generator(n, k)
    A = rng.standard_normal((k, M, K), dtype=np.float32)
    X = rng.standard_normal((K, N), dtype=np.float32)
    return G, A, X


def _port(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPE[dtype])
            for a in arrays]


def _assert_close(out, ref, tol):
    out = out.float().cpu().numpy()
    ref = ref.float().cpu().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("n,k", GRID)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_version_matches_pallas_kernel(n, k, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.coded_matmul import coded_matmul as pallas_coded_matmul
    arrays = _inputs(n, k, 256, 256, 128, seed=n * 10 + k)
    ref = pallas_coded_matmul(*[jnp.asarray(a).astype(dtype) for a in arrays],
                              interpret=True)
    out = coded_matmul_ref(*_port(arrays, dtype))
    assert out.dtype == TORCH_DTYPE[dtype] and out.shape == (n, 256, 128)
    _assert_close(out, np.asarray(ref, np.float32), TOL[dtype])


def test_wrapper_takes_plain_version_for_cpu_tensors():
    G, A, X = _port(_inputs(6, 3, 32, 48, 5, seed=1), "float32")
    before = coded_matmul.launches
    assert torch.equal(coded_matmul(G, A, X), coded_matmul_ref(G, A, X))
    assert coded_matmul.launches == before     # the count is for the kernel


def test_wrapper_rejects_other_devices():
    G, A, X = _port(_inputs(4, 2, 8, 8, 1, seed=2), "float32")
    with pytest.raises(ValueError, match="unsupported device"):
        coded_matmul(G.to("meta"), A.to("meta"), X.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        coded_matmul(G, A.to("meta"), X)


def test_encode_decode_blocks_match_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core.coding import decode_blocks as ref_decode
    from repro.core.coding import encode_blocks as ref_encode
    rng = np.random.default_rng(7)
    n, k = 12, 6
    G = mds_generator(n, k)
    blocks = rng.standard_normal((k, 20, 16), dtype=np.float32)
    coded = encode_blocks(G, torch.from_numpy(blocks))
    ref_coded = np.asarray(ref_encode(G, jnp.asarray(blocks)))
    _assert_close(coded, ref_coded, 1e-6)
    surv = sorted(rng.choice(n, k, replace=False).tolist())
    rec = decode_blocks(G, surv, coded[surv])
    ref_rec = np.asarray(ref_decode(G, surv, jnp.asarray(ref_coded[surv])))
    _assert_close(rec, ref_rec, 1e-5)
    _assert_close(rec, blocks, 1e-4)


# --------------------------------------------------------------------------
# The host half of the N > 8 schedule: how the K range is split
# --------------------------------------------------------------------------

PAPER_ROWS, PAPER_K = 12288, 8192     # configs/paper_matvec.py
# (M, K, N) of the card tests below, at (n, k) in RAGGED_NK
RAGGED = [(100, 37, 1), (129, 255, 130), (64, 64, 8), (33, 1000, 9),
          (7, 8, 3), (96, 5, 64), (96, 100, 130), (96, 2053, 128)]
RAGGED_NK = [(12, 1), (12, 12), (12, 4)]


def _check_split(rows, K, N, sms=ops.H100_SMS):
    splits = ops.split_count(rows, K, N, sms)
    if N <= ops.SKINNY_N:
        assert splits == 1
    tiles = -(-rows // ops.BM) * -(-N // ops.BN)
    most = -(-K // ops.BK)
    assert 1 <= splits <= most
    if N > ops.SKINNY_N:
        # two waves of one block per SM, or every slice one BK deep
        assert tiles * splits >= 2 * sms or splits == most
    ranges = ops.split_ranges(K, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1                           # disjoint, no gap
    for i, (b, e) in enumerate(ranges):
        assert e > b                              # non-empty
        assert b % ops.BK == 0
        if i + 1 < splits:
            assert (e - b) % ops.BK == 0
    return splits


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 12])
@pytest.mark.parametrize("N", [1, 128])
def test_split_count_at_paper_matvec(k, N):
    """A 12288 x 8192 as k blocks of 12288/k rows: the (k*M) x K source is
    the same for every k | 12, and so is its split."""
    splits = _check_split(k * (PAPER_ROWS // k), PAPER_K, N)
    assert splits == (1 if N == 1 else 4)     # 96 tiles x 4 = 384 blocks


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("nk", RAGGED_NK)
def test_split_count_on_ragged_shapes(shape, nk):
    M, K, N = shape
    _check_split(nk[1] * M, K, N)


@pytest.mark.parametrize("sms", [1, 8, 114, 132])
def test_split_count_adapts_to_the_card(sms):
    for rows, K, N in [(PAPER_ROWS, PAPER_K, 128), (1548, 255, 130),
                       (10 ** 6, 64, 256)]:
        _check_split(rows, K, N, sms)


def test_split_ranges_reject_empty_slices():
    assert ops.split_ranges(37, 3) == [(0, 16), (16, 32), (32, 37)]
    for bad in (0, 4):
        with pytest.raises(ValueError, match="splits"):
            ops.split_ranges(37, bad)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", GRID)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_version_on_card(cuda, n, k, dtype):
    G, A, X = _port(_inputs(n, k, 256, 256, 128, seed=n * 10 + k), dtype,
                    cuda)
    before = coded_matmul.launches
    out = coded_matmul(G, A, X)
    torch.cuda.synchronize()
    assert coded_matmul.launches == before + 1
    assert out.dtype == A.dtype and out.shape == (n, 256, 128)
    _assert_close(out, coded_matmul_ref(G, A, X), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(100, 37, 1), (129, 255, 130),
                                   (64, 64, 8), (33, 1000, 9), (7, 8, 3)])
@pytest.mark.parametrize("nk", RAGGED_NK)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_masks_ragged_edges(cuda, shape, nk, dtype):
    """Dims that do not tile, both schedules (N <= 8 and N > 8), the
    unaligned row path (K = 37), and k = 1 and k = n."""
    M, K, N = shape
    G, A, X = _port(_inputs(*nk, M, K, N, seed=M + K + N), dtype, cuda)
    out = coded_matmul(G, A, X)
    torch.cuda.synchronize()
    _assert_close(out, coded_matmul_ref(G, A, X), TOL[dtype])


@pytest.mark.gpu
def test_kernel_checks_inputs(cuda):
    G, A, X = _port(_inputs(4, 2, 16, 16, 4, seed=3), "float32", cuda)
    with pytest.raises(TypeError):
        coded_matmul(G, A, X.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        coded_matmul(G, A.transpose(1, 2), X)
    with pytest.raises(ValueError, match="mismatch"):
        coded_matmul(G, A, X[:8])
    with pytest.raises(ValueError, match="one device"):
        coded_matmul(G.cpu(), A, X)
    assert ops.coded_matmul is coded_matmul


@pytest.mark.gpu
@pytest.mark.parametrize("N", [9, 64, 128, 130])
@pytest.mark.parametrize("K", [5, 16, 100, 1000, 2053])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_k_schedule_matches_plain_version(cuda, N, K, dtype):
    """The N > 8 schedule: K within one slice (5, 16), K not a multiple of
    the slice length or of BK (100, 1000, 2053), N ragged and aligned."""
    G, A, X = _port(_inputs(12, 4, 96, K, N, seed=K + N), dtype, cuda)
    out = coded_matmul(G, A, X)
    torch.cuda.synchronize()
    _assert_close(out, coded_matmul_ref(G, A, X), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_k_schedule_every_k(cuda, k, dtype):
    """Every k | 12 at n = 12: the same (k*M) x K source cut into k blocks."""
    G, A, X = _port(_inputs(12, k, 1200 // k, 1000, 128, seed=k), dtype,
                    cuda)
    out = coded_matmul(G, A, X)
    torch.cuda.synchronize()
    _assert_close(out, coded_matmul_ref(G, A, X), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_split_count_gives_the_same_product(cuda, dtype):
    """The binding launched with S slices, from one to one per BK: each
    gives the plain version's product (encode_partials sums the slices)."""
    G, A, X = _port(_inputs(6, 3, 100, 300, 130, seed=9), dtype, cuda)
    ref = coded_matmul_ref(G, A, X)
    for splits in (1, 2, 3, 7, 19):
        C = torch.empty_like(ref)
        P = torch.empty((splits, 3, 100, 130), dtype=torch.float32,
                        device=cuda)
        kernel.launch(G.float().contiguous(), A, X, C, P)
        torch.cuda.synchronize()
        _assert_close(C, ref, TOL[dtype])
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernel.launch(G.float().contiguous(), A, X, torch.empty_like(ref),
                      torch.empty((20, 3, 100, 130), device=cuda))
