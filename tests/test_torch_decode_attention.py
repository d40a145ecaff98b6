"""The port's decode attention (``kernels/decode_attention``): one query
row a sequence over its cache.

On the CPU: CPU and meta tensors take the plain version, which is bit for
bit ``models.layers``' one-row branch as it was before the kernel (a
frozen copy below); the checks refuse what the kernel does not take; the
kept key range is the plain version's mask; and a plain-PyTorch emulation
of the kernel's split and combine schedule matches the fp32 reference.
On the card (marked ``gpu``): the kernel against the plain version at the
shapes the port decodes, and its dispatch and launch count:

    python -m pytest -q -m gpu tests/test_torch_decode_attention.py

The kernel is also held to the JAX package's one-row branch
(``repro.models.layers.attention`` at sq == 1) at JAX_CASES: JAX's outputs,
computed on the CPU, are kept in ``tests/data/decode_attention_jax.npz``
(so the card's tests run no JAX), and a CPU test recomputes them.  Write
the file anew with ``PYTHONPATH=src python tests/test_torch_decode_attention.py``.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch._device import generator
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops
from repro_torch.models._attn_mask import key_mask
from repro_torch.launch import steps
from repro_torch.models import api, layers

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# csrc/decode_attention.cu: warps a block and keys a warp a tile
WARPS, KPW = 4, 16
SMS = 132                       # an H100 SXM's SMs
# The emulated schedule against the fp32 reference, |diff| over max|ref|:
# both are fp32 sums of the same terms in other orders (the reference's
# softmax normalises before p . v, the schedule after the splits' merge).
# Read at SCHEDULE_SHAPES: 1.4e-6 to 2.7e-6, while the reference itself
# lies 1.5e-6 to 2.4e-6 from an fp64 evaluation (the schedule 0.6e-6 to
# 1.8e-6); p rounded to bf16 reads 1.5e-4 to 2.4e-4.
SCHEDULE_TOL = 1e-5
# The card against the plain version: both compute in fp32 and round the
# output once to q's dtype, so a bf16 output may differ by one bf16 step
# (2^-8 of |o|, 2^-7 at most) plus the fp32 noise above.
CARD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _attend_row_before(q, k, v, causal, q_offset, kv_len, window):
    """``models.layers._attend_row`` as it was before the kernel: the KV
    heads repeated to the query heads, then one dense fp32 pass over the
    keys (scores, mask, softmax, p . v)."""
    sk, hd = k.shape[1], q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    q_pos = int(q_offset) + torch.arange(1, device=q.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(hd)),
                     k.float())
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((1, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= q_pos[:, None] - kpos[None, :] < window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    s = torch.where(mask[None, None], s, neg)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return out.transpose(1, 2).to(q.dtype)


def _inputs(B, Sk, H, KV, D, seed, qdtype="float32", kvdtype="float32",
            device="cpu"):
    """q (B, 1, H, D), k, v (B, Sk, KV, D) drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Sk, KV, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Sk, KV, D), np.float32))
    return (q.to(device=device, dtype=TORCH_DTYPE[qdtype]),
            k.to(device=device, dtype=TORCH_DTYPE[kvdtype]),
            v.to(device=device, dtype=TORCH_DTYPE[kvdtype]))


# (B, Sk, H, KV, D, causal, q_offset, kv_len, window, q dtype, kv dtype)
CASES = [
    (2, 40, 4, 2, 16, True, 39, 40, 0, "float32", "float32"),
    (2, 40, 4, 2, 16, True, 17, 18, 0, "float32", "float32"),
    (1, 64, 16, 8, 128, True, 50, 51, 0, "bfloat16", "bfloat16"),
    (2, 32, 4, 4, 64, False, 40, 20, 0, "float32", "bfloat16"),  # a ring
    (2, 32, 4, 4, 64, False, 40, 32, 0, "bfloat16", "float32"),
    (1, 70, 16, 1, 32, True, 60, 61, 16, "float32", "float32"),  # window
    (1, 30, 8, 8, 64, True, 29, None, 0, "bfloat16", "bfloat16"),
]


@pytest.mark.parametrize("case", CASES)
def test_cpu_takes_the_plain_version_bit_for_bit(case):
    B, Sk, H, KV, D, causal, q_offset, kv_len, window, qd, kd = case
    q, k, v = _inputs(B, Sk, H, KV, D, seed=Sk + D, qdtype=qd, kvdtype=kd)
    before = decode_attention.launches
    want = _attend_row_before(q, k, v, causal, q_offset, kv_len, window)
    out = layers.attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.equal(out, want)
    assert torch.equal(decode_attention(q, k, v, causal, q_offset, kv_len,
                                        window), want)
    assert decode_attention.launches == before   # the count is the kernel's


def test_meta_takes_the_plain_version(monkeypatch):
    """The dry run traces the reference's dense pass, never a launch."""
    calls = []

    def counted(*args):
        calls.append(args[0].device.type)
        return decode_attention_ref(*args)
    monkeypatch.setattr(ops, "decode_attention_ref", counted)
    q, k, v = (t.to("meta") for t in _inputs(2, 48, 8, 2, 128, seed=1,
                                             qdtype="bfloat16",
                                             kvdtype="bfloat16"))
    before = decode_attention.launches
    out = layers.attention(q, k, v, causal=True, q_offset=40, kv_len=41)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == torch.bfloat16
    assert calls == ["meta"] and decode_attention.launches == before


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
    q, k, v = _inputs(1, 8, 2, 1, 16, seed=2)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(*map(_Elsewhere, (q, k, v)))
    with pytest.raises(ValueError, match="one device"):
        decode_attention(q, k.to("meta"), v)


def test_checks_refuse_what_the_kernel_does_not_take():
    """The card path's checks, on CPU tensors (they read no data)."""
    q, k, v = _inputs(2, 64, 8, 2, 64, seed=4, qdtype="bfloat16",
                      kvdtype="bfloat16")
    assert ops._check(q, k, v, True, 40, 41, 0) == (0, 41)
    assert ops._check(q, k, v, True, 40, 41, 8) == (33, 41)
    assert ops._check(q, k, v, False, 63, 20, 0) == (0, 20)
    assert ops._check(q.float(), k.float(), v.float(), True, 63, 64, 0) \
        == (0, 64)
    with pytest.raises(ValueError, match="head dim"):
        ops._check(q[..., :48], k[..., :48], v[..., :48], True, 40, 41, 0)
    q96, k96, v96 = _inputs(1, 16, 4, 4, 96, seed=5)
    with pytest.raises(ValueError, match="head dim"):
        ops._check(q96, k96, v96, True, 10, 11, 0)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops._check(q[:, :, :3], k, v, True, 40, 41, 0)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops._check(q[:1], k, v, True, 40, 41, 0)
    with pytest.raises(ValueError, match="need q"):
        ops._check(q, k, v[:, :32], True, 40, 41, 0)
    with pytest.raises(ValueError, match="need q"):
        ops._check(torch.cat([q, q], 1), k, v, True, 40, 41, 0)
    q32, k1, v1 = _inputs(1, 16, 32, 1, 16, seed=6)
    with pytest.raises(ValueError, match="more than 16"):
        ops._check(q32, k1, v1, True, 10, 11, 0)
    with pytest.raises(TypeError):
        ops._check(q.half(), k, v, True, 40, 41, 0)
    with pytest.raises(TypeError):
        ops._check(q, k.half(), v.half(), True, 40, 41, 0)
    with pytest.raises(TypeError):
        ops._check(q, k, v.float(), True, 40, 41, 0)
    with pytest.raises(TypeError, match="host ints"):
        ops._check(q, k, v, True, 40, torch.tensor(41), 0)
    with pytest.raises(TypeError, match="host ints"):
        ops._check(q, k, v, True, torch.tensor(40), 41, 0)
    with pytest.raises(ValueError, match="window"):
        ops._check(q, k, v, True, 40, 41, -1)
    with pytest.raises(ValueError, match="no key"):
        ops._check(q, k, v, False, 40, 0, 0)
    with pytest.raises(ValueError, match="no key"):
        ops._check(q, k, v, True, -1, None, 0)
    strided = k.transpose(2, 3).contiguous().transpose(2, 3)
    assert strided.shape == k.shape and strided.stride(3) != 1
    with pytest.raises(ValueError, match="16-byte"):
        ops._check(q, strided, v, True, 40, 41, 0)
    padded = torch.zeros(2, 64, 2, 68, dtype=k.dtype)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):        # rows of 136 B
        ops._check(q, k, padded, True, 40, 41, 0)
    shifted = torch.zeros(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ops._check(q, shifted, v, True, 40, 41, 0)
    # a view of a cache in place: every KV head's rows, 16-byte aligned
    cache = torch.zeros(3, 2, 64, 4, 64, dtype=torch.bfloat16)
    assert ops._check(q[:, :, :4], cache[1, :, :, :2], cache[2, :, :, 2:],
                      True, 40, 41, 0) == (0, 41)


@pytest.mark.parametrize("sk,causal,q_offset,kv_len,window", [
    (64, True, 63, 64, 0), (64, True, 20, 21, 0), (64, True, 20, None, 0),
    (64, True, 63, 64, 10), (64, True, 5, 64, 10), (64, False, 63, 17, 0),
    (64, False, 3, None, 0), (64, False, 63, 99, 5), (64, True, 80, 70, 0),
    (64, True, 40, 30, 20),
])
def test_kept_range_is_the_plain_versions_mask(sk, causal, q_offset, kv_len,
                                               window):
    lo, hi = ops.kept_range(sk, causal, q_offset, kv_len, window)
    kept = key_mask(torch.tensor([q_offset]), torch.arange(sk), causal,
                    kv_len, window)[0]
    want = torch.zeros(sk, dtype=torch.bool)
    want[max(lo, 0):max(hi, 0)] = True
    assert torch.equal(kept, want)


@pytest.mark.parametrize("n,rows", [(32768, 64), (32640, 64), (1, 64),
                                    (5001, 2), (524288, 8), (257, 4096),
                                    (40, 8), (4097, 32)])
def test_split_plan_covers_the_range_in_whole_tiles(n, rows):
    chunk, nsplit = ops.split_plan(n, rows, SMS)
    assert chunk % ops.TILE == 0 and nsplit >= 1
    assert (nsplit - 1) * chunk < n <= nsplit * chunk     # no empty split
    tiles = -(-n // ops.TILE)
    if tiles >= 2 * ops.MIN_SPLIT_TILES:
        assert chunk >= ops.MIN_SPLIT_TILES * ops.TILE
    assert rows * nsplit <= ops.BLOCKS_PER_SM * SMS + rows * 2


def test_split_plan_at_the_decode_cells_shape():
    """qwen3-0.6b's decode_32k: 8 rows x 8 KV heads at about 32.7k kept
    keys: 16 to 32 splits of 1k to 2k keys, the grid several times the
    card's 132 SMs."""
    for pos in (32640, 32767):
        chunk, nsplit = ops.split_plan(pos + 1, 64, SMS)
        assert 16 <= nsplit <= 32 and 1024 <= chunk <= 2048
        assert 64 * nsplit >= 4 * SMS


def test_cost_counts_the_cache_once():
    """At the decode cell's shape a layer reads its 1.074 GB of keys and
    values once (bf16), the bound ``hbm_share.decode`` rests on."""
    q = torch.empty((8, 1, 16, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((8, 32768, 8, 128), dtype=torch.bfloat16, device="meta")
    ops_, nbytes = ops.cost(q, k, 0, 32768)
    assert nbytes == 2 * 8 * 8 * 32768 * 128 * 2 + 2 * q.numel() * 2
    assert abs(nbytes / 1e9 - 1.074) < 1e-3
    assert ops_ == 4.0 * 8 * 16 * 32768 * 128


# --------------------------------------------------------------------------
# The numerics of the kernel's schedule, emulated on the CPU
# --------------------------------------------------------------------------

def _emulate_schedule(q, k, v, lo, hi, sms=SMS, p16=False):
    """What ``split_kernel`` and ``combine_kernel`` compute, in fp32 on the
    CPU: the kept keys cut by ``ops.split_plan`` into splits of tiles of
    TILE keys; in each tile, each of the WARPS warps takes KPW keys and
    carries its own online softmax (running max m, sum l, accumulator)
    for the group's query heads; the warps' states merged at the split's
    end, then the splits' (o, m, l) merged and o = sum / l.  ``p16``
    rounds p to bf16 before p . v (a planted fault)."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    chunk, nsplit = ops.split_plan(hi - lo, b * kv, sms)
    tiles = chunk // ops.TILE
    npad = nsplit * chunk
    qs = (q.float() * (1.0 / math.sqrt(d))).view(b, kv, g, d)
    kk = torch.zeros(b, npad, kv, d)
    vv = torch.zeros(b, npad, kv, d)
    kk[:, :hi - lo] = k[:, lo:hi].float()
    vv[:, :hi - lo] = v[:, lo:hi].float()
    shape = (b, kv, nsplit, tiles, WARPS, KPW, d)
    kk = kk.permute(0, 2, 1, 3).reshape(shape)
    vv = vv.permute(0, 2, 1, 3).reshape(shape)
    valid = (torch.arange(npad) < hi - lo).view(nsplit, tiles, WARPS, KPW)
    s = torch.einsum("bkgd,bkstwjd->bkgstwj", qs, kk)
    s = s.masked_fill(~valid, float("-inf"))
    inf = float("-inf")
    m = torch.full((b, kv, g, nsplit, WARPS), inf)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, g, nsplit, WARPS, d))
    for t in range(tiles):
        st = s[:, :, :, :, t]                          # (b,kv,g,s,w,j)
        m_new = torch.maximum(m, st.amax(-1))
        live = m_new > inf                             # a warp that saw keys
        corr = torch.where(live, torch.exp(m - m_new), torch.ones(()))
        p = torch.where(live[..., None], torch.exp(st - m_new[..., None]),
                        torch.zeros(()))
        l = l * corr + p.sum(-1)
        if p16:
            p = p.bfloat16().float()
        acc = acc * corr[..., None] + torch.einsum(
            "bkgswj,bkswjd->bkgswd", p, vv[:, :, :, t])
        m = torch.where(live, m_new, m)

    def merge(m, l, o):                                # over the last axis
        mx = m.amax(-1)
        e = torch.where(m > inf, torch.exp(m - mx[..., None]),
                        torch.zeros(()))
        return mx, (l * e).sum(-1), (o * e[..., None]).sum(-2)

    m, l, o = merge(m, l, acc)                         # the warps
    _, l, o = merge(m, l, o)                           # the splits
    return (o / l[..., None]).reshape(b, 1, h, d)


# (B, Sk, H, KV, D, q_offset, sms): the cell's group size (GQA 2) with a
# ragged last tile, and GQA 16 with ragged splits (16 of 320 keys, the
# last 201 long: whole warps and tiles past its end)
SCHEDULE_SHAPES = [(2, 8192, 16, 8, 128, 8190, SMS),
                   (2, 6000, 16, 1, 128, 5000, SMS),
                   (1, 3000, 32, 32, 64, 2999, 16)]


def _bf16_values(*shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
        .bfloat16().float()


def _excess(out, ref, tol):
    return float((out - ref).abs().max() / ref.abs().max()) / tol


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_schedule_numerics_match_the_fp32_reference(shape):
    B, Sk, H, KV, D, q_offset, sms = shape
    q = _bf16_values(B, 1, H, D, seed=Sk) * 2.0
    k = _bf16_values(B, Sk, KV, D, seed=Sk + 1)
    v = _bf16_values(B, Sk, KV, D, seed=Sk + 2)
    lo, hi = ops.kept_range(Sk, True, q_offset, q_offset + 1)
    ref = decode_attention_ref(q, k, v, True, q_offset, q_offset + 1, 0)
    out = _emulate_schedule(q, k, v, lo, hi, sms)
    assert _excess(out, ref, SCHEDULE_TOL) <= 1
    # rounded once to bf16, within the card's tolerance of the reference's
    ref16 = decode_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 True, q_offset, q_offset + 1, 0)
    torch.testing.assert_close(out.bfloat16().float(), ref16.float(),
                               rtol=CARD_RTOL[torch.bfloat16],
                               atol=1e-6 * float(ref16.float().abs().max()))


def test_a_bf16_p_would_break_the_schedule_tolerance():
    """The tolerance tells the reference's precision from p in bf16."""
    B, Sk, H, KV, D, q_offset, sms = SCHEDULE_SHAPES[0]
    q = _bf16_values(B, 1, H, D, seed=Sk) * 2.0
    k = _bf16_values(B, Sk, KV, D, seed=Sk + 1)
    v = _bf16_values(B, Sk, KV, D, seed=Sk + 2)
    lo, hi = ops.kept_range(Sk, True, q_offset, q_offset + 1)
    ref = decode_attention_ref(q, k, v, True, q_offset, q_offset + 1, 0)
    assert _excess(_emulate_schedule(q, k, v, lo, hi, sms, p16=True), ref,
                   SCHEDULE_TOL) > 5


# --------------------------------------------------------------------------
# The JAX package's one-row branch, at the shapes the card tests read
# --------------------------------------------------------------------------

JAX_FIXTURE = Path(__file__).parent / "data" / "decode_attention_jax.npz"
# name -> (B, Sk, H, KV, D, causal, q_offset, kv_len, window, cache dtype):
# the decode cell's group (GQA 2, D 128) over a shorter cache, GQA 16,
# zamba2's ring (not causal, partly and wholly filled), a window and an
# fp32 cache
JAX_CASES = {
    "gqa2": (4, 2048, 16, 8, 128, True, 2000, 2001, 0, "bfloat16"),
    "gqa2_last": (2, 2048, 16, 8, 128, True, 2047, 2048, 0, "bfloat16"),
    "gqa16": (2, 2048, 64, 4, 128, True, 1500, 1501, 0, "bfloat16"),
    "ring": (2, 1024, 32, 32, 64, False, 5000, 700, 0, "bfloat16"),
    "ring_full": (2, 1024, 32, 32, 64, False, 5000, 1024, 0, "bfloat16"),
    "window": (2, 2048, 16, 8, 128, True, 1800, 1801, 300, "bfloat16"),
    "fp32": (2, 1024, 16, 8, 128, True, 1000, 1001, 0, "float32"),
}


def _jax_case_inputs(name, device="cpu"):
    """q in fp32 with bf16 values (scaled by 2, exactly), k and v in the
    case's cache dtype, drawn from the case's sizes."""
    B, Sk, H, KV, D, causal, q_offset, kv_len, window, kd = JAX_CASES[name]
    q, k, v = _inputs(B, Sk, H, KV, D, seed=Sk + 7 * H + D, kvdtype=kd)
    q = q.bfloat16().float() * 2.0
    return q.to(device), k.to(device), v.to(device)


def _jax_row(name):
    """The JAX package's ``attention`` at one query row on the CPU, on the
    case's inputs: fp32 q, so the output is fp32 (not rounded to bf16)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.layers import attention as jax_attention
    B, Sk, H, KV, D, causal, q_offset, kv_len, window, kd = JAX_CASES[name]
    q, k, v = _jax_case_inputs(name)
    kv_dtype = jnp.bfloat16 if kd == "bfloat16" else jnp.float32
    out = jax_attention(jnp.asarray(q.numpy()),
                        jnp.asarray(k.float().numpy()).astype(kv_dtype),
                        jnp.asarray(v.float().numpy()).astype(kv_dtype),
                        causal=causal,
                        q_offset=jnp.asarray(q_offset, jnp.int32),
                        kv_len=jnp.asarray(kv_len, jnp.int32), window=window)
    assert out.dtype == jnp.float32
    return torch.from_numpy(np.array(out))


def _jax_fixture(name):
    with np.load(JAX_FIXTURE) as f:
        return torch.from_numpy(f[name])


def _write_jax_fixture():
    JAX_FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(JAX_FIXTURE, **{n: _jax_row(n).numpy()
                                        for n in JAX_CASES})


@pytest.mark.parametrize("name", JAX_CASES)
def test_jax_fixture_is_the_jax_reference(name):
    """The kept outputs are what the JAX package computes now, up to fp32
    rounding (XLA may sum in another order on another host)."""
    want = _jax_row(name)
    kept = _jax_fixture(name)
    assert kept.shape == want.shape and kept.dtype == torch.float32
    torch.testing.assert_close(kept, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_version_and_schedule_match_the_jax_reference(name):
    """On the CPU: the port's plain version, and the emulated split and
    combine schedule of the kernel, against the JAX package's outputs."""
    B, Sk, H, KV, D, causal, q_offset, kv_len, window, kd = JAX_CASES[name]
    q, k, v = _jax_case_inputs(name)
    want = _jax_fixture(name)
    plain = decode_attention(q, k, v, causal, q_offset, kv_len, window)
    assert _excess(plain, want, SCHEDULE_TOL) <= 1
    lo, hi = ops.kept_range(Sk, causal, q_offset, kv_len, window)
    assert _excess(_emulate_schedule(q, k, v, lo, hi), want,
                   SCHEDULE_TOL) <= 1


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on_card(cuda, B, Sk, H, KV, D, causal, q_offset, kv_len, window=0,
             qdtype="bfloat16", kvdtype="bfloat16", seed=0):
    q, k, v = _inputs(B, Sk, H, KV, D, seed=seed or Sk + H + D,
                      qdtype=qdtype, kvdtype=kvdtype, device=cuda)
    q = q * 2.0                      # scores spread over a few units
    before = decode_attention.launches
    out = decode_attention(q, k, v, causal, q_offset, kv_len, window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    ref = decode_attention_ref(q, k, v, causal, q_offset, kv_len, window)
    torch.testing.assert_close(
        out.float(), ref.float(), rtol=CARD_RTOL[q.dtype],
        atol=1e-6 * float(ref.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("pos", [32640, 32767])
def test_kernel_at_the_decode_cells_shape(cuda, pos):
    """qwen3-0.6b's decode_32k: B 8 over a 32,768-position bf16 cache,
    H 16, KV 8, D 128, causal at the position, kv_len pos + 1."""
    _on_card(cuda, 8, 32768, 16, 8, 128, True, pos, pos + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV", [(64, 4), (48, 8), (64, 8), (16, 16)])
def test_kernel_gqa_groups(cuda, H, KV):
    """GQA 16 (qwen3-moe, llama3-405b), 6 (dbrx), 8 (internvl2, yi) and 1
    (deepseek) at D 128."""
    _on_card(cuda, 2, 4096, H, KV, 128, True, 4000, 4001)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_len", [1000, 4096])
def test_kernel_over_a_ring(cuda, kv_len):
    """zamba2-1.2b's shared block over its ring: H = KV = 32, D 64, not
    causal, the first kv_len slots filled (kv_len < Sk, then = Sk)."""
    _on_card(cuda, 2, 4096, 32, 32, 64, False, 4095 + 5000, kv_len)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 100, 1000])
def test_kernel_window(cuda, window):
    _on_card(cuda, 2, 4096, 16, 8, 128, True, 3000, 3001, window)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_len", [1, 2, 63, 65, 3001, 4095])
def test_kernel_ragged_lengths(cuda, kv_len):
    """kv_len 1 (one key, one tile), and lengths that are no multiple of a
    tile, a warp's keys or a split."""
    _on_card(cuda, 3, 4096, 16, 8, 128, True, kv_len - 1, kv_len)


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype,kvdtype", [("float32", "float32"),
                                            ("float32", "bfloat16"),
                                            ("bfloat16", "float32")])
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_kernel_dtypes_and_head_dims(cuda, qdtype, kvdtype, D):
    """fp32 caches and queries, and every head dim (16 and 32: the tests'
    small configs; 80: hubert-xlarge)."""
    _on_card(cuda, 2, 1000, 8, 2, D, True, 900, 901, qdtype=qdtype,
             kvdtype=kvdtype)


@pytest.mark.gpu
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1), (6, 2), (12, 4), (5, 5)])
def test_kernel_small_groups(cuda, D, H, KV):
    """Groups of 2, 4, 3 (padded to 4) and 1 at every head dim."""
    _on_card(cuda, 2, 300, H, KV, D, True, 250, 251)


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", JAX_CASES)
def test_kernel_matches_the_jax_reference(cuda, name, qdtype):
    """The kernel against the JAX package's one-row branch on the same
    inputs: with fp32 q within CARD_RTOL's fp32 limit of JAX's fp32
    output, with bf16 q (the same values) within one rounding to bf16."""
    B, Sk, H, KV, D, causal, q_offset, kv_len, window, kd = JAX_CASES[name]
    q, k, v = _jax_case_inputs(name, device=cuda)
    q = q.to(TORCH_DTYPE[qdtype])
    want = _jax_fixture(name)
    before = decode_attention.launches
    out = decode_attention(q, k, v, causal, q_offset, kv_len, window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.shape == want.shape and out.dtype == q.dtype
    torch.testing.assert_close(out.float().cpu(), want,
                               rtol=CARD_RTOL[q.dtype],
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.gpu
def test_kernel_reads_a_view_of_the_cache(cuda):
    """K and V as a layer's slice of a (L, B, S, KV, D) cache and a KV
    head slice of it: read in place, at their strides."""
    cache = torch.randn(2, 3, 2048, 8, 128, device=cuda).bfloat16()
    q = torch.randn(3, 1, 8, 128, device=cuda).bfloat16()
    k, v = cache[0, :, :, 2:6], cache[1, :, :, 4:8]
    out = decode_attention(q, k, v, True, 1500, 1501)
    ref = decode_attention_ref(q, k.contiguous(), v.contiguous(), True, 1500,
                               1501, 0)
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=CARD_RTOL[torch.bfloat16],
                               atol=1e-6 * float(ref.float().abs().max()))


@pytest.mark.gpu
def test_card_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ops, "decode_attention_ref", refuse)
    q, k, v = _inputs(2, 512, 16, 8, 128, seed=6, qdtype="bfloat16",
                      kvdtype="bfloat16", device=cuda)
    out = layers.attention(q, k, v, causal=True, q_offset=300, kv_len=301)
    torch.cuda.synchronize()
    assert out.device.type == "cuda"


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _inputs(1, 64, 4, 4, 96, seed=7, device=cuda)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q, k, v, True, 10, 11)
    q, k, v = _inputs(1, 64, 32, 1, 64, seed=7, device=cuda)
    with pytest.raises(ValueError, match="more than 16"):
        decode_attention(q, k, v, True, 10, 11)
    q, k, v = _inputs(1, 64, 4, 2, 64, seed=7, device=cuda)
    with pytest.raises(TypeError):
        decode_attention(q.half(), k, v, True, 10, 11)
    with pytest.raises(TypeError, match="host ints"):
        decode_attention(q, k, v, True, 10, torch.tensor(11, device=cuda))
    with pytest.raises(ValueError, match="one device"):
        decode_attention(q.cpu(), k, v, True, 10, 11)
    assert decode_attention.launches == before


CFG = ModelConfig(name="t", family="dense", num_layers=3, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=257,
                  flash_block_kv=16, remat="none",
                  compute_dtype="float32", param_dtype="float32")


@pytest.mark.gpu
def test_a_decode_step_launches_once_a_layer(cuda):
    """A decode cell's step on the card: one launch a layer, and the same
    logits as the step on the CPU."""
    b, s = 2, 40
    cell = steps.build_decode_cell(CFG, ShapeConfig("d", "decode", s, b),
                                   device=cuda)
    host = steps.build_decode_cell(CFG, ShapeConfig("d", "decode", s, b),
                                   device="cpu")
    model = api.init_params(CFG, generator(7, "cpu"))
    cache = api.init_cache(CFG, b, s, "float32", "cpu")
    for t in cache:
        t.normal_(generator=generator(8, "cpu"))
    tok = torch.randint(0, CFG.vocab_size, (b, 1),
                        generator=generator(9, "cpu"))
    want, _ = host.fn(model, [t.clone() for t in cache], tok, 30)
    before = decode_attention.launches
    got, _ = cell.fn(model.to(cuda), [t.to(cuda) for t in cache],
                     tok.to(cuda), 30)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + CFG.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


if __name__ == "__main__":
    _write_jax_fixture()
