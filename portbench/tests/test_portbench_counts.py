"""The frozen counts of the cells against values worked out by hand from
the shapes (PERF.md gives the same arithmetic), and the hybrid family's
at the fixture's size."""
from __future__ import annotations

import json

import pytest

from conftest import FIXTURES, REPO
from portbench import counts, timing
from portbench.spec import spec_of


def spec(name: str):
    path = REPO / "portbench" / "configs" / f"{name}.json"
    if not path.exists():
        path = FIXTURES / "configs" / f"{name}.json"
    return spec_of(json.loads(path.read_text()))


QWEN_MM = 28 * (1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024
                + 3 * 1024 * 3072) + 1024 * 151936
#: tiny-hybrid: 5 Mamba2 layers of d 64 (inner 128, 8 heads, state 16),
#: the shared block (4 heads of 16, d_ff 128) at 2 sites, vocab 512
HYBRID_MM = (5 * (2 * 64 * 128 + 2 * 64 * 16 + 64 * 8 + 128 * 64)
             + 2 * (4 * 64 * 64 + 3 * 64 * 128) + 64 * 512)


def test_matmul_parameters():
    assert counts.matmul_params(spec("qwen3-0.6b")) == QWEN_MM == 595_984_384
    assert counts.matmul_params(spec("tiny-hybrid")) == HYBRID_MM


def test_train_flops_qwen3():
    pairs = 4096 * 4097 / 2
    want = 3 * (2 * QWEN_MM * 4 * 4096 + 28 * 4 * 4 * 16 * 128 * pairs)
    got = counts.model_flops(spec("qwen3-0.6b"), 4, 4096, train=True)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(8.1683e13, rel=1e-4)


def test_prefill_flops_qwen3():
    pairs = 32768 * 32769 / 2
    want = 2 * QWEN_MM * 2 * 32768 + 28 * 4 * 2 * 16 * 128 * pairs
    got = counts.model_flops(spec("qwen3-0.6b"), 2, 32768, train=False)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(3.2441e14, rel=1e-4)


def test_train_and_prefill_flops_of_the_hybrid_family():
    def ssd(b, s):
        nc, tri = s // 16, 16 * 17 / 2
        return b * nc * (2 * tri * 16 + 8 * (2 * tri * 16
                                             + 4 * 16 * 16 * 16))
    pairs = 24 * 25 / 2 + (96 - 24) * 24              # the window binds
    want = 3 * (2 * HYBRID_MM * 4 * 96 + 2 * 4 * 4 * 4 * 16 * pairs
                + 5 * ssd(4, 96))
    assert counts.model_flops(spec("tiny-hybrid"), 4, 96, True) == \
        pytest.approx(want, rel=1e-12)
    want = 2 * HYBRID_MM * 2 * 96 + 2 * 4 * 2 * 4 * 16 * pairs \
        + 5 * ssd(2, 96)
    assert counts.model_flops(spec("tiny-hybrid"), 2, 96, False) == \
        pytest.approx(want, rel=1e-12)


def test_decode_bytes_qwen3():
    cache = 2 * 28 * 8 * 32768 * 8 * 128 * 2          # K and V to 32,767
    params = 28 * (2 * 1024 + 1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024
                   + 2 * 128 + 3 * 1024 * 3072) + 1024 + 1024 * 151936
    want = cache + 4 * (params + 8 * 1024)            # 8 embedding rows
    assert counts.decode_bytes(spec("qwen3-0.6b"), 8, 32767) == want


def test_kernel_costs_and_least_times():
    ops, nbytes = counts.flash_cost(4, 4096, 4096, 16, 8, 128, True, 0,
                                    with_lse=True)
    assert ops == 4 * 4 * 16 * 128 * (4096 * 4097 / 2)
    assert nbytes == 2 * (4 * 4096 * 16 * 128 + 4 * 4096 * 8 * 128) * 2 \
        + 4 * 16 * 4096 * 4
    assert timing.least_s(ops, nbytes) == pytest.approx(ops / 989e12)
    ops, nbytes = counts.flash_cost(2, 32768, 32768, 32, 32, 64, True, 4096)
    assert ops == 4 * 2 * 32 * 64 * (4096 * 4097 / 2 + 28672 * 4096)
    ops, nbytes = counts.ssd_cost(2, 32768, 64, 64, 64, 256)
    assert nbytes == (2 * 2 * 32768 * 64 * 64 * 2 + 4 * (2 * 32768 * 64 + 64)
                      + 2 * 2 * 32768 * 64 * 2)
    assert timing.least_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)
