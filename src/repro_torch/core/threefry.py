"""Counter-based random bits: Threefry-2x32 in plain torch integer ops.

The chunked fleet engine needs draws keyed on the GLOBAL job index: job
j's row must be a pure function of (seed, stream, j), so that any
chunking of [0, N) draws the same rows bit for bit, on any device.  A
``torch.Generator`` cannot give that — re-seeding one per job costs
launches per job, and Philox offsets map to elements by launch geometry
on CUDA (the CPU generator is MT19937 besides).  So keys and counters go
through Threefry-2x32 with 20 rounds (Salmon, Moraes, Dror and Shaw,
"Parallel random numbers: as easy as 1, 2, 3", SC'11), the block cipher
under ``jax.random``.  It needs only 32-bit add, xor and rotate, which
int64 tensors masked with ``0xFFFFFFFF`` hold exactly; no word is ever
multiplied, so nothing relies on integer wrap-around.

A key is an int64 tensor whose last axis holds two 32-bit words.
``fold_in(key, d)`` is the cipher of the counter (0, d) under ``key`` —
the same function as ``jax.random.fold_in`` on a raw threefry key, bit
for bit; ``split`` enciphers the counters (1, i), so it never collides
with a fold-in.  ``bits(keys, width)`` enciphers (0, c) for c in
[0, ceil(width / 2)) under every key and lays out both output words;
``uniform`` turns a word into a float32 in [0, 1) on the 2^-24 grid
(exact, so the host and the card agree on every uniform).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._device import DEFAULT_DEVICE, resolve

__all__ = ["bits", "fold_in", "key", "split", "threefry2x32", "uniform"]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32-20 of the counter words (x0, x1) under the key words
    (k0, k1).  All four are int64 tensors of 32-bit values that
    broadcast against each other; returns the two cipher words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def key(seed: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """The (2,) key of an integer seed: its high and low 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=resolve(device))


def _encipher(keys: torch.Tensor, c0, c1) -> torch.Tensor:
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], c0, c1)
    return torch.stack([y0, y1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``keys`` (..., 2) folded with the integer ``data`` (an int or an
    int64 tensor that broadcasts against ``keys[..., 0]``)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    return _encipher(keys, torch.zeros_like(d), d)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` independent keys from ``keys`` (2,): a (num, 2) tensor."""
    i = torch.arange(int(num), dtype=torch.int64, device=keys.device)
    return _encipher(keys[None], torch.ones_like(i), i)


def bits(keys: torch.Tensor, width: int) -> torch.Tensor:
    """(..., width) 32-bit words (int64) per key of ``keys`` (..., 2):
    word c of a row is cipher word 0 of counter (0, c) for c below
    ceil(width / 2), and cipher word 1 of counter (0, c - ceil(width/2))
    above — a pure function of (key, width, c)."""
    half = -(-int(width) // 2)
    c = torch.arange(half, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(c),
                          c)
    return torch.cat([y0, y1], dim=-1)[..., :int(width)]


def uniform(keys: torch.Tensor, width: int) -> torch.Tensor:
    """(..., width) float32 uniforms in [0, 1) on the 2^-24 grid: the top
    24 bits of each word, scaled exactly."""
    return (bits(keys, width) >> 8).to(torch.float32) * (2.0 ** -24)
