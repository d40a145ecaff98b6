"""The coded training batch, worked out again from the seed.

A frozen copy of the synthetic token stream the program trains on (Zipf
marginals with a copy-8-back pattern, counter-based on (seed, step,
part)), the fractional-repetition layout (worker i holds part group
i // c) and the decode coefficients (the lowest-index finisher of each
group; with a group of no finisher, the full barrier: the first member of
every group), expanded to one loss weight a row, scaled by coded rows
over unique rows.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, *xs: int) -> np.random.Generator:
    return np.random.default_rng(np.uint64(seed)
                                 + np.uint64(hash(xs) & 0x7FFFFFFF))


def part_rows(vocab: int, seq: int, rows: int, seed: int, step: int,
              part: int):
    rng = _rng(seed, step, part)
    z = rng.zipf(1.3, size=(rows, seq + 1))
    toks = (z % (vocab - 1)).astype(np.int32) + 1
    mask = rng.random((rows, seq + 1)) < 0.5
    toks[:, 8:][mask[:, 8:]] = toks[:, :-8][mask[:, 8:]]
    return toks[:, :-1], toks[:, 1:]


def decode_coefficients(alive: np.ndarray, c: int) -> np.ndarray:
    groups = np.asarray(alive, bool).reshape(-1, c)
    a = np.zeros(groups.size, np.float32)
    if groups.any(axis=1).all():
        a[np.arange(len(groups)) * c + groups.argmax(axis=1)] = 1.0
    else:
        a[np.arange(len(groups)) * c] = 1.0
    return a


def coded_rows(vocab: int, seq: int, unique: int, n: int, c: int,
               seed: int, step: int, alive: np.ndarray):
    """(tokens, labels, weights) of the coded batch at ``step``: n worker
    blocks of unique * c / n rows."""
    groups = n // c
    parts = [part_rows(vocab, seq, unique // groups, seed, step, j)
             for j in range(groups)]
    toks = np.concatenate([parts[i // c][0] for i in range(n)])
    labs = np.concatenate([parts[i // c][1] for i in range(n)])
    per_worker = unique * c // n
    w = np.repeat(decode_coefficients(alive, c), per_worker) * (
        unique * c / unique)
    return toks, labs, w.astype(np.float32)
