"""Deterministic synthetic token pipeline with coded-shard assignment (the
port's own copy of the JAX package's ``data/pipeline.py``).

Batches come from a counter-based numpy stream keyed by (seed, step,
part), so any worker can regenerate any part of any step on its own, and
the batches are the reference's bit for bit.

Coded layout (gradient coding, fractional repetition):
  * the global step's UNIQUE data is ``num_part_groups`` part-groups;
  * worker-group j's workers all receive part-group j (replication factor c);
  * ``coded_batch`` materializes the (n_workers * per_worker, seq) token
    block whose row-blocks are the workers' slices of the batch.

Only ``expand_worker_weights`` touches a tensor: it expands the decode
coefficients inside the training step, on the step's device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from ..core.coding import FractionalRepetitionCode


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _fold(seed: int, *xs: int) -> np.random.Generator:
    return np.random.default_rng(np.uint64(seed) + np.uint64(hash(xs) & 0x7FFFFFFF))


def synthetic_batch(cfg: DataConfig, step: int,
                    part: int = 0, num_parts: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, labels) for one data part of one step, deterministically.

    Zipf-ish marginals + a shifted-copy structure so the LM loss is
    learnable (labels = next token).
    """
    if cfg.global_batch % num_parts:
        raise ValueError(f"global_batch {cfg.global_batch} does not split "
                         f"into {num_parts} parts")
    rows = cfg.global_batch // num_parts
    rng = _fold(cfg.seed, step, part)
    # Zipf-like unigram draws, then 1-step Markov smoothing for structure
    z = rng.zipf(1.3, size=(rows, cfg.seq_len + 1))
    toks = (z % (cfg.vocab_size - 1)).astype(np.int32) + 1
    # periodic copy pattern: position t copies t-8 with prob ~ 1/2
    mask = rng.random((rows, cfg.seq_len + 1)) < 0.5
    toks[:, 8:][mask[:, 8:]] = toks[:, :-8][mask[:, 8:]]
    return toks[:, :-1], toks[:, 1:]


def batch_iterator(cfg: DataConfig, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, step)
        step += 1


def coded_batch(cfg: DataConfig, step: int, code: FractionalRepetitionCode
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Replicated-layout batch for coded-DP: (n * per_worker, seq).

    Row-block i carries the part-group of worker i's group.  The unique
    data is ``global_batch`` rows split over ``num_groups`` part-groups;
    each is replicated on the c workers of its group, so the materialized
    batch has ``c`` x the unique rows.
    """
    g = code.num_groups
    if cfg.global_batch % g:
        raise ValueError(f"global_batch {cfg.global_batch} does not split "
                         f"over {g} part groups")
    parts = [synthetic_batch(cfg, step, part=j, num_parts=g) for j in range(g)]
    tok_rows, lab_rows = [], []
    for i in range(code.n):
        t, l = parts[code.group_of(i)]
        tok_rows.append(t)
        lab_rows.append(l)
    return np.concatenate(tok_rows, axis=0), np.concatenate(lab_rows, axis=0)


def decode_example_weights(code: FractionalRepetitionCode,
                           worker_weights: np.ndarray,
                           per_worker_rows: int,
                           unique_rows: int) -> np.ndarray:
    """Expand per-worker decode coefficients a_i to per-example loss weights.

    With a_i from ``gc_decode_weights`` (one finisher per group), the
    weighted per-example mean over the coded batch equals the plain mean
    over the ``unique_rows`` unique examples -- the decode IS the gradient
    reduction.  Weight = a_i * (coded_rows / unique_rows) compensates the
    mean normalization.
    """
    coded_rows = code.n * per_worker_rows
    scale = coded_rows / unique_rows
    w = np.repeat(worker_weights.astype(np.float32), per_worker_rows) * scale
    return w


def expand_worker_weights(worker_weights: torch.Tensor, per_worker_rows: int,
                          scale: float) -> torch.Tensor:
    """Tensor twin of ``decode_example_weights`` inside the training step:
    the host ships only the (n,) decode coefficients, expanded here on
    their device."""
    return torch.repeat_interleave(worker_weights.float(),
                                   per_worker_rows) * scale
