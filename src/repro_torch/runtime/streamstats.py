"""Streaming statistics state machines for the fleet-scale engine.

The chunked cluster engine (``runtime.fleet``) never materializes the
(reps, loads, K, num_jobs) latency cube; instead each lane carries a
fixed-size statistics state across job chunks:

  * **Welford count/mean/M2** — merged per chunk with the parallel
    (Chan et al.) update, so the running mean/variance are independent
    of the chunk partition up to float rounding.
  * **Algorithm-R reservoir** — a fixed-size uniform sample of the
    included latencies, from which p50/p95/p99 are computed on the
    host.  The per-item acceptance uniforms are drawn per chunk from a
    dedicated key stream shared across lanes (CRN-paired sketches), and
    depend only on the GLOBAL job index — so the reservoir contents are
    bit-identical across chunk sizes, and when the number of included
    samples is at most the reservoir capacity the sketch holds every
    sample and the quantiles are EXACT.

Inclusion (warmup discard, completion under a failure model) is a
per-item weight mask, never a reshape.

The update functions are torch operations on the lanes' device, with no
loop over items: Vitter's sequential Algorithm R is vectorized over a
chunk (``reservoir_update_chunk``); the ``*_host`` finalizers are numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "reservoir_init", "reservoir_update_chunk", "reservoir_values_host",
    "welford_finalize_host", "welford_init", "welford_merge_chunk",
]


# --------------------------------------------------------------------------
# Welford count / mean / M2 (parallel merge per chunk)
# --------------------------------------------------------------------------

def welford_init(lanes: int, device) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Per-lane (count int64, mean float32, M2 float32) zeros."""
    return (torch.zeros((lanes,), dtype=torch.int64, device=device),
            torch.zeros((lanes,), dtype=torch.float32, device=device),
            torch.zeros((lanes,), dtype=torch.float32, device=device))


def welford_merge_chunk(state, vals, w):
    """Merge one chunk of per-lane samples into the running state.

    ``vals`` (lanes, m) latencies; ``w`` (lanes, m) boolean inclusion.
    The chunk is first reduced to (count, mean, M2) in one vectorized
    pass, then merged with the carried state by the parallel-Welford
    rule — associative up to float rounding, so the final state agrees
    across chunk partitions to ulp-level.
    """
    cnt, mean, m2 = state
    dt = vals.dtype
    wf = w.to(dt)
    c_cnt = w.sum(dim=1)
    c_tot = c_cnt.clamp(min=1).to(dt)
    c_mean = (vals * wf).sum(dim=1) / c_tot
    c_m2 = (wf * (vals - c_mean[:, None]) ** 2).sum(dim=1)
    tot = cnt + c_cnt
    totf = tot.clamp(min=1).to(dt)
    delta = c_mean - mean
    mean_n = mean + delta * c_cnt.to(dt) / totf
    m2_n = m2 + c_m2 + delta ** 2 * (cnt * c_cnt).to(dt) / totf
    return tot, mean_n, m2_n


def welford_finalize_host(cnt, mean, m2):
    """Merge per-replication states (axis 0) into pooled float64
    (count, mean, variance) per lane — the host-side final reduction."""
    cnt = np.asarray(cnt, np.int64)
    mean = np.asarray(mean, np.float64)
    m2 = np.asarray(m2, np.float64)
    tot = cnt.sum(axis=0)
    totf = np.maximum(tot, 1).astype(np.float64)
    pooled_mean = (cnt * mean).sum(axis=0) / totf
    pooled_m2 = (m2 + cnt * (mean - pooled_mean) ** 2).sum(axis=0)
    var = pooled_m2 / totf
    return tot, pooled_mean, var


# --------------------------------------------------------------------------
# Algorithm-R reservoir (fixed-size uniform sample)
# --------------------------------------------------------------------------

def reservoir_init(lanes: int, capacity: int, device) -> torch.Tensor:
    """(lanes, capacity) empty reservoir."""
    return torch.zeros((lanes, int(capacity)), dtype=torch.float32,
                       device=device)


def reservoir_update_chunk(res, cnt, vals, w, u):
    """Fold one chunk of per-lane samples into the reservoirs.

    ``res`` (lanes, R); ``cnt`` (lanes,) included-so-far counts (the
    Welford count BEFORE this chunk — the two states share one
    counter); ``vals``/``w`` (lanes, m); ``u`` (m,) float32 acceptance
    uniforms shared across lanes (drawn from the global job index, which
    is what makes the sketch chunk-partition invariant AND CRN-paired
    across lanes).  Item i with running count t either fills slot t-1
    (t <= R) or replaces slot floor(u_i * t) with probability R/t —
    Vitter's Algorithm R.

    The sequential rule, vectorized: every item's running count is
    ``cnt + cumsum(w)``, so its slot is known up front; of the items
    that write one slot, the LAST one's value is what the sequential
    loop leaves there.  A ``scatter_reduce`` "amax" of the item index
    per slot finds it (max is order-free, so the result is
    deterministic on the card, where a plain scatter with duplicate
    indices is not), and one gather copies the values.  Returns
    ``(res', cnt')`` — bit for bit what the item-by-item loop gives.
    """
    lanes, R = res.shape
    m = vals.shape[1]
    t = cnt[:, None] + torch.cumsum(w.to(torch.int64), dim=1)
    tf = t.to(torch.float32)
    pos = torch.where(t <= R, t - 1,
                      torch.floor(u[None, :] * tf).to(torch.int64))
    write = w & (pos >= 0) & (pos < R)
    slot = torch.where(write, pos, R)            # column R: no write
    item = torch.arange(m, device=vals.device).expand(lanes, m)
    last = torch.full((lanes, R + 1), -1, dtype=torch.int64,
                      device=vals.device)
    last = last.scatter_reduce(1, slot, item, reduce="amax")[:, :R]
    fresh = vals.gather(1, last.clamp(min=0))
    return torch.where(last >= 0, fresh, res), t[:, -1]


def reservoir_values_host(res, cnt):
    """Pool reservoir contents across replications (axis 0) per lane.

    Returns a list-of-arrays indexed by lane: replication r contributes
    its first min(cnt, R) slots.  When every replication's count is at
    most R this is exactly the multiset of all included samples.
    """
    res = np.asarray(res, np.float64)                    # (reps, lanes, R)
    cnt = np.asarray(cnt, np.int64)                      # (reps, lanes)
    reps, lanes, R = res.shape
    out = []
    for b in range(lanes):
        parts = [res[r, b, :min(int(cnt[r, b]), R)] for r in range(reps)]
        out.append(np.concatenate(parts) if parts else np.empty((0,)))
    return out
