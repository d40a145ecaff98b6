"""Operations and bytes, counted from shapes (frozen here, whatever
implements the step).

* ``model_flops``: a forward's model operations over ``batch`` rows of
  ``seq`` tokens, times 3 for a training step (forward and backward):
  2 x matmul parameters x tokens, plus what the family's layers add
  (attention's 4 * H * D a kept (query, key) pair, the SSD scan's
  operations), as the spec's family counts them.
* ``decode_bytes``: what a decode step must read once, each leaf in the
  dtype the configuration holds it; None where the family counts no
  decode step.
* ``flash_cost`` and ``ssd_cost``: the kernels' operations and bytes a
  launch, bytes moved once (a frozen copy of the port's ``cost``).
"""
from __future__ import annotations

from typing import Optional, Tuple

from .spec import Spec, family_of


def kept_pairs(sq: int, sk: int, causal: bool = True, window: int = 0
               ) -> float:
    """(query, key) pairs a head keeps, queries at key positions
    sk - sq .. sk - 1."""
    if not causal:
        return float(sq * sk)

    def upto(n: int) -> float:
        w = window if 0 < window < n else n
        return w * (w + 1) / 2 + (n - w) * w
    return upto(sk) - upto(sk - sq)


def flash_cost(b: int, sq: int, sk: int, h: int, kv: int, d: int,
               causal: bool = True, window: int = 0, with_lse: bool = False,
               itemsize: int = 2) -> Tuple[float, float]:
    ops = 4.0 * b * h * kept_pairs(sq, sk, causal, window) * d
    nbytes = 2 * (b * sq * h * d + b * sk * kv * d) * itemsize
    if with_lse:
        nbytes += b * h * sq * 4
    return ops, float(nbytes)


def ssd_cost(b: int, s: int, h: int, p: int, n: int, chunk: int,
             itemsize: int = 2) -> Tuple[float, float]:
    nc, tri = s // chunk, chunk * (chunk + 1) / 2
    ops = b * nc * (2.0 * tri * n + h * (2.0 * tri * p + 4.0 * chunk * n * p))
    nbytes = (2 * b * s * h * p * itemsize + 4 * (b * s * h + h)
              + 2 * b * s * n * itemsize)
    return ops, float(nbytes)


def matmul_params(s: Spec) -> float:
    """Parameters that enter a matrix product once a token."""
    return family_of(s).matmul_params(s)


def model_flops(s: Spec, batch: int, seq: int, train: bool) -> float:
    return family_of(s).model_flops(s, batch, seq, train)


def decode_bytes(s: Spec, batch: int, position: int, param_bytes: int = 4,
                 cache_bytes: int = 2) -> Optional[float]:
    """Bytes a decode step of ``batch`` rows at ``position`` must read
    once."""
    count = getattr(family_of(s), "decode_bytes", None)
    return None if count is None else count(s, batch, position, param_bytes,
                                            cache_bytes)
