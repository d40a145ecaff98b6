"""Operations and bytes, counted from shapes (frozen here, whatever
implements the step).

* ``model_flops``: 2 x matmul parameters x tokens, plus attention's
  4 * H * D a kept (query, key) pair, plus the SSD scan's operations
  (``ssd_cost``); times 3 for a training step (forward and backward).
  The hybrid's shared block counts once for each site it is applied at.
* ``decode_bytes``: what a decode step must read once: the K and V cache
  up to each row's position and every parameter but the embedding table
  (whose B rows it looks up), each in the dtype the configuration holds it.
* ``flash_cost`` and ``ssd_cost``: the kernels' operations and bytes a
  launch, bytes moved once (a frozen copy of the port's ``cost``).
"""
from __future__ import annotations

from typing import Tuple

from .spec import Spec
from .weights import param_shapes


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
    """Parameters that enter a matrix product once a token: every layer
    leaf of rank 3 or more, the head, and the shared block once a site."""
    total = 0.0
    for name, shape in param_shapes(s).items():
        size = 1
        for n in shape:
            size *= n
        leaf = name.split(".")[-1]
        if name == "lm_head":
            total += size
        elif name.startswith("layers.") and len(shape) >= 3 \
                and not leaf.startswith("conv"):
            total += size
        elif name.startswith("shared_attn.") and len(shape) >= 2:
            total += size * s.sites
    return total


def attention_layers(s: Spec) -> int:
    return s.layers if s.family == "dense" else s.sites


def model_flops(s: Spec, batch: int, seq: int, train: bool) -> float:
    """Model operations of one forward (x 3 for training) over ``batch``
    rows of ``seq`` tokens."""
    tokens = batch * seq
    flops = 2.0 * matmul_params(s) * tokens
    flops += (attention_layers(s) * 4.0 * batch * s.heads * s.head_dim
              * kept_pairs(seq, seq, True, s.window))
    if s.family == "hybrid":
        flops += s.layers * ssd_cost(batch, seq, s.ssm_heads, s.ssm_head_dim,
                                     s.ssm_state, s.ssm_chunk)[0]
    return 3.0 * flops if train else flops


def decode_bytes(s: Spec, batch: int, position: int,
                 param_bytes: int = 4, cache_bytes: int = 2) -> float:
    """Bytes a dense decoder's step at ``position`` must read once."""
    cache = (2.0 * s.layers * batch * (position + 1) * s.kv_heads
             * s.head_dim * cache_bytes)
    params = 0.0
    for name, shape in param_shapes(s).items():
        size = 1
        for n in shape:
            size *= n
        params += batch * s.d if name == "embed" else size
    return cache + params * param_bytes
