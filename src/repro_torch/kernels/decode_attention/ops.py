"""Public wrapper for the split-KV decode attention (one query row a
sequence over its cache).

A CPU tensor takes the plain version (``ref.py``), and so does a ``meta``
tensor: the dry run (``launch.dryrun``) traces the reference's dense pass,
so its counts are the reference's.  A CUDA tensor launches the Hopper
kernel (``kernel.py``) after the checks below, or raises.  Every argument
is a tensor's shape or a host int, so the wrapper never synchronises.
The keys a row keeps are one range, ``kept_range``; ``split_plan`` cuts
it into the kernel's splits from the shape alone.  A decode step calls
the wrapper once a layer with one layout, so the checks and the plan are
cached by layout, and the splits' scratch is one buffer a stream.
``decode_attention.launches`` counts the kernel's launches; each reports
``cost``'s operations and bytes to the op recorder (``_trace``).
"""
from __future__ import annotations

import functools
import numbers
from typing import Optional, Tuple

import torch

from ... import _trace
from . import kernel
from .ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128)
MAX_GROUP = 16          # query heads a KV head (csrc: GM up to 16)
TILE = 64               # keys a stage of the kernel's ring (csrc: TILE)
MIN_SPLIT_TILES = 4     # a split streams at least this many tiles
BLOCKS_PER_SM = 16      # splits aim at this many blocks an SM in the grid
_GRID_MAX = 65535       # the grid's y (KV heads) and z (rows)
_INT_MAX = 2 ** 31 - 1


def kept_range(sk: int, causal: bool, q_offset: int,
               kv_len: Optional[int] = None, window: int = 0
               ) -> Tuple[int, int]:
    """[lo, hi): the keys the row at ``q_offset`` keeps among ``sk``, as
    ``ref._mask`` keeps them: under ``causal`` up to its own position and,
    with ``window`` > 0, the last ``window`` of those; below ``kv_len``."""
    lo, hi = 0, sk
    if kv_len is not None:
        hi = min(hi, kv_len)
    if causal:
        hi = min(hi, q_offset + 1)
        if window > 0:
            lo = max(lo, q_offset - window + 1)
    return lo, hi


def split_plan(n_keys: int, rows: int, sms: int) -> Tuple[int, int]:
    """(chunk, nsplit): ``n_keys`` kept keys of each of ``rows`` (row, KV
    head) pairs cut into ``nsplit`` splits of ``chunk`` keys (a multiple
    of TILE; the last split may be shorter), so that the grid holds about
    BLOCKS_PER_SM blocks for each of ``sms`` SMs and no split is shorter
    than MIN_SPLIT_TILES tiles, unless the range is."""
    tiles = -(-n_keys // TILE)
    want = -(-BLOCKS_PER_SM * sms // rows)
    nsplit = max(1, min(want, tiles // MIN_SPLIT_TILES))
    chunk = -(-tiles // nsplit) * TILE
    return chunk, -(-n_keys // chunk)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def cost(q: torch.Tensor, k: torch.Tensor, lo: int, hi: int):
    """(operations, bytes) of one launch: 4 * D a kept (key, query head)
    pair (q . k and p . v), the kept keys and values of every (row, KV
    head) read once, q read and o written once.  The splits' scratch is
    the kernel's own and not counted."""
    b, _, h, d = q.shape
    n = max(hi - lo, 0)
    ops = 4.0 * b * h * n * d
    nbytes = 2 * b * k.shape[2] * n * d * k.element_size() \
        + 2 * q.numel() * q.element_size()
    return ops, nbytes


def _report(q, k, v, out, lo: int, hi: int) -> None:
    """One launch to the op recorder: ``cost``, and the shapes and dtypes
    of the operands and the output."""
    if _trace.sinks:
        ops, nbytes = cost(q, k, lo, hi)
        tensors = (q, k, v, out)
        _trace.emit({"kind": "kernel", "op": "decode_attention",
                     "flops": ops, "bytes": nbytes,
                     "dtype": str(k.dtype)[6:],
                     "shapes": [list(t.shape) for t in tensors],
                     "dtypes": [str(t.dtype)[6:] for t in tensors]})


def _is_int(x) -> bool:
    return isinstance(x, numbers.Integral) and not isinstance(x, bool)


@functools.lru_cache(maxsize=4096, typed=True)
def _layout(qshape, qdtype, kshape, kstride, vshape, vstride, kdtype, vdtype,
            causal: bool, q_offset: int, kv_len: Optional[int], window: int
            ) -> Tuple[int, int]:
    """``_check`` of everything but the data pointers: a pure function of
    the shapes, strides, dtypes and host ints, so a decode step's layers
    (one layout a position) check it once."""
    if len(qshape) != 4 or qshape[1] != 1 or len(kshape) != 4 \
            or vshape != kshape:
        raise ValueError(f"need q (B, 1, H, D) and k, v (B, Sk, KV, D); got "
                         f"{tuple(qshape)}, {tuple(kshape)}, "
                         f"{tuple(vshape)}")
    (b, _, h, d), (b2, sk, kv, d2) = qshape, kshape
    if b != b2 or d != d2 or kv < 1 or h % kv != 0:
        raise ValueError(f"shape mismatch: q {tuple(qshape)}, "
                         f"k {tuple(kshape)} (H must be a multiple of KV)")
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} query heads a KV head: more than "
                         f"{MAX_GROUP}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if qdtype not in (torch.float32, torch.bfloat16) or \
            kdtype not in (torch.float32, torch.bfloat16) or \
            vdtype != kdtype:
        raise TypeError(f"q must be float32 or bfloat16 and k, v share one "
                        f"of them, got {qdtype}, {kdtype}, {vdtype}")
    if not (_is_int(q_offset) and _is_int(window)
            and (kv_len is None or _is_int(kv_len))):
        raise TypeError(f"q_offset, kv_len and window must be host ints, "
                        f"got {type(q_offset).__name__}, "
                        f"{type(kv_len).__name__}, {type(window).__name__}")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0: none), got {window}")
    if min(b, sk) < 1 or max(b, kv) > _GRID_MAX or sk > _INT_MAX:
        raise ValueError(f"sizes out of range: q {tuple(qshape)}, "
                         f"k {tuple(kshape)}")
    lo, hi = kept_range(sk, causal, q_offset, kv_len, window)
    if hi <= lo:
        raise ValueError(f"the row keeps no key: Sk {sk}, causal {causal}, "
                         f"q_offset {q_offset}, kv_len {kv_len}, "
                         f"window {window}")
    for name, stride in (("k", kstride), ("v", vstride)):
        if stride[3] != 1 or any(st * kdtype.itemsize % 16
                                 for st in stride[:3]):
            raise ValueError(f"{name} must have a contiguous head dim and "
                             f"16-byte aligned rows (the kernel copies "
                             f"16-byte pieces of each), got strides "
                             f"{stride}")
    return int(lo), int(hi)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           q_offset: int, kv_len: Optional[int], window: int
           ) -> Tuple[int, int]:
    """Raise on what the kernel does not take; else the kept range."""
    lo, hi = _layout(q.shape, q.dtype, k.shape, k.stride(), v.shape,
                     v.stride(), k.dtype, v.dtype, causal, q_offset, kv_len,
                     window)
    if (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError(f"k and v must start 16-byte aligned (the kernel "
                         f"copies 16-byte pieces of their rows), got "
                         f"addresses {k.data_ptr():#x}, {v.data_ptr():#x}")
    return lo, hi


@functools.lru_cache(maxsize=None)
def _plan(n_keys: int, rows: int, device: torch.device) -> Tuple[int, int]:
    return split_plan(n_keys, rows, _sms(device))


_SCRATCH = {}           # (device, stream) -> fp32 scratch, grown on demand


def _scratch(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    """The splits' fp32 scratch for launches on ``stream``: one buffer a
    stream, reused, since launches on one stream run in turn."""
    buf = _SCRATCH.get((device, stream))
    if buf is None or buf.numel() < numel:
        buf = _SCRATCH[device, stream] = torch.empty(
            numel, dtype=torch.float32, device=device)
    return buf


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, q_offset: Optional[int] = None,
                     kv_len: Optional[int] = None,
                     window: int = 0) -> torch.Tensor:
    """q (B, 1, H, D), k/v (B, Sk, KV, D) -> (B, 1, H, D) in ``q.dtype``:
    the row at key position ``q_offset`` (default Sk - 1) against the keys
    it keeps (``kept_range``).

    On the CPU or meta: the plain version.  All three on one CUDA device:
    the kernel, K and V read in place (a view of a cache will do).
    Anything else raises.
    """
    device = q.device
    if k.device != device or v.device != device:
        raise ValueError(f"q, k and v must be on one device, got "
                         f"{sorted(map(str, {device, k.device, v.device}))}")
    if q_offset is None:
        q_offset = k.shape[1] - 1
    if device.type in ("cpu", "meta"):
        return decode_attention_ref(q, k, v, causal, q_offset, kv_len, window)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lo, hi = _check(q, k, v, causal, q_offset, kv_len, window)
    b, _, h, d = q.shape
    chunk, nsplit = _plan(hi - lo, b * k.shape[2], device)
    q = q.contiguous()
    out = torch.empty_like(q)
    # the handle alone: ``torch.cuda.current_stream`` builds a Stream object
    # (10 us a call on the card's host, a quarter of the wrapper's time)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    scratch = _scratch(device, stream, b * h * nsplit * (d + 2))
    if device.index == torch.cuda.current_device():
        kernel.launch(q, k, v, out, scratch, lo, hi, chunk, nsplit, stream)
    else:
        with torch.cuda.device(device):
            kernel.launch(q, k, v, out, scratch, lo, hi, chunk, nsplit,
                          stream)
    decode_attention.launches += 1
    _report(q, k, v, out, lo, hi)
    return out


decode_attention.launches = 0
