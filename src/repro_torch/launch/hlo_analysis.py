"""Roofline terms from the recorded op trace of one rank's step (the
port's twin of the JAX package's ``launch/hlo_analysis.py``).

Where the reference parses the SPMD-partitioned HLO text of a compiled
program, this module records what one rank's step does when it runs on
the ``meta`` device (``launch.dryrun``): tensors with shapes and dtypes
and no storage, so a rank of the production mesh is traced in one
process without a card.  ``OpRecorder`` is a ``TorchDispatchMode`` that
sees every aten operation and records, for each:

  * FLOPs: PyTorch's own formulas (``torch.utils.flop_counter``'s
    registry: matrix products, convolutions, attention), the operation
    decomposed first where it has a decomposition, as
    ``FlopCounterMode`` does, so that the two count alike;
  * bytes: operand plus result bytes, what an unfused eager step moves;
    views and aliases (view, reshape, expand, transpose, permute, slice,
    select, detach, ``_unsafe_view``, ``as_strided``, ...) and empty
    allocations move nothing;
  * live bytes: every tensor storage by weak reference, so that the peak
    is the most that was live at once (the arguments included).

The hand-written kernels and the collectives run below the dispatcher;
their wrappers report them (``_trace``): a kernel launch with its
``cost()`` (``kernels/*/ops.py``, the count of the kernels' bounds), a
collective with its operand bytes and group (``parallel``).  A kernel's
plain version never runs on meta.

The reference's fusion-aware byte accounting and its TPU-native dtype
adjustment correct for XLA:CPU's rewrites of the program (fused bodies,
bf16 dots rewritten as fp32).  The trace carries the port's own dtypes
and operations, so neither has anything to correct: ``bytes_raw`` is
``bytes``.

Hardware constants: the NVIDIA H100 SXM5 80 GB datasheet (700 W), never
the TPU's.  Every time this module gives is a prediction at them.

  989 TFLOP/s bf16 dense on the tensor cores | 67 TFLOP/s fp32 |
  3.35 TB/s HBM3 | NVLink 450 GB/s a direction within a node of 8 |
  50 GB/s a GPU across nodes (one 400 Gb/s NDR port) |
  81,559 MiB of device memory ("NVIDIA H100 80GB HBM3")

Terms (seconds), per rank:
  T_compute = sum over operations of FLOPs / the peak of their dtype
  T_memory  = bytes / HBM_BW
  T_coll    = sum over collectives of operand bytes / the rate of the
              slowest link their group spans (NVLink within a node of
              ``GPUS_PER_NODE`` row-major ranks, else the network)
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import weakref
from typing import Dict, List, Optional

import torch
import torch.utils.flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from .. import _trace

DEVICE = "NVIDIA H100 80GB HBM3"
POWER_W = 700                  # the power limit the datasheet rates assume
PEAK_FLOPS = 989e12            # bf16 dense, tensor cores
FP32_PEAK_FLOPS = 67e12        # fp32 outside the tensor cores
HBM_BW = 3.35e12               # bytes/s
NVLINK_BW = 450e9              # bytes/s a direction, within a node
NET_BW = 50e9                  # bytes/s a GPU across nodes
HBM_BYTES = 81_559 * 2 ** 20   # what nvidia-smi reports for the card
GPUS_PER_NODE = 8

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def peak_flops(dtype) -> float:
    """The card's peak rate for products in ``dtype`` (a torch dtype or
    its name): fp32 outside the tensor cores, else the bf16 rate."""
    name = str(dtype).replace("torch.", "")
    return FP32_PEAK_FLOPS if name in ("float32", "float64") else PEAK_FLOPS


def link_bw(ranks) -> float:
    """The rate of a collective over ``ranks``: NVLink where they share a
    node, else the network."""
    return NVLINK_BW if len({r // GPUS_PER_NODE for r in ranks}) <= 1 \
        else NET_BW


# --------------------------------------------------------------------------
# The recorder
# --------------------------------------------------------------------------

_aten = torch.ops.aten
# besides the views (``is_view``: view, expand, transpose, slice, detach,
# as_strided, ...), allocations and ``_unsafe_view`` move no bytes
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten._unsafe_view.default,
}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of modules (their parameters and buffers),
    dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.lru_cache(maxsize=None)
def _moves_nothing(func) -> bool:
    return func in _NO_TRAFFIC or func.is_view


@functools.lru_cache(maxsize=None)
def _decomposes(func) -> bool:
    """Whether ``func.decompose`` has a decomposition to run (the test it
    makes itself, once an operation)."""
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    return func is not torch.ops.prim.device.default and (
        dk in func.py_kernels or
        torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk))


@dataclasses.dataclass
class Trace:
    """One step's record: ``events`` in order (aten operations, kernel
    launches, collectives; each a dict with ``kind``, ``op``, ``flops``,
    ``bytes``, ``dtype``, ``shapes``, ``dtypes``, and a collective's
    ``group_size`` and ``ranks``), the bytes of the arguments, the peak of
    live bytes and the bytes of the step's outputs."""
    events: List[dict] = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    peak_bytes: int = 0
    output_bytes: int = 0
    seconds: float = 0.0

    def of_kind(self, kind: str) -> List[dict]:
        return [e for e in self.events if e["kind"] == kind]

    def collectives(self) -> List[tuple]:
        """(op, group size, bytes) of each collective, in order."""
        return [(e["op"], e["group_size"], e["bytes"])
                for e in self.of_kind("collective")]

    def launches(self, name: str) -> int:
        return sum(1 for e in self.of_kind("kernel") if e["op"] == name)

    def write_jsonl(self, path: str) -> None:
        """One line an event."""
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")


class OpRecorder(TorchDispatchMode):
    """Records a ``Trace`` of what runs under it (see the module doc).

        rec = OpRecorder()
        rec.track(inputs)            # the arguments: live from the start
        with rec:
            out = step(*inputs)
        rec.finish(out)
        rec.trace

    Works on any device; on meta nothing is computed.  The storages of
    tensors made before it started count only once ``track`` is given
    them."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        self._live: Dict[int, tuple] = {}
        self._live_bytes = 0
        self._depth = 0

    # -- storages ---------------------------------------------------------
    def _freed(self, key: int, nbytes: int, _ref) -> None:
        if self._live.pop(key, None) is not None:
            self._live_bytes -= nbytes

    def _hold(self, t: torch.Tensor) -> int:
        """Start following ``t``'s storage; its bytes where it is new."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        nbytes = st.nbytes()
        ref = weakref.ref(st, functools.partial(self._freed, key, nbytes))
        self._live[key] = (ref, nbytes)
        self._live_bytes += nbytes
        return nbytes

    def _peak(self) -> None:
        if self._live_bytes > self.trace.peak_bytes:
            self.trace.peak_bytes = self._live_bytes

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (a module's parameters
        too) as live arguments; returns their new bytes."""
        new = sum(self._hold(t) for t in _tensors(tree))
        self.trace.argument_bytes += new
        self._peak()
        return new

    def finish(self, out) -> None:
        """The bytes of the step's outputs (each storage once)."""
        seen, total = set(), 0
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
        self.trace.output_bytes = total

    # -- events -----------------------------------------------------------
    def _sink(self, event: dict) -> None:
        self.trace.events.append(event)

    def __enter__(self):
        # re-entered for each decomposition: the sink is added once
        self._depth += 1
        if self._depth == 1:
            _trace.sinks.append(self._sink)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            _trace.sinks.remove(self._sink)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        self._peak()
        if func.namespace != "aten":
            return out              # collectives: reported by ``parallel``
        ins = _tensors((args, kwargs))
        flops = 0
        packet = func._overloadpacket
        registry = torch.utils.flop_counter.flop_registry
        if packet in registry:
            flops = registry[packet](*args, **kwargs, out_val=out)
        nbytes = 0 if _moves_nothing(func) else \
            sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        first = (ins or outs or [None])[0]
        self.trace.events.append({
            "kind": "aten", "op": str(func.name()).replace("aten::", ""),
            "flops": flops, "bytes": nbytes,
            "dtype": None if first is None else str(first.dtype)[6:],
            "shapes": [list(t.shape) for t in ins + outs],
            "dtypes": [str(t.dtype)[6:] for t in ins + outs]})
        return out


# --------------------------------------------------------------------------
# Cost of a trace (the reference's ``hlo_cost`` and ``collective_bytes``)
# --------------------------------------------------------------------------

def _result_bytes(event: dict) -> int:
    """A collective's result bytes from its operand's."""
    n, b = event["group_size"], event["bytes"]
    return {"all-gather": n * b, "reduce-scatter": b // n}.get(event["op"], b)


def collective_bytes(trace: Trace) -> Dict[str, int]:
    """Per-kind operand bytes of every collective of the rank's step, and
    their counts under ``_counts``."""
    out = {k: 0 for k in _COLLECTIVES}
    count = {k: 0 for k in _COLLECTIVES}
    for e in trace.of_kind("collective"):
        out[e["op"]] += e["bytes"]
        count[e["op"]] += 1
    out["_counts"] = count
    return out


def op_cost(trace: Trace) -> Dict[str, object]:
    """The rank's whole step: FLOPs (aten and kernels), bytes (aten
    operations, kernels' ``cost()``, collectives' operand and result),
    and the collectives' operand bytes by kind: ``hlo_cost``'s keys, plus
    the three times (``t_compute`` by each operation's dtype,
    ``t_memory``, ``t_collective`` by each group's link)."""
    flops = nbytes = 0.0
    t_compute = t_coll = 0.0
    coll = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for e in trace.events:
        if e["kind"] == "collective":
            coll[e["op"]] += e["bytes"]
            counts[e["op"]] += 1
            nbytes += e["bytes"] + _result_bytes(e)
            t_coll += e["bytes"] / link_bw(e["ranks"])
            continue
        flops += e["flops"]
        nbytes += e["bytes"]
        if e["flops"]:
            t_compute += e["flops"] / peak_flops(e["dtype"])
    return {"flops": flops, "bytes": nbytes, "bytes_raw": nbytes,
            "coll_bytes": float(sum(coll.values())),
            "coll_breakdown": coll, "coll_counts": counts,
            "t_compute": t_compute, "t_memory": nbytes / HBM_BW,
            "t_collective": t_coll}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float              # 6ND train / 2ND decode-prefill (total)
    peak_bytes_per_device: Optional[float] = None

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time: max of the three terms (full overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / traced FLOPs over all ranks: the remat and
        redundancy waste flag."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: model_flops / (step_time * chips * peak)."""
        denom = self.step_time * self.chips * PEAK_FLOPS
        return self.model_flops / denom if denom else float("nan")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(bottleneck=self.bottleneck, step_time=self.step_time,
                 useful_flops_fraction=self.useful_flops_fraction,
                 roofline_fraction=self.roofline_fraction)
        return d


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            trace: Trace, model_flops: float) -> Roofline:
    cost = op_cost(trace)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(cost["flops"]),
        bytes_per_device=float(cost["bytes"]),
        coll_bytes_per_device=float(cost["coll_bytes"]),
        coll_breakdown={**cost["coll_breakdown"],
                        "counts": cost["coll_counts"]},
        t_compute=cost["t_compute"],
        t_memory=cost["t_memory"],
        t_collective=cost["t_collective"],
        model_flops=model_flops,
        peak_bytes_per_device=float(trace.peak_bytes),
    )


# --------------------------------------------------------------------------
# MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference), N = active params
# --------------------------------------------------------------------------

def count_params(shapes_tree) -> int:
    """The elements of a tree of (meta) tensors: ``api.param_shapes``'."""
    return sum(t.numel() for t in _tensors(shapes_tree))


def active_params(cfg, total: int) -> float:
    """MoE: experts contribute topk/E of their weights per token."""
    if not cfg.num_experts:
        return float(total)
    from ..models.transformer import _layer_shapes
    expert_names = ("w_gate", "w_up", "w_down")
    shapes = _layer_shapes(cfg)
    expert = sum(math.prod(shapes[n]) for n in expert_names)
    frac = cfg.experts_per_token / cfg.num_experts
    return float(total - expert + expert * frac)


def model_flops_for(cfg, shape, pshapes) -> float:
    n_total = count_params(pshapes)
    n_act = active_params(cfg, n_total)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    if shape.kind == "train":
        return 6.0 * n_act * tokens
    return 2.0 * n_act * tokens
