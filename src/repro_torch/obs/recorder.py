"""The flight recorder: structured spans + typed events on a ring.

One process-global ``Recorder`` (installed with :func:`install` or the
:func:`recording` context manager) collects every layer's typed events —
drift alarms, plan commits, cache hits/misses, a new surface key's first
call, oracle fallbacks, quarantines, actuator applies, SLO burns — on a
single monotonic timeline, bounded by a ring buffer, exportable as JSONL
and parseable back into the identical typed events (round-trip pinned by
``tests/test_torch_obs_spans.py``).

Clock discipline (DESIGN.md §12): timestamps come from a MONOTONIC
clock (``time.perf_counter``) rebased to the recorder's install epoch.
They are observability-only — controller *decisions* remain pure
functions of the sample stream (the wall-clock-free contract of
``control/controller.py``), which is why every decision-relevant event
also carries its logical index (the CU-sample counter ``at``) in its
fields: the decision log reconstructed from a trace is clock-free and
bit-for-bit comparable across machines.

Spans on the hot path (the train and decode steps, their attention and
AdamW) carry what a trace of the device needs: a span id, the id of
the span that opened it (its ``parent``) and of the step or request it
belongs to (its ``unit``); with ``device=`` a CUDA device, its start
and end as CUDA events on the current stream, read only after the work
(``dev_start`` / ``dev_end``: seconds from the recorder's first device
event on that device); and a ``torch.profiler.record_function`` range
of its name, so that a profiler session that records user annotations
shows the program's spans beside its kernels.  A span opened on a
thread with no open span of its own (autograd's backward thread) takes
the newest span still open in the process as its parent: the one whose
thread waits on it.  :data:`SPANS` reads the installed recorder's
totals of a span name by path (``SPANS.optim.adamw.device_ns``): its
count, host and device nanoseconds over the spans the ring holds.

Disabled-recorder cost: when no recorder is installed, ``active()``
returns None, ``span()`` hands back one shared no-op singleton, and
``event()`` returns before touching anything — no CUDA event, no
profiler range, and every total reads 0.  Instrumented hot paths
guard with ``active()`` where building an event's payload would
allocate.
"""
from __future__ import annotations

import dataclasses
import io
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

__all__ = ["EVENT_KINDS", "Event", "NULL_SPAN", "Recorder", "SPANS",
           "active", "event", "install", "parse_jsonl", "recording",
           "span", "uninstall"]

#: The event taxonomy (DESIGN.md §12).  Exporters and parsers reject
#: unknown kinds so a trace file is schema-checked on both ends.
EVENT_KINDS = frozenset({
    "drift_alarm",      # a detector channel crossed (service/load/failure/slo)
    "commit",           # the controller committed a (model, policy) decision
    "cache_hit",        # surface cache: a known structural key
    "cache_miss",       # surface cache: a new structural key
    "compile",          # a new surface key's first call (fields: its wall ms)
    "oracle_fallback",  # sweep backend failed; commit re-planned on the DES
    "quarantine",       # the controller's quarantine set changed
    "actuate",          # an actuator applied a committed (policy, model)
    "slo_alarm",        # the SLO monitor's multi-window burn crossed
    "infeasible",       # a commit aborted: no finite cell on the surface
    "sweep",            # one cluster-engine surface call (batched/fleet rep)
    "span",             # a closed span (name, start ts, duration)
    "mark",             # free-form annotation (regime boundaries, footers)
})


#: A span's keys beyond an event's, in JSONL only where set.
SPAN_KEYS = ("span_id", "parent", "unit", "dev_start", "dev_end")


@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded event.  ``ts`` is seconds on the recorder's
    monotonic clock (epoch = recorder install); ``dur`` is a span's
    duration in seconds (None for instantaneous events); ``fields`` are
    the kind-specific payload (JSON-serializable scalars/lists only).
    A span also has its ``span_id``, its ``parent``'s id and its
    ``unit`` (the step or request it belongs to), None where it has
    none; a span timed on a device has ``dev_start`` and ``dev_end``,
    seconds on that device's clock from the recorder's first device
    event there."""

    ts: float
    kind: str
    name: str = ""
    dur: Optional[float] = None
    fields: Tuple[Tuple[str, Any], ...] = ()
    span_id: Optional[int] = None
    parent: Optional[int] = None
    unit: Optional[Any] = None
    dev_start: Optional[float] = None
    dev_end: Optional[float] = None

    def field_dict(self) -> Dict[str, Any]:
        return dict(self.fields)

    @property
    def dev_dur(self) -> Optional[float]:
        """The span's duration on the device's clock, None off it."""
        return None if self.dev_start is None \
            else self.dev_end - self.dev_start

    def to_json(self) -> str:
        obj = {"ts": self.ts, "kind": self.kind, "name": self.name,
               "dur": self.dur, "fields": dict(self.fields)}
        for k in SPAN_KEYS:
            v = getattr(self, k)
            if v is not None:
                obj[k] = v
        return json.dumps(obj, separators=(",", ":"), sort_keys=True)

    @staticmethod
    def from_json(line: str) -> "Event":
        obj = json.loads(line)
        kind = obj["kind"]
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r} in trace line")
        fields = obj.get("fields", {})
        return Event(ts=float(obj["ts"]), kind=kind,
                     name=obj.get("name", ""),
                     dur=None if obj.get("dur") is None
                     else float(obj["dur"]),
                     fields=tuple(sorted(
                         (str(k), _canon(v)) for k, v in fields.items())),
                     **{k: _canon(obj[k]) for k in SPAN_KEYS if k in obj})


def _canon(v):
    """Canonical hashable form of a JSON field value (lists -> tuples,
    recursively), so parsed events compare equal to emitted ones."""
    if isinstance(v, list):
        return tuple(_canon(x) for x in v)
    return v


class _NullSpan:
    """The shared disabled-path span: entering/exiting does nothing.
    A single module-level instance is reused for every disabled
    ``span()`` call — no per-event allocation on the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one ``span`` event at exit: its host
    times, its place in the span tree and, on a CUDA device, its device
    times (see the module doc)."""

    __slots__ = ("_rec", "_name", "_fields", "_t0", "_id", "_parent",
                 "_unit", "_device", "_start", "_range")

    def __init__(self, rec: "Recorder", name: str, fields: dict,
                 unit=None, device=None):
        self._rec = rec
        self._name = name
        self._fields = fields
        self._t0 = 0.0
        self._id = self._parent = self._start = self._range = None
        self._unit = unit
        self._device = _cuda_device(device)

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        parent = stack[-1] if stack else (rec._open[-1] if rec._open
                                          else None)
        self._id = next(rec._ids)
        if parent is not None:
            self._parent = parent._id
            if self._unit is None:
                self._unit = parent._unit
        stack.append(self)
        rec._open.append(self)
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        self._t0 = rec.now()
        if self._device is not None:
            self._start = rec._mark(self._device)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        end = rec._mark(self._device) if self._device is not None else None
        t1 = rec.now()
        self._range.__exit__(*exc)
        rec._stack().remove(self)
        rec._open.remove(self)
        ev = Event(
            ts=self._t0, kind="span", name=self._name, dur=t1 - self._t0,
            fields=tuple(sorted(
                (str(k), _canon_out(v)) for k, v in self._fields.items())),
            span_id=self._id, parent=self._parent,
            unit=_canon_out(self._unit))
        rec._append(ev if end is None else _OnDevice(
            ev, rec._epochs[self._device], self._start, end))
        return False


def _cuda_device(device) -> Optional[torch.device]:
    """``device`` as a CUDA device with its index; None for any other."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _OnDevice:
    """A closed span whose device times are read after the work: its
    event without them, and its CUDA events until :meth:`resolve` (which
    waits for the end event) puts them in."""

    __slots__ = ("event", "_marks")

    def __init__(self, event: Event, epoch, start, end):
        self.event = event
        self._marks = (epoch, start, end)

    def resolve(self) -> Event:
        if self._marks is not None:
            epoch, start, end = self._marks
            end.synchronize()
            t0 = epoch.elapsed_time(start) / 1e3
            self.event = dataclasses.replace(
                self.event, dev_start=t0,
                dev_end=t0 + start.elapsed_time(end) / 1e3)
            self._marks = None
        return self.event


def _canon_out(v):
    """Canonicalize an outgoing field value so the in-memory event
    equals its JSONL round trip: tuples/lists -> tuples, numpy scalars
    -> python scalars (json would coerce them anyway)."""
    if isinstance(v, (list, tuple)):
        return tuple(_canon_out(x) for x in v)
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        try:
            return v.item()
        except Exception:
            pass
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return v
    return str(v)


class Recorder:
    """Bounded in-memory event ring with a span API and JSONL export.

    ``capacity`` bounds memory: the ring keeps the most recent events
    and counts evictions in ``dropped`` (a trace that wrapped says so
    instead of silently looking complete).  Appends are GIL-atomic
    deque operations — safe under free-threaded instrumentation without
    a lock on the hot path.
    """

    def __init__(self, capacity: int = 65536,
                 clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._clock = clock
        self._epoch = clock()
        self._ring: deque = deque(maxlen=int(capacity))
        self.dropped = 0
        self._ids = itertools.count()
        self._tls = threading.local()     # each thread's open spans
        self._open: list = []             # every thread's, in open order
        self._epochs: dict = {}           # device -> its first CUDA event

    # -- clock --------------------------------------------------------------
    def now(self) -> float:
        """Seconds since this recorder was created (monotonic)."""
        return self._clock() - self._epoch

    def _mark(self, device: torch.device):
        """A timing CUDA event recorded on ``device``'s current stream;
        the first on a device is the epoch of its ``dev_start``s."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        self._epochs.setdefault(device, ev)
        return ev

    # -- write side ---------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _append(self, ev) -> None:
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append(ev)

    def event(self, kind: str, name: str = "", dur: Optional[float] = None,
              **fields) -> None:
        """Record one typed event at the current clock reading."""
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {kind!r}; known: "
                f"{sorted(EVENT_KINDS)}")
        self._append(Event(
            ts=self.now(), kind=kind, name=name, dur=dur,
            fields=tuple(sorted(
                (str(k), _canon_out(v)) for k, v in fields.items()))))

    def span(self, name: str, *, unit=None, device=None,
             **fields) -> _Span:
        """``with rec.span("replan", k=8): ...`` records one ``span``
        event at exit carrying the start timestamp and duration.
        ``unit``: the id of the step or request a root span opens (its
        children inherit it); ``device``: a CUDA device to time the span
        on as well (a CPU device or None: the host clock alone)."""
        return _Span(self, name, fields, unit, device)

    # -- read side ----------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Event]:
        """The ring's events in recording order; a span timed on the
        device waits for its end event here."""
        evs = [e.resolve() if type(e) is _OnDevice else e
               for e in list(self._ring)]
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def totals(self, name: str) -> Tuple[int, int, int]:
        """(count, host ns, device ns) of the ring's spans named
        ``name``; the device's part waits for their end events."""
        spans = [e for e in self.events("span") if e.name == name]
        return (len(spans), round(sum(e.dur for e in spans) * 1e9),
                round(sum(e.dev_dur for e in spans
                          if e.dev_start is not None) * 1e9))

    def __len__(self) -> int:
        return len(self._ring)

    # -- export -------------------------------------------------------------
    def export_jsonl(self, path_or_file: Union[str, io.IOBase]) -> int:
        """Write the ring as JSONL (one event per line, recording
        order).  Returns the number of events written."""
        evs = self.events()
        if isinstance(path_or_file, str):
            with open(path_or_file, "w") as f:
                for e in evs:
                    f.write(e.to_json() + "\n")
        else:
            for e in evs:
                path_or_file.write(e.to_json() + "\n")
        return len(evs)


def parse_jsonl(path_or_file: Union[str, io.IOBase, Iterable[str]]
                ) -> List[Event]:
    """Parse a JSONL trace back into typed events (the exact inverse of
    ``Recorder.export_jsonl`` — round-trip equality is pinned)."""
    if isinstance(path_or_file, str):
        with open(path_or_file) as f:
            return [Event.from_json(ln) for ln in f if ln.strip()]
    return [Event.from_json(ln) for ln in path_or_file if ln.strip()]


# --------------------------------------------------------------------------
# The process-global recorder
# --------------------------------------------------------------------------

_ACTIVE: Optional[Recorder] = None


def active() -> Optional[Recorder]:
    """The installed recorder, or None (tracing disabled).  THE hot-path
    guard: instrumented code calls this before building any event
    payload, so a disabled recorder costs one global read + one `is not
    None` per site."""
    return _ACTIVE


def install(recorder: Optional[Recorder] = None) -> Recorder:
    """Install (and return) the process-global recorder."""
    global _ACTIVE
    _ACTIVE = recorder if recorder is not None else Recorder()
    return _ACTIVE


def uninstall() -> Optional[Recorder]:
    """Disable tracing; returns the recorder that was installed."""
    global _ACTIVE
    rec, _ACTIVE = _ACTIVE, None
    return rec


class recording:
    """``with recording() as rec: ...`` — install a recorder for the
    block, restore the previous one after (re-entrant)."""

    def __init__(self, recorder: Optional[Recorder] = None,
                 capacity: int = 65536):
        self._rec = recorder if recorder is not None \
            else Recorder(capacity=capacity)
        self._prev: Optional[Recorder] = None

    def __enter__(self) -> Recorder:
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self._rec
        return self._rec

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def span(name: str, **fields):
    """Module-level span through the global recorder (``unit=`` and
    ``device=`` as ``Recorder.span``'s); the shared no-op singleton when
    tracing is disabled."""
    rec = _ACTIVE
    return rec.span(name, **fields) if rec is not None else NULL_SPAN


def event(kind: str, name: str = "", dur: Optional[float] = None,
          **fields) -> None:
    """Module-level event through the global recorder; a no-op when
    disabled.  Hot paths should prefer guarding with ``active()`` so
    the kwargs dict is never even built."""
    rec = _ACTIVE
    if rec is not None:
        rec.event(kind, name=name, dur=dur, **fields)


class SpanPaths:
    """The installed recorder's span totals by path, for a reader that
    resolves ``module:attribute.path`` and takes ``int()`` of it:
    ``SPANS.attn.decode_row.device_ns`` is ``Recorder.totals``' device
    part for the spans named ``attn.decode_row`` (``count``, ``host_ns``
    and ``device_ns`` end a path); 0 with no recorder installed."""

    LEAVES = ("count", "host_ns", "device_ns")

    def __init__(self, prefix: str = ""):
        self._prefix = prefix

    def __getattr__(self, part: str):
        if part.startswith("_"):
            raise AttributeError(part)
        if part in self.LEAVES and self._prefix:
            rec = _ACTIVE
            return 0 if rec is None \
                else rec.totals(self._prefix)[self.LEAVES.index(part)]
        return SpanPaths(f"{self._prefix}.{part}" if self._prefix
                         else part)


#: Every span name's totals by path (``SpanPaths``).
SPANS = SpanPaths()
