"""Clocks, the profiler's trace and the published peaks.

The timing arithmetic is a frozen copy of the port's own measurement
script: CUDA events around the work, ``torch.profiler`` over a steady
stretch with device time by kernel name and the span taken by CUDA
events.  Peaks: NVIDIA's H100 SXM data sheet at 700 W, dense rates.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

PEAK_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FP32 = 67e12           # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12            # bytes/s


def least_s(ops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time the chip could take: operations over the peak or
    bytes over HBM's rate, whichever is larger."""
    return max(ops / peak, nbytes / HBM_BW)


class Marks:
    """Completion times of units of work: CUDA events on the card (read
    after the window), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events: List = []
        self.host: List[float] = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)
        else:
            self.host.append(time.perf_counter())

    def wait_previous(self) -> None:
        """Block until the unit before the newest is done, so the host
        stays at most one unit ahead of the device."""
        if self.cuda and len(self.events) >= 2:
            self.events[-2].synchronize()

    def seconds(self) -> List[float]:
        """Each mark's time after the first, in seconds."""
        if self.cuda:
            torch.cuda.synchronize()
            first = self.events[0]
            return [first.elapsed_time(e) / 1e3 for e in self.events]
        return [t - self.host[0] for t in self.host]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class Trace:
    """One profiled stretch: span (CUDA events), busy device time, device
    time by kernel name, and the idle gaps by what the host was doing."""

    def __init__(self, span_s: float, kernels: List[tuple],
                 gaps: List[tuple], on_device: bool = True):
        self.span_s = span_s
        self.on_device = on_device        # False: a host run, no device
        self.kernels = kernels            # (name, seconds, count)
        self.busy_s = sum(k[1] for k in kernels)
        self.gaps = gaps                  # (host operation, seconds)

    def time_of(self, part: str) -> tuple:
        """(device seconds, launches) of the kernels whose name holds
        ``part``."""
        hits = [k for k in self.kernels if part in k[0]]
        return sum(k[1] for k in hits), sum(k[2] for k in hits)


def profile(fn: Callable[[], None], device: torch.device) -> Optional[Trace]:
    """``fn`` once under ``torch.profiler`` with device activity only (the
    kernels, copies and the CUDA runtime calls that CUPTI records): the
    host's operator events would slow a step of many small launches by
    half and make its idle share the profiler's.  None where the profiler
    saw no device time.  On the CPU (the tests) only the host clock's
    span, with no device operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return Trace(time.perf_counter() - t0, [], [], on_device=False)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    span_s = start.elapsed_time(end) / 1e3
    kernels = [(e.key, e.self_device_time_total / 1e6, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    kernels.sort(key=lambda k: -k[1])
    return Trace(span_s, kernels, idle_gaps(prof.events(), DeviceType))


def busy(fn: Callable[[], None], device: torch.device) -> Tuple[float, int]:
    """(seconds, operations): the time of every device operation of ``fn``
    once, and their count, summed from the raw events of ``torch.profiler``
    with device activity alone, as ``profile`` traces it but with no table
    by name.  On the CPU (the tests), where the CPU is the device, the host
    clock's span and no operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0, 0
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return sum(e.end_ns() - e.start_ns() for e in ops) / 1e9, len(ops)


def idle_gaps(events, DeviceType, top: int = 10) -> List[tuple]:
    """The ``top`` longest stretches with no device operation running,
    each named by the innermost host event open at its start (a CUDA
    runtime call, such as a copy from pageable memory or a
    synchronisation)."""
    dev, host = [], []
    for e in events:
        tr = getattr(e, "time_range", None)
        if tr is None:
            continue
        (dev if e.device_type == DeviceType.CUDA else host).append(
            (tr.start, tr.end, e.name))
    if len(dev) < 2:
        return []
    dev.sort()
    gaps, reach = [], dev[0][1]
    for start, end, _ in dev[1:]:
        if start > reach:
            gaps.append((start - reach, reach))
        reach = max(reach, end)
    gaps.sort(reverse=True)
    out = []
    for length, at in gaps[:top]:
        open_ops = [h for h in host if h[0] <= at <= h[1]]
        name = max(open_ops)[2] if open_ops else "no host operation"
        out.append((name, length / 1e6))
    return out
