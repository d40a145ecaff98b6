"""The program's span totals, for the per-layer metrics that read them.

The program times its hot path in spans (``repro_torch.obs.recorder``)
only while a flight recorder is installed, and reads the recorder's
totals of a span name by path (``repro_torch.obs.recorder.SPANS``:
count, host and device nanoseconds).  A metric that reads them names its totals with
:func:`counters` when its module is loaded, which the harness does only
in a traced run, before the counters' first reading: that installs a
recorder, once a process, shared by every such metric, so the traced
stretch runs traced and the measured windows do not.  A program without
span totals is left as it is: its metrics name no counter and read
nothing.
"""
from __future__ import annotations

from typing import Dict, Optional

TOTALS = "repro_torch.obs.recorder:SPANS"


def tracing_on() -> bool:
    """Install the program's flight recorder unless one is installed;
    False where the program keeps no span totals."""
    try:
        from repro_torch.obs import recorder
    except ImportError:
        return False
    if not hasattr(recorder, "SPANS"):
        return False
    if recorder.active() is None:
        recorder.install()
    return True


def counters(**totals: str) -> Dict[str, str]:
    """``COUNTERS`` of a metric: {key: the path of a span total}, each
    total given as ``<span name>.<count|host_ns|device_ns>``; none where
    the program keeps no span totals."""
    if not tracing_on():
        return {}
    return {k: f"{TOTALS}.{t}" for k, t in totals.items()}


def ms_per_unit(ctx, names) -> Optional[float]:
    """The sum of the totals ``names`` (keys of ``ctx.counters``) over the
    traced stretch, in ms a unit; None where a total was not read or
    stayed at zero."""
    if not names or any(k not in ctx.counters for k in names):
        return None
    ns = sum(ctx.counters[k] for k in names)
    return ns / 1e6 / ctx.units if ns > 0 else None
