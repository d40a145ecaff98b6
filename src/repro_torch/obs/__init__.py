"""Observability: the flight recorder, the metrics plane and the SLO
monitor.

  * :mod:`repro_torch.obs.recorder` — a process-global structured
    event/span tracer with a bounded ring, a monotonic clock and a JSONL
    exporter; a near-zero-overhead no-op when disabled.  The cluster
    engines report each surface call to it as a ``sweep`` event that
    names its device.
  * :mod:`repro_torch.obs.metrics` — named counters / gauges / streaming
    histograms (Welford + reservoir, the host twin of
    ``runtime.streamstats``) in a process-global registry; the surface
    cache keeps its hit/miss counters there.
  * :mod:`repro_torch.obs.slo` — streaming tail-quantile-vs-target
    monitoring with multi-window burn-rate alarms, pluggable into the
    controller as a drift-alarm source.

``python -m repro_torch.obs.report trace.jsonl`` renders a run timeline
from an exported trace (:mod:`repro_torch.obs.report`).
"""
from .metrics import (Counter, Gauge, MetricsRegistry,  # noqa: F401
                      REGISTRY, StreamHist)
from .recorder import (EVENT_KINDS, Event, NULL_SPAN,  # noqa: F401
                       Recorder, active, event, install, parse_jsonl,
                       recording, span, uninstall)
from .slo import SLOAlarm, SLOMonitor  # noqa: F401

__all__ = [
    "Counter", "EVENT_KINDS", "Event", "Gauge", "MetricsRegistry",
    "NULL_SPAN", "REGISTRY", "Recorder", "SLOAlarm", "SLOMonitor",
    "StreamHist", "active", "event", "install", "parse_jsonl",
    "recording", "span", "uninstall",
]
