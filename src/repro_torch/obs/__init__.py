"""Observability: the flight recorder and the metrics plane.

  * :mod:`repro_torch.obs.recorder` — a process-global structured
    event/span tracer with a bounded ring, a monotonic clock and a JSONL
    exporter; a near-zero-overhead no-op when disabled.  The cluster
    engines report each surface call to it as a ``sweep`` event.
  * :mod:`repro_torch.obs.metrics` — named counters / gauges / streaming
    histograms (Welford + reservoir, the host twin of
    ``runtime.streamstats``) in a process-global registry; the surface
    cache keeps its hit/miss counters there.

The run report and the SLO monitor come with the control loop.
"""
from .metrics import (Counter, Gauge, MetricsRegistry,  # noqa: F401
                      REGISTRY, StreamHist)
from .recorder import (EVENT_KINDS, Event, NULL_SPAN,  # noqa: F401
                       Recorder, active, event, install, parse_jsonl,
                       recording, span, uninstall)

__all__ = [
    "Counter", "EVENT_KINDS", "Event", "Gauge", "MetricsRegistry",
    "NULL_SPAN", "REGISTRY", "Recorder", "StreamHist", "active", "event",
    "install", "parse_jsonl", "recording", "span", "uninstall",
]
