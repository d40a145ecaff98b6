"""Observability: the flight recorder.

:mod:`repro_torch.obs.recorder` is a process-global structured event/span
tracer with a bounded ring, a monotonic clock and a JSONL exporter; a
near-zero-overhead no-op when disabled.  The cluster engine reports each
surface call to it as a ``sweep`` event.  The metrics registry, the run
report and the SLO monitor come with the control loop.
"""
from .recorder import (EVENT_KINDS, Event, NULL_SPAN,  # noqa: F401
                       Recorder, active, event, install, parse_jsonl,
                       recording, span, uninstall)

__all__ = [
    "EVENT_KINDS", "Event", "NULL_SPAN", "Recorder", "active", "event",
    "install", "parse_jsonl", "recording", "span", "uninstall",
]
