"""One driver a traffic kind: it reads a mix's parameters, drives the
program's own entry point one unit of work at a time (a step or a
request), keeps what the timed path produced for the check, works the
reference's readings out again from the same seed, and turns a measured
window into its end-to-end metrics.

A driver module has ``KIND`` (what its per-layer metrics test for),
``SYNC_EACH`` (the harness waits for each unit before the next; False:
the host stays one unit ahead), ``end_to_end(window) -> {metric: value}``
(``window.device_s_per_unit``: the device's busy time a unit over
profiled stretches of the mix's ``profiled_units`` units once the window
has closed, where the mix names them)
and ``Session(cell, seed, device)`` with ``build()`` (the program, its
weights and inputs), ``warm()`` (the cell's shapes, once each),
``work_per_unit`` (tokens), ``unit(remaining) -> value or None`` (one
unit; ``remaining``, the window's seconds still to run, or None outside
the window; a value that is not finite counts the unit as failed),
``run_units(n) -> info`` (what the per-layer metrics read of a traced
stretch), ``judged() -> outputs``, ``free()``, ``reference(outputs,
precision)``, ``numbers(outputs, ref) -> {name: value}`` and
``control_numbers(outputs, ref)`` (the same numbers of the reference
one precision lower, put in the program's place).
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional


@dataclasses.dataclass
class Window:
    units: int              # steps or requests completed in the window
    failed: int             # of them, those whose output was not finite
    work: float             # tokens they carried
    seconds: float          # host clock, start to the last completion
    gaps: List[float]       # device clock between consecutive completions
    device_s_per_unit: Optional[float] = None   # harness.device_time

    def rate(self) -> float:
        return self.work / self.seconds

    def gap_quantile_ms(self, q: int) -> float:
        """The q-th percentile of the gaps, in ms."""
        return statistics.quantiles(self.gaps, n=100,
                                    method="inclusive")[q - 1] * 1e3
