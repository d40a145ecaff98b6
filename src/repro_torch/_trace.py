"""Where a step's work outside aten is reported: the kernels' launches
(``kernels.*.ops``) and the collectives (``parallel``).

``launch.hlo_analysis.OpRecorder`` adds itself to ``sinks`` while it
records and sees every aten operation through PyTorch's dispatcher; the
hand-written kernels and the process groups' collectives run below the
dispatcher (a ctypes call, ``torch.distributed``'s own operations), so
their wrappers tell it here what they did.  With no sink, ``emit`` costs
one list test.
"""
from __future__ import annotations

from typing import Callable, List

#: callables that take one event (a dict)
sinks: List[Callable[[dict], None]] = []


def emit(event: dict) -> None:
    for sink in sinks:
        sink(event)
