"""AdamW's device time a step of a train cell: the span ``optim.adamw``
(``optim.adamw.apply_updates``: the global norm, the clip and the sliced
update) between its CUDA events, in ms a step of the traced stretch."""
from portbench import spans

COUNTERS = spans.counters(adamw="optim.adamw.device_ns")


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "train":
        return None
    return spans.ms_per_unit(ctx, list(COUNTERS))
