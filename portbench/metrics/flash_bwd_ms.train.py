"""The flash backward's device time a step of a train cell: the spans
``attn.flash_bwd`` (``FlashTrain.backward``, one a layer, on autograd's
thread) between their CUDA events, in ms a step of the traced
stretch."""
from portbench import spans

COUNTERS = spans.counters(flash_bwd="attn.flash_bwd.device_ns")


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "train":
        return None
    return spans.ms_per_unit(ctx, list(COUNTERS))
