"""The coded training step's share of the card's bf16 peak: the model
operations of every coded row's forward and backward (``counts``) over
the traced steps' span."""
from portbench import counts, timing


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "train":
        return None
    flops = counts.model_flops(ctx.spec, ctx.info["rows"], ctx.info["seq"],
                               train=True)
    return 100.0 * flops * ctx.units / (ctx.trace.span_s * timing.PEAK_BF16)
