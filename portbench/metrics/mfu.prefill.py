"""The prefill requests' share of the card's bf16 peak: the model
operations of a request's forward (``counts``) over the traced requests'
span."""
from portbench import counts, timing


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "prefill":
        return None
    flops = counts.model_flops(ctx.spec, ctx.info["rows"], ctx.info["seq"],
                               train=False)
    return 100.0 * flops * ctx.units / (ctx.trace.span_s * timing.PEAK_BF16)
