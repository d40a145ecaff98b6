"""The device's idle share of the traced stretch of a decode cell: 1 - busy /
span, busy the device time of every operation the profiler saw, span the
stretch's CUDA events."""


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "decode":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.span_s)
