"""The decode steps' share of the card's HBM rate: the bytes each traced
step must read once (the K and V cache up to its position, the
parameters as held; ``counts.decode_bytes``) over the traced span."""
from portbench import counts, timing


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "decode" \
            or counts.decode_bytes(ctx.spec, 1, 0) is None:
        return None
    nbytes = sum(counts.decode_bytes(ctx.spec, ctx.info["rows"], p)
                 for p in ctx.info["positions"])
    return 100.0 * nbytes / (ctx.trace.span_s * timing.HBM_BW)
