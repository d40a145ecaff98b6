"""The flash forward kernel's share of its roofline in a prefill cell: the
least time of its launches (the larger of operations over the bf16 peak
and bytes moved once over HBM's rate, ``counts.flash_cost``) over the
device time of the kernels named ``flash_fwd*`` in the trace."""
from portbench import counts, timing


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "prefill":
        return None
    seconds, launches = ctx.trace.time_of("flash_fwd")
    if not launches:
        return None
    s = ctx.spec
    rows, seq = ctx.info["rows"], ctx.info["seq"]
    least = timing.least_s(*counts.flash_cost(
        rows, seq, seq, s.heads, s.kv_heads, s.head_dim, True, s.window,
        with_lse=False))
    return 100.0 * launches * least / seconds
