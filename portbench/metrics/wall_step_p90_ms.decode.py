"""A decode cell's 90th percentile of the gaps between consecutive steps'
completions (CUDA events after each step: the device's clock, the waits
for the host included) over the mix's ``paced_units`` steps, run untraced
as the window runs them just before the traced stretch."""


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "decode" or ctx.paced is None:
        return None
    return ctx.paced.gap_quantile_ms(90)
