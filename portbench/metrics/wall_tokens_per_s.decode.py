"""A decode cell's tokens a second on the wall clock: the rows of each of
the mix's ``paced_units`` steps, run untraced as the window runs them just
before the traced stretch, over the host clock's time from the first to
the last completion.  While the host's issue of a step takes longer than
the device's work, the host sets this rate, and its jitter with it."""


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "decode" or ctx.paced is None:
        return None
    return ctx.paced.rate()
