"""A fixture metric: the steps of the traced stretch, as the program's
counter of flash launches a step sees them (a counter it names, so it
reads on the CPU too, where the counter stays at 0)."""
COUNTERS = {"flash": "repro_torch.kernels.flash_attention:"
                     "flash_attention.launches"}


def read(ctx):
    if ctx.kind != "train":
        return None
    return float(ctx.counters["flash"] + ctx.units)
