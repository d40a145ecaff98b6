"""Decode attention's device time a step of a decode cell: the spans
``attn.decode_row`` (``models.layers.attention``'s one-row branch, one a
layer: the KV heads repeated, the fp32 scores, mask, softmax and p . v)
between their CUDA events, in ms a step of the traced stretch."""
from portbench import spans

COUNTERS = spans.counters(decode_row="attn.decode_row.device_ns")


def read(ctx):
    if not ctx.trace.on_device or ctx.kind != "decode":
        return None
    return spans.ms_per_unit(ctx, list(COUNTERS))
