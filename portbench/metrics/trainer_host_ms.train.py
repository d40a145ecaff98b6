"""The coded step's host work a step of a train cell: the host time of
the spans ``coded.batch``, ``coded.mask`` and ``coded.coefficients`` in
``CodedTrainer.run_step`` (the coded batch, the straggler mask and the
decode coefficients), in ms a step of the traced stretch.  The copies to
the card (``coded.to_device``) are left out: a copy from pageable memory
synchronises the stream, so its host time holds whatever device work is
queued before it."""
from portbench import spans

COUNTERS = spans.counters(batch="coded.batch.host_ns",
                          mask="coded.mask.host_ns",
                          coefficients="coded.coefficients.host_ns")


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.ms_per_unit(ctx, list(COUNTERS))
