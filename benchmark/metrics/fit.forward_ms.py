"""Milliseconds of a fit's block spent in the forward to the tap: the
``model.forward`` spans' total over the ``stream.block`` count, the median
over the run's untraced fits of the window's size."""

from benchmark.metrics._spans import per_block_ms

RANGES = {}


def read(run):
    return per_block_ms("model.forward")
