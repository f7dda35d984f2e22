"""Milliseconds a block of a fit's stream takes on the host: the
``stream.block`` spans' total over their count (both passes), the median
over the run's untraced fits of the window's size."""

from benchmark.metrics._spans import per_block_ms

RANGES = {}


def read(run):
    return per_block_ms("stream.block")
