"""Milliseconds of a fit's block spent in the estimator's update (the
sketch or the moments, with the random projections' and the regression's
moments): the ``estimator.update`` spans' total over the ``stream.block``
count, the median over the run's untraced fits of the window's size."""

from benchmark.metrics._spans import per_block_ms

RANGES = {}


def read(run):
    return per_block_ms("estimator.update")
