"""Milliseconds of a fit's block spent drawing its latents (the per-block
generator on the device, and the mapping in W): the ``stream.latents``
spans' total over the ``stream.block`` count, the median over the run's
untraced fits of the window's size."""

from benchmark.metrics._spans import per_block_ms

RANGES = {}


def read(run):
    return per_block_ms("stream.latents")
