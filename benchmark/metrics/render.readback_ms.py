"""Milliseconds of a strip spent reading its frames back: the
``imaging.readback`` total of each ``edit.strip`` request (the uint8
quantisation, then the blocking pageable copy, which waits for the device
to finish the strip), the median over the run's untraced strips."""

from benchmark.metrics._spans import per_strip_ms

RANGES = {}


def read(run):
    return per_strip_ms("imaging.readback")
