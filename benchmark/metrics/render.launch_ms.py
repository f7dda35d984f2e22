"""Milliseconds of a strip the host spends launching the synthesis: the
``model.forward`` total of each ``edit.strip`` request, the median over the
run's untraced strips."""

from benchmark.metrics._spans import per_strip_ms

RANGES = {}


def read(run):
    return per_strip_ms("model.forward")
