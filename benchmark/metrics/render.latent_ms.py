"""Milliseconds a strip's latent takes before the strip: the wall of the
``model.sample_latent`` requests (the host draw, its copy to the device,
the mapping), the median over the run's untraced ones."""

import statistics

from benchmark.metrics._spans import MS, untraced

RANGES = {}


def read(run):
    draws = untraced("model.sample_latent")
    if not draws:
        return None
    return statistics.median((u["end_ns"] - u["start_ns"]) / MS for u in draws)
