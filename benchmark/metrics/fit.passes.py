"""Passes over the data a fit makes (the program's ``stream.passes``
counter: the first pass, and the sketch's refine pass when it runs), the
median over the run's untraced fits of the window's size."""

import statistics

from benchmark.metrics._spans import window_fits

RANGES = {}


def read(run):
    fits = window_fits()
    if not fits:
        return None
    return statistics.median(u["counters"].get("stream.passes", 0) for u in fits)
