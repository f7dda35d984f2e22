"""Seconds of set-up spent building the program's model: the summed wall
of the process's ``model.build`` requests (construction, the weights'
load, the shape probe)."""

from benchmark.metrics._spans import untraced

RANGES = {}


def read(run):
    builds = untraced("model.build")
    if not builds:
        return None
    return sum(u["end_ns"] - u["start_ns"] for u in builds) / 1e9
