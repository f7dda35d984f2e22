"""The Nystrom sketch's block updates (``estimators/ipca.nystrom_update``):
the least time of their two products (3xTF32 operations, or x, Omega and
Y read and Y written) over the device time of what they launched, in the
traced fit."""

from benchmark.metrics._roofline import SKETCH, share, sketch_cost

RANGES = SKETCH


def read(run):
    return share(run, "sketch", sketch_cost) if run.loop == "fit" else None
