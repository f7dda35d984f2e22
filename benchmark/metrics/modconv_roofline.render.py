"""Kernel B's modulated 3x3 convs in a rendered strip: their least time
(3xTF32 operations or HBM bytes of their shapes) over the device time of
what ``ops.modconv.modconv3x3`` launched, in the traced strips."""

from benchmark.metrics._roofline import MODCONV, modconv_cost, share

RANGES = MODCONV


def read(run):
    return share(run, "modconv", modconv_cost) if run.loop == "strip" else None
