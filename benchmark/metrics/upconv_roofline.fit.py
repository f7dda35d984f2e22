"""The stride-2 transposed convs (B-up) in a fit's tap forward: their
least time (3xTF32 operations of the taps that meet an input pixel, or HBM
bytes) over the device time of what ``ops.modconv.upsample_conv``
launched, in the traced fit."""

from benchmark.metrics._roofline import UPCONV, share, upconv_cost

RANGES = UPCONV


def read(run):
    return share(run, "upconv", upconv_cost) if run.loop == "fit" else None
