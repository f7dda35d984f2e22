"""StyleGAN3's filtered leaky ReLUs in a rendered strip: their least time
(3xTF32 operations of the polyphase FIR taps, or HBM bytes of x read and
the output written once) over the device time of what
``ops.filtered_lrelu.filtered_lrelu`` launched, in the traced strips."""

from benchmark.metrics._flrelu import FLRELU, cost
from benchmark.metrics._roofline import share

RANGES = FLRELU


def read(run):
    return share(run, "flrelu", cost) if run.loop == "strip" else None
