"""The render's share of the card's peak: its model FLOPs, the full
synthesis once per frame delivered, over (traced window x chips x 165
TFLOP/s)."""

from benchmark import work

RANGES = {}


def read(run):
    tr = run.trace
    if (run.loop != "strip" or tr is None or tr.span_s <= 0 or not tr.n_device_ops
            or not run.unit_flops):
        return None
    return 100.0 * run.unit_flops / (tr.span_s * run.chips * work.PEAK_3XTF32)
