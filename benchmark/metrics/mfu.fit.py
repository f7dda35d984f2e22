"""The whole fit's share of the card's peak: its model FLOPs, counted once
per sample fitted (the forward to the tap, the sketch's two products, the
regression's cross-moments; no refine pass), over (traced window x chips
x 165 TFLOP/s)."""

from benchmark import work

RANGES = {}


def read(run):
    tr = run.trace
    if (run.loop != "fit" or tr is None or tr.span_s <= 0 or not tr.n_device_ops
            or not run.unit_flops):
        return None
    return 100.0 * run.unit_flops / (tr.span_s * run.chips * work.PEAK_3XTF32)
