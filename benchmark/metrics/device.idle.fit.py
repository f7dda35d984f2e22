"""The device's idle share over a traced fit: 1 minus the union of its
operations' intervals over the traced window."""

RANGES = {}


def read(run):
    tr = run.trace
    if run.loop != "fit" or tr is None or tr.span_s <= 0 or not tr.n_device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.span_s)
