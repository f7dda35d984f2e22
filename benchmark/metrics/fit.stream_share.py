"""The share of a fit's wall time in its first streaming pass: the
``pass1`` phase ``decomposition._compute`` stamps (the device drained), summed
over the untraced fits of the run, over their wall times."""

RANGES = {}


def read(run):
    fits = [p for p in run.phases if "pass1" in p]
    if run.loop != "fit" or not fits:
        return None
    return 100.0 * sum(p["pass1"] for p in fits) / sum(p["wall"] for p in fits)
