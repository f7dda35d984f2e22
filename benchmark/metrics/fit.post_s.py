"""Seconds per fit after the stream: the ``refine``, ``fit``, ``finish``,
``regression``, ``baselines`` and ``npz`` phases of ``decomposition._compute``,
the mean over the untraced fits of the run."""

RANGES = {}
POST = ("refine", "fit", "finish", "regression", "baselines", "npz")


def read(run):
    fits = [p for p in run.phases if "pass1" in p]
    if run.loop != "fit" or not fits:
        return None
    return sum(sum(p.get(k, 0.0) for k in POST) for p in fits) / len(fits)
