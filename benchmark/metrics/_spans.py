"""Shared by the readers of the program's own spans and counters
(``ganspace_tpu_torch.utils.tracing``): the request records this process
kept, less those a profiler recorded (the ``--trace 1`` run's traced
stretch), summarised by their median."""

from __future__ import annotations

import statistics
from typing import Optional

MS = 1e6            # nanoseconds a millisecond


def untraced(name: str) -> list:
    """The untraced request records named ``name``; none where the program
    keeps no such records."""
    try:
        from ganspace_tpu_torch.utils.tracing import units
    except ImportError:
        return []
    return [u for u in units(name) if not u["traced"]]


def window_fits() -> list:
    """The untraced fits of the window's size: those whose stream ran the
    most blocks.  The set-up's warm-up fit streams a few blocks, its first
    ones slow (the first calls), and a ``--trace 1`` run may hold a single
    untraced fit of the window beside it."""
    fits = [u for u in untraced("fit") if "stream.block" in u["spans"]]
    most = max((u["spans"]["stream.block"][0] for u in fits), default=0)
    return [u for u in fits if u["spans"]["stream.block"][0] == most]


def per_block_ms(span: str) -> Optional[float]:
    """The median over the window's fits of ``span``'s total over the
    blocks of their stream, in milliseconds; None when no untraced fit
    streamed."""
    fits = [u["spans"] for u in window_fits()]
    if not fits:
        return None
    return statistics.median(s.get(span, (0, 0))[1] / s["stream.block"][0] / MS for s in fits)


def per_strip_ms(span: str) -> Optional[float]:
    """The median over the strips of ``span``'s total in each, in
    milliseconds; None when no untraced strip ran."""
    strips = [u["spans"] for u in untraced("edit.strip")]
    if not strips:
        return None
    return statistics.median(s.get(span, (0, 0))[1] / MS for s in strips)
