"""The filtered leaky ReLU's work (``ops/filtered_lrelu.filtered_lrelu``),
shared by its roofline reader and StyleGAN3's frame count.

Operations: the FIR taps of the up filter's two 1-D passes that meet a
sample that is not zero-stuffed (the polyphase count: about taps / up a
sample), and every tap of the down filter's two passes at the samples it
keeps.  Bytes: x read once, the output written once, the bias and the two
filters.  The bias, the leaky ReLU and the clamp are not counted.
"""

from __future__ import annotations

import functools

from benchmark import work


@functools.lru_cache(maxsize=None)
def _up_hits(n: int, up: int, taps: int, lo: int, hi: int) -> tuple:
    """(input samples inside the padded window, taps meeting one of them
    summed over the up filter's outputs) along one axis of n samples
    zero-stuffed by ``up`` and padded by (``lo``, ``hi``)."""
    size = n * up + lo + hi
    kept = sum(0 <= q * up + lo < size for q in range(n))
    hits = 0
    for j in range(size - taps + 1):
        hits += sum((j + t - lo) % up == 0 and 0 <= j + t - lo < n * up for t in range(taps))
    return kept, hits


def filtered_lrelu(b: int, c: int, h: int, w: int, up_taps: int, down_taps: int, up: int,
                   down: int, pad: tuple) -> tuple:
    """(FLOP, bytes) of one call on x [b, c, h, w] (square maps)."""
    kept, hits = _up_hits(h, up, up_taps, pad[0], pad[1])
    mid = h * up + pad[0] + pad[1] - up_taps + 1
    out = (mid - down_taps) // down + 1
    flop = 2.0 * b * c * (kept * hits + mid * hits)
    flop += 2.0 * b * c * down_taps * (mid * out + out * out)
    nbytes = work.F32 * (b * c * (h * w + out * out) + c + up_taps + down_taps)
    return flop, nbytes


def cost(a, k):
    """``filtered_lrelu(x, fu, fd, b, up, down, padding, ...)`` as the
    range records it: shapes of the tensors (None for a 1-tap filter)."""
    b, c, h, w = a[0]
    up_taps = 1 if a[1] is None else a[1][0]
    down_taps = 1 if a[2] is None else a[2][0]
    return filtered_lrelu(b, c, h, w, up_taps, down_taps, a[4], a[5], tuple(a[6]))


FLRELU = {"flrelu": ("ganspace_tpu_torch.ops.filtered_lrelu", "filtered_lrelu")}
