"""Shared by the roofline readers: a range's least time over its device time."""

from __future__ import annotations

from typing import Callable, Optional

from benchmark import work


def share(run, rng: str, cost: Callable[[tuple, dict], tuple]) -> Optional[float]:
    """100 x (sum over the range's calls of the bound of ``cost(args,
    kwargs) -> (FLOP, bytes)``) / (device seconds launched in the range);
    None when the traced stretch made no such call."""
    tr = run.trace
    if tr is None or not tr.calls.get(rng) or tr.range_s.get(rng, 0.0) <= 0.0:
        return None
    least = sum(work.bound_s(*cost(a, k)) for a, k in tr.calls[rng])
    return 100.0 * least / tr.range_s[rng]


def modconv_cost(a, k):
    """``modconv3x3(x, w_scaled, s, d)``: x [B, C, H, W], w [Co, C, 3, 3]."""
    b, c, h, w = a[0]
    return work.modconv3x3(b, c, a[1][0], h, w)


def upconv_cost(a, k):
    """``upsample_conv(x, w_scaled, s, d, pad=)``."""
    b, c, h, w = a[0]
    co, _, kk, _ = a[1]
    s = a[2] if len(a) > 2 else k.get("s")
    return work.upconv(b, c, co, h, w, kk, k.get("pad", 0), modulated=s is not None)


def sketch_cost(a, k):
    """``nystrom_update(state, x, omega)``: x [n, D], omega [D, l]."""
    n, d = a[1]
    return work.sketch_update(n, d, a[2][1])

MODCONV = {"modconv": ("ganspace_tpu_torch.ops.modconv", "modconv3x3")}
UPCONV = {"upconv": ("ganspace_tpu_torch.ops.modconv", "upsample_conv")}
SKETCH = {"sketch": ("ganspace_tpu_torch.estimators.ipca", "nystrom_update")}
