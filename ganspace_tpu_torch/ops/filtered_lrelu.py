"""StyleGAN3's filtered leaky ReLU: bias, upsample through a low-pass
filter, leaky ReLU with gain and clamp, low-pass and downsample.

The alias-free generator (Karras et al. 2021, ``torch_utils/ops/
filtered_lrelu.py`` of github.com/NVlabs/stylegan3) applies, per layer,

    x <- x + b
    x <- upfirdn(x, fu, up, padding, gain up^2)
    x <- clamp(leaky_relu(x, slope) * gain, -clamp, clamp)
    x <- upfirdn(x, fd, down)

with 1-D Kaiser filters ``fu`` and ``fd`` applied separably (None, a
1-tap filter, is the identity).  :func:`filtered_lrelu` is the entry the
generator calls, in a ``flrelu`` span and IEEE float32 (cuDNN's TF32
off); on both devices its body is :func:`filtered_lrelu_plain`, the
composition of stock ops (``ops/upfirdn.upfirdn2d``'s separable path),
which materialises the upsampled map.  A fused CUDA kernel would replace
the entry's body and keep :func:`filtered_lrelu_plain` as its oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ganspace_tpu_torch.ops.precision import ieee_f32
from ganspace_tpu_torch.ops.upfirdn import upfirdn2d
from ganspace_tpu_torch.utils.tracing import annotate


def filtered_lrelu_plain(x: torch.Tensor, fu: torch.Tensor | None, fd: torch.Tensor | None,
                         b: torch.Tensor | None, up: int, down: int,
                         padding: tuple[int, int], gain: float, slope: float,
                         clamp: float | None) -> torch.Tensor:
    """Plain PyTorch version of :func:`filtered_lrelu` (its arguments)."""
    if b is not None:
        x = x + b.to(x.dtype)[None, :, None, None]
    x = _fir(x, fu, up, 1, padding)
    x = F.leaky_relu(x, slope) if slope != 1 else x
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return _fir(x, fd, 1, down, (0, 0))


def _fir(x, f, up, down, pad):
    """upfirdn with gain up^2; None, the 1-tap filter, at factors 1 only pads."""
    if f is None and up == down == 1:
        return F.pad(x, [pad[0], pad[1], pad[0], pad[1]]) if any(pad) else x
    f = x.new_ones(1) if f is None else f
    return upfirdn2d(x, f, up=up, down=down, pad=pad, gain=float(up * up))


def filtered_lrelu(x: torch.Tensor, fu: torch.Tensor | None, fd: torch.Tensor | None,
                   b: torch.Tensor | None, up: int, down: int, padding: tuple[int, int],
                   gain: float, slope: float, clamp: float | None) -> torch.Tensor:
    """Bias, upsample, leaky ReLU, clamp, downsample on an NCHW batch.

    x [B, C, H, W]; ``fu``, ``fd``: 1-D taps (a symmetric low-pass
    filter, summing to 1) or None; b [C] or None; ``up``, ``down``: the
    integer factors; ``padding`` (before, after), on both axes, of the
    zero-stuffed map (negative values crop); ``gain`` and ``slope`` of the
    leaky ReLU, then the clamp to +-``clamp``.  The output is
    [B, C, (H up + before + after - len(fu) - len(fd) + 2 + down - 1) // down, ...]."""
    with annotate("flrelu"), ieee_f32():
        return filtered_lrelu_plain(x, fu, fd, b, up, down, padding, gain, slope, clamp)
