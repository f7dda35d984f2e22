"""Precise RoI pooling (PrRoI), the port of ``ganspace_tpu/ops/prroi.py``.

PrRoI pooling (Jiang et al., ECCV'18) averages the bilinearly interpolated
feature surface over each RoI bin by exact integration.  The bilinear
kernel is separable, so the double integral factorizes:

    out[r, c, p, q] = 1/area * sum_{h, w} Wy[r, p, h] * F[c, h, w] * Wx[r, q, w]

where ``Wx[r, q, i] = ∫_bin max(0, 1 - |x - i|) dx`` has a closed form (the
triangle kernel's CDF).  The op is two weight tensors and one einsum, in
IEEE float32 as the JAX package runs it at HIGHEST; autograd of the
(C1-continuous) CDF gives the gradients with respect to the features and
the RoI coordinates, as ``jax.grad`` does there.  No TPU kernel stands
here: the JAX package leaves the op to XLA.
"""

from __future__ import annotations

import torch

from ganspace_tpu_torch.ops.precision import ieee_f32


def _tri_cdf(u: torch.Tensor) -> torch.Tensor:
    """G(u) = integral of the triangle kernel max(0, 1-|t|) over (-inf, u]."""
    u = torch.clamp(u, -1.0, 1.0)
    neg = 0.5 * torch.square(1.0 + u)            # u in [-1, 0]
    pos = 0.5 + u - 0.5 * torch.square(u)        # u in [0, 1]
    return torch.where(u < 0, neg, pos)


def _bin_weights(starts: torch.Tensor, ends: torch.Tensor, size: int) -> torch.Tensor:
    """[R, P] bin intervals -> [R, P, size] integration weights per pixel."""
    idx = torch.arange(size, dtype=starts.dtype, device=starts.device)
    return _tri_cdf(ends[..., None] - idx) - _tri_cdf(starts[..., None] - idx)


def prroi_pool2d(features: torch.Tensor, rois: torch.Tensor,
                 pooled_height: int, pooled_width: int,
                 spatial_scale: float = 1.0) -> torch.Tensor:
    """features [N, C, H, W]; rois [R, 5] = (batch_idx, x1, y1, x2, y2) in
    input coords.  Returns [R, C, pooled_height, pooled_width]."""
    _, _, h, w = features.shape
    batch_idx = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale

    bin_w = (x2 - x1) / pooled_width                              # [R]
    bin_h = (y2 - y1) / pooled_height

    px = torch.arange(pooled_width, dtype=features.dtype, device=features.device)
    py = torch.arange(pooled_height, dtype=features.dtype, device=features.device)
    x_starts = x1[:, None] + bin_w[:, None] * px[None, :]         # [R, pw]
    x_ends = x_starts + bin_w[:, None]
    y_starts = y1[:, None] + bin_h[:, None] * py[None, :]         # [R, ph]
    y_ends = y_starts + bin_h[:, None]

    wx = _bin_weights(x_starts, x_ends, w)                        # [R, pw, W]
    wy = _bin_weights(y_starts, y_ends, h)                        # [R, ph, H]

    f = features[batch_idx]                                       # [R, C, H, W]
    with ieee_f32():
        out = torch.einsum("rph,rchw,rqw->rcpq", wy, f, wx)

    area = bin_w[:, None, None, None] * bin_h[:, None, None, None]
    # Degenerate (empty) bins pool to 0, like the reference kernel.
    return torch.where(area > 0, out / torch.clamp(area, min=1e-12),
                       torch.zeros((), dtype=out.dtype, device=out.device))
