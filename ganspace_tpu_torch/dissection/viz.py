"""Activation / segmentation visualization overlays
(reference ``netdissect/actviz.py`` + ``segviz.py``).

Counterpart of ``ganspace_tpu/dissection/viz.py``: numpy in, numpy out, the
resizes on CPU tensors with ``jax.image.resize``'s semantics (bilinear at
half-pixel centres, antialiased when it shrinks; ``nearest`` is torch's
``nearest-exact``, not its ``nearest``):

* :func:`activation_overlay` — highlight the image region where a unit fires
  above its threshold (reference's translucent-dim + border overlay);
* :func:`activation_surface` — raw bilinear activation heatmap;
* :func:`segment_visualization` — color-code a (possibly multi-channel)
  segmentation with a stable high-contrast palette.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize(x, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """[N, C, h, w] -> [N, C, *size], as ``jax.image.resize`` does it on the
    last two axes: ``bilinear``/``linear`` (antialiased where it shrinks) or
    ``nearest``."""
    x = torch.as_tensor(x)
    size = tuple(int(s) for s in size)
    if method == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrink)


def _to_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3):
        img = np.transpose(img, (1, 2, 0))
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.clip(img.astype(np.float32), 0.0, 1.0)


def activation_surface(act: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Unit activation [h, w] -> bilinear heatmap [H, W] in [0,1]."""
    act = torch.as_tensor(np.asarray(act, np.float32))[None, None]
    up = resize(act, size)[0, 0].numpy()
    lo, hi = up.min(), up.max()
    return (up - lo) / max(hi - lo, 1e-9)


def activation_overlay(img: np.ndarray, act: np.ndarray,
                       level: Optional[float] = None,
                       dim: float = 0.6, tint=(1.0, 0.25, 0.1)) -> np.ndarray:
    """Dim the image outside the unit's active region and tint its border
    (the reference's report-image style).  ``act`` is the unit's [h, w] map;
    ``level`` defaults to its 96th percentile."""
    img = _to_hwc(img)
    h, w = img.shape[:2]
    surface = activation_surface(act, (h, w))
    if level is None:
        thr = float(np.quantile(np.asarray(act, np.float32), 0.96))
        amax = float(np.max(act))
        amin = float(np.min(act))
        level = (thr - amin) / max(amax - amin, 1e-9)
    mask = surface >= level
    out = img * (dim + (1.0 - dim) * mask[..., None])
    # 1px border of the mask, tinted
    edge = mask ^ (np.roll(mask, 1, 0) & np.roll(mask, -1, 0)
                   & np.roll(mask, 1, 1) & np.roll(mask, -1, 1) & mask)
    out[edge] = np.asarray(tint, np.float32)
    return np.clip(out, 0.0, 1.0)


_PALETTE: Optional[np.ndarray] = None


def high_contrast_palette(n: int = 512) -> np.ndarray:
    """[n, 3] float palette; index 0 is black (background), following the
    reference's high-contrast arrangement (``segviz.py``)."""
    global _PALETTE
    if _PALETTE is None or _PALETTE.shape[0] < n:
        rs = np.random.RandomState(1)
        base = np.array([
            [0, 0, 0], [230, 25, 75], [60, 180, 75], [255, 225, 25],
            [0, 130, 200], [245, 130, 48], [145, 30, 180], [70, 240, 240],
            [240, 50, 230], [210, 245, 60], [250, 190, 212], [0, 128, 128],
            [220, 190, 255], [170, 110, 40], [255, 250, 200], [128, 0, 0],
            [170, 255, 195], [128, 128, 0], [255, 215, 180], [0, 0, 128],
            [128, 128, 128], [255, 255, 255],
        ], np.float32) / 255.0
        extra = rs.rand(max(0, n - len(base)), 3).astype(np.float32)
        extra = 0.25 + 0.75 * extra        # keep away from black
        _PALETTE = np.concatenate([base, extra])[:max(n, len(base))]
    return _PALETTE[:n]


def segment_visualization(seg: np.ndarray, size: Optional[Tuple[int, int]] = None
                          ) -> np.ndarray:
    """Flat-label segmentation [H,W] or [C,H,W] -> RGB [H,W,3] in [0,1].
    Multi-channel maps render the first non-background channel per pixel."""
    seg = np.asarray(seg)
    if seg.ndim == 3:
        merged = np.zeros(seg.shape[1:], seg.dtype)
        for c in range(seg.shape[0] - 1, -1, -1):
            merged = np.where(seg[c] > 0, seg[c], merged)
        seg = merged
    pal = high_contrast_palette(int(seg.max()) + 1 if seg.size else 1)
    out = pal[seg]
    if size is not None and out.shape[:2] != tuple(size):
        chw = torch.from_numpy(np.ascontiguousarray(out.transpose(2, 0, 1)))[None]
        out = resize(chw, size, "nearest")[0].permute(1, 2, 0).numpy()
    return out


def plot_tensor_images(data, **kwargs):
    """Square-grid matplotlib plot of an image batch (reference
    ``plotutil.py:4-30``).  ``data`` is [N, C, H, W] (or [N, H, W, C]) in
    [0, 1] floats or uint8; sized one display pixel per data pixel unless
    ``figsize`` is given.  Returns the figure (``plt.show()`` is called, a
    no-op on headless Agg backends)."""
    import matplotlib.pyplot as plt

    data = np.asarray(data)
    if data.ndim == 4 and data.shape[1] in (1, 3) and data.shape[-1] not in (1, 3):
        data = np.transpose(data, (0, 2, 3, 1))
    if data.dtype != np.uint8:
        data = (np.clip(data, 0, 1) * 255).astype(np.uint8)
    width = int(np.ceil(np.sqrt(data.shape[0])))
    height = int(np.ceil(data.shape[0] / float(width)))
    margin = 0.01
    kwargs = dict(kwargs)
    if "figsize" not in kwargs:
        dpi = plt.rcParams["figure.dpi"]
        kwargs["figsize"] = ((1 + margin) * (width * data.shape[2] / dpi),
                             (1 + margin) * (height * data.shape[1] / dpi))
    f, axarr = plt.subplots(height, width, squeeze=False, **kwargs)
    for i in range(width * height):
        ax = axarr[i // width, i % width]
        if i < len(data):
            ax.imshow(data[i].squeeze())
        ax.axis("off")
    plt.subplots_adjust(wspace=margin, hspace=margin,
                        left=0, right=1, bottom=0, top=1)
    plt.show()
    return f


def max_heatmaps(data, shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """[N, U, H, W] -> [N, *shape]: the max over units, resized linearly
    (antialiased where it shrinks) to ``shape`` (default: native)."""
    data = np.asarray(data, np.float32)
    maxed = data.max(axis=1)
    if shape is not None and tuple(shape) != maxed.shape[1:]:
        maxed = resize(torch.from_numpy(maxed)[:, None], shape, "linear")[:, 0].numpy()
    return maxed


def plot_max_heatmap(data, shape: Optional[Tuple[int, int]] = None, **kwargs):
    """Channel-max activation heatmaps on a shared color scale (reference
    ``plotutil.py:32-61``).  ``data`` is [N, U, H, W]; each sample plots
    ``max`` over units, bilinearly resized to ``shape`` (default: native).
    Returns the figure."""
    import matplotlib.pyplot as plt

    maxed = max_heatmaps(data, shape)
    shape = maxed.shape[1:]
    vmin, vmax = float(maxed.min()), float(maxed.max())
    width = int(np.ceil(np.sqrt(maxed.shape[0])))
    height = int(np.ceil(maxed.shape[0] / float(width)))
    margin = 0.01
    kwargs = dict(kwargs)
    if "figsize" not in kwargs:
        dpi = plt.rcParams["figure.dpi"]
        kwargs["figsize"] = ((1 + margin) * (width * shape[1] / dpi),
                             (1 + margin) * (height * shape[0] / dpi))
    f, axarr = plt.subplots(height, width, squeeze=False, **kwargs)
    for i in range(width * height):
        ax = axarr[i // width, i % width]
        if i < len(maxed):
            ax.imshow(maxed[i], vmin=vmin, vmax=vmax, cmap="hot")
        ax.axis("off")
    plt.subplots_adjust(wspace=margin, hspace=margin,
                        left=0, right=1, bottom=0, top=1)
    plt.show()
    return f
