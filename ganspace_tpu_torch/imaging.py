"""Small host-side image helpers (copy of ``ganspace_tpu/utils/imaging.py``'s
host functions, which cannot be imported without JAX)."""

from __future__ import annotations

import numpy as np
import torch


def pad_frames(strip):
    """Interleave white bars 1/64 of the frame width wide between the frames
    of a strip (white: 1.0 for float images, the dtype's maximum for ints)."""
    dtype = strip[0].dtype
    pad_value = 1.0 if dtype in (np.float32, np.float64) else np.iinfo(dtype).max
    frames = [strip[0]]
    for frame in strip[1:]:
        frames.append(np.full((frame.shape[0], frame.shape[1] // 64, 3), pad_value,
                              dtype=dtype))
        frames.append(frame)
    return frames


def to_uint8(img01: np.ndarray) -> np.ndarray:
    """[0,1] float image -> uint8 (uint8 input passes through unchanged)."""
    img01 = np.asarray(img01)
    if img01.dtype == np.uint8:
        return img01
    return (255.0 * np.clip(img01, 0.0, 1.0) + 0.5).astype(np.uint8)


def uint8_nhwc(img: torch.Tensor) -> np.ndarray:
    """[B,3,H,W] float [0,1] -> host [B,H,W,3] uint8, quantized on the
    tensor's device so only a quarter of the bytes cross to the host (the
    same clip-and-round rule as :func:`to_uint8`)."""
    x = torch.clamp(img.permute(0, 2, 3, 1), 0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
