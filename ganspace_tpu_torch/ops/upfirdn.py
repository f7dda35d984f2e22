"""upfirdn2d (upsample, FIR filter, downsample) with stock PyTorch ops.

Counterpart of ``ganspace_tpu/ops/upfirdn.py``.  Zero-stuffing, padding
(negative values crop) and a depthwise true convolution with the FIR
kernel, NCHW.  The JAX package leaves this to XLA; the port leaves it to
cuDNN, under the float32 policy of ``ops/precision.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_fir_kernel(taps) -> torch.Tensor:
    """Separable FIR kernel from 1-D taps (e.g. [1,3,3,1]), normalized to sum 1."""
    k = np.asarray(taps, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return torch.from_numpy(k / k.sum())


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Apply upfirdn to an NCHW batch with a 2-D FIR ``kernel``."""
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    kh, kw = kernel.shape
    # true convolution: flip the kernel (conv2d correlates)
    k = torch.flip(kernel, (0, 1)).to(x.dtype).reshape(1, 1, kh, kw)
    return F.conv2d(x, k.expand(c, 1, kh, kw), stride=down, groups=c)


def upsample2x(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """StyleGAN2 ``Upsample``: zero-stuff x2 then low-pass with gain 4."""
    p = kernel.shape[0] - 2
    return upfirdn2d(x, kernel * 4.0, up=2, pad=((p + 1) // 2 + 1, p // 2))
