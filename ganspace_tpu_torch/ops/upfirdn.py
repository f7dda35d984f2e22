"""upfirdn2d (upsample, FIR filter, downsample) with stock PyTorch ops.

Counterpart of ``ganspace_tpu/ops/upfirdn.py``.  Zero-stuffing, padding
(negative values crop) and a depthwise true convolution with the FIR
kernel, NCHW.  A 2-D kernel (StyleGAN2's blur) runs as one 2-D depthwise
convolution; 1-D taps (StyleGAN3's Kaiser filters, 12 or 24 taps) run
separably, as a depthwise pass along the width and one along the height,
each with the square root of the gain.  The JAX package leaves this to
XLA; the port leaves it to PyTorch's depthwise convolution (cuDNN or
PyTorch's own kernel), under the policy of ``ops/precision.py`` (the bf16
datapath rounds its operands to bf16 and writes ``x``'s dtype).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ganspace_tpu_torch.ops import precision


def make_fir_kernel(taps) -> torch.Tensor:
    """Separable FIR kernel from 1-D taps (e.g. [1,3,3,1]), normalized to sum 1."""
    k = np.asarray(taps, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return torch.from_numpy(k / k.sum())


#: the flipped, scaled kernels in each storage, made once per kernel tensor
_KERNELS = precision.StorageCopies()


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """Apply upfirdn to an NCHW batch with a FIR ``kernel`` times ``gain``:
    a 2-D kernel in one pass, 1-D taps separably (the same filter on both
    axes).  ``pad`` (before, after) applies to both axes."""
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    if kernel.ndim == 1:
        return _separable(x, kernel, down, gain)
    kh, kw = kernel.shape
    # true convolution: flip the kernel (conv2d correlates)
    k = _KERNELS(kernel, x.dtype, gain, lambda t: torch.flip(t * gain, (0, 1)))
    return precision.conv2d(x, k.reshape(1, 1, kh, kw).expand(c, 1, kh, kw), stride=down,
                            groups=c)


def _separable(x: torch.Tensor, taps: torch.Tensor, down: int, gain: float) -> torch.Tensor:
    """The 1-D ``taps`` times sqrt(``gain``) as a true convolution along the
    width, then along the height, each pass keeping every ``down``-th
    output."""
    c, t = x.shape[1], taps.shape[0]
    k = _KERNELS(taps, x.dtype, gain, lambda f: torch.flip(f * math.sqrt(gain), (0,)))
    x = precision.conv2d(x, k.reshape(1, 1, 1, t).expand(c, 1, 1, t), stride=(1, down),
                         groups=c)
    return precision.conv2d(x, k.reshape(1, 1, t, 1).expand(c, 1, t, 1), stride=(down, 1),
                            groups=c)


def upsample2x(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """StyleGAN2 ``Upsample``: zero-stuff x2 then low-pass with gain 4."""
    p = kernel.shape[0] - 2
    return upfirdn2d(x, kernel, up=2, pad=((p + 1) // 2 + 1, p // 2), gain=4.0)
