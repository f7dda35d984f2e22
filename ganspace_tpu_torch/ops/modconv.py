"""Style-modulated convolution, the StyleGAN2 hot op.

Counterpart of ``ganspace_tpu/ops/modconv.py``.  Modulation is per input
channel and demodulation per (sample, output channel), so

    y_b = d_b * conv(x_b * s_b, scale * W)
    d_b[o] = rsqrt(sum_i s_b[i]^2 * sum_kk (scale * W[o, i])^2 + 1e-8)

runs as one shared batched convolution, with no per-sample weights.

* The plain 3x3 path (every non-upsampling StyledConv) goes through the
  CUDA kernel ``csrc/modconv3x3.cu`` (:func:`modconv3x3`), an implicit GEMM
  on the tensor cores in 3xTF32 that reads the weight in its OIHW layout,
  applies the style scale as it forms its input fragments and ``d`` in its
  epilogue.  It
  replaces the TPU kernel ``ops/pallas/blockconv.py::conv3x3_blocks_pallas``
  with the scale and demodulation around it (``ops/s2d.py:244-261``).
* The upsampling path (transposed conv, then FIR blur) and the 1x1
  ``to_rgb`` path are stock PyTorch ops, as the JAX package leaves them to
  XLA; they run under the float32 policy of ``ops/precision.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ganspace_tpu_torch.ops._build import check, load_kernels, stream_handle
from ganspace_tpu_torch.ops.upfirdn import upfirdn2d


def demodulation(w_scaled: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """d [B, out] = rsqrt(s^2 @ sum_kk(w^2).T + 1e-8) for the scaled weight."""
    w2 = torch.sum(w_scaled * w_scaled, dim=(2, 3))       # [out, in]
    return torch.rsqrt((s * s) @ w2.T + 1e-8)


def modconv3x3_plain(x: torch.Tensor, w_scaled: torch.Tensor, s: torch.Tensor,
                     d: torch.Tensor | None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the CPU path and its oracle."""
    y = F.conv2d(x * s[:, :, None, None], w_scaled, padding=1)
    return y if d is None else y * d[:, :, None, None]


def modconv3x3(x: torch.Tensor, w_scaled: torch.Tensor, s: torch.Tensor,
               d: torch.Tensor | None) -> torch.Tensor:
    """d * conv3x3(x * s, w_scaled), stride 1, zero padding 1, NCHW float32.

    x [B, C, H, W], w_scaled [Co, C, 3, 3] (the He scale already applied),
    s [B, C], d [B, Co] or None.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    b, c, h, w = x.shape
    co = w_scaled.shape[0]
    if w_scaled.shape != (co, c, 3, 3):
        raise ValueError(f"modconv3x3: weight {tuple(w_scaled.shape)} does not "
                         f"match {c} input channels with a 3x3 kernel")
    if x.device.type == "cpu":
        return modconv3x3_plain(x, w_scaled, s, d)
    if x.device.type != "cuda":
        raise ValueError(f"modconv3x3: unsupported device {x.device}")
    tensors = [x, w_scaled, s] + ([] if d is None else [d])
    if any(t.dtype != torch.float32 or t.device != x.device for t in tensors):
        raise TypeError("modconv3x3: all operands must be float32 on one CUDA device")
    if s.shape != (b, c) or (d is not None and d.shape != (b, co)):
        raise ValueError("modconv3x3: s must be [B, C] and d [B, Co]")
    if max(x.numel(), b * co * h * w) >= 2 ** 31:
        raise ValueError("modconv3x3: tensor too large for the kernel's int sizes")
    x = x.contiguous()
    s = s.contiguous()
    wt = w_scaled.contiguous()
    if d is not None:
        d = d.contiguous()
    y = torch.empty((b, co, h, w), dtype=torch.float32, device=x.device)
    lib = load_kernels()
    check(lib.ganspace_modconv3x3(x.data_ptr(), wt.data_ptr(), s.data_ptr(),
                                  None if d is None else d.data_ptr(),
                                  y.data_ptr(), b, c, h, w, co,
                                  stream_handle(x)),
          "modconv3x3")
    modconv3x3.launches += 1
    return y


#: kernel launches since the last reset (CPU calls do not count)
modconv3x3.launches = 0


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     style_scales: torch.Tensor, *, demodulate: bool = True,
                     upsample: bool = False,
                     blur_kernel: torch.Tensor | None = None) -> torch.Tensor:
    """Modulated conv on an NCHW batch.

    Args:
      x: [B, in, H, W] activations.
      weight: [out, in, kh, kw], torch orientation.
      style_scales: [B, in] per-channel modulation from the style affine.
      blur_kernel: 2-D FIR kernel for the upsampling path (gain 1).
    """
    out_ch, in_ch, kh, kw = weight.shape
    w = weight * (1.0 / math.sqrt(in_ch * kh * kw))
    s = style_scales.to(x.dtype)
    d = demodulation(w, s) if demodulate else None

    if not upsample and kh == 3 and kw == 3:
        return modconv3x3(x, w, s, d)
    xs = x * s[:, :, None, None]
    if upsample:
        y = F.conv_transpose2d(xs, w.transpose(0, 1), stride=2)
        # Blur of the transposed-conv path: taps scaled by factor^2 = 4,
        # p = (len - factor) - (k - 1).
        p = (blur_kernel.shape[0] - 2) - (kh - 1)
        y = upfirdn2d(y, blur_kernel * 4.0, pad=((p + 1) // 2 + 1, p // 2 + 1))
    else:
        y = F.conv2d(xs, w, padding=kh // 2)
    return y if d is None else y * d[:, :, None, None]
