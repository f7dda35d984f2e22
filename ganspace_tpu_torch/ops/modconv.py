"""Kernel B's modes: the 3x3 convolutions of StyleGAN and StyleGAN2 synthesis.

Counterpart of ``ganspace_tpu/ops/modconv.py`` and of the TPU kernel
``ops/pallas/blockconv.py::conv3x3_blocks_pallas``.  Modulation is per
input channel and demodulation per (sample, output channel), so

    y_b = d_b * conv(x_b * s_b, scale * W)
    d_b[o] = rsqrt(sum_i s_b[i]^2 * sum_kk (scale * W[o, i])^2 + 1e-8)

runs as one shared batched convolution, with no per-sample weights.  Each
mode below is one hand-written CUDA kernel entry (``csrc/``) beside its
plain PyTorch version, which is the CPU path and the kernel's oracle:

* :func:`modconv3x3`: the modulated 3x3 conv (StyleGAN2's non-upsampling
  StyledConvs), the style scale applied as the kernel forms its input
  fragments and ``d`` in its epilogue (``csrc/modconv3x3.cu``);
* :func:`conv3x3`: the plain 3x3 conv, the TPU kernel's own function
  (StyleGAN's ``conv``, ``conv1`` and sub-128-px ``conv0_up``), the same
  kernel with no scale and no demodulation;
* :func:`upsample_conv`: the stride-2 transposed conv, with optional ``s``
  and ``d`` (StyleGAN2's upsampling StyledConvs, StyleGAN's fused
  ``conv0_up``), as four phase correlations on the same implicit GEMM,
  launched as one grid (``csrc/upconv2x.cu``): a fixed summation order, so
  a repeated call gives identical bits, which cuDNN's transposed
  convolution does not.  A layer gathers its phases' taps once
  (:class:`PhaseWeights`).

The blur after an upsampling conv and the 1x1 ``to_rgb`` conv stay stock
PyTorch ops, as the JAX package leaves them to XLA; they run under the
float32 policy of ``ops/precision.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ganspace_tpu_torch.ops._build import check, load_kernels, stream_handle
from ganspace_tpu_torch.ops.upfirdn import upfirdn2d


def demodulation(w_scaled: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """d [B, out] = rsqrt(s^2 @ sum_kk(w^2).T + 1e-8) for the scaled weight."""
    w2 = torch.sum(w_scaled * w_scaled, dim=(2, 3))       # [out, in]
    return torch.rsqrt((s * s) @ w2.T + 1e-8)


def _cuda_operands(name: str, x: torch.Tensor, w: torch.Tensor, s, d,
                   out_elems: int) -> None:
    """Raise on what the kernels do not take: a non-CUDA device, another
    dtype or device among the operands, a wrong s or d shape, int overflow."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    tensors = [x, w] + [t for t in (s, d) if t is not None]
    if any(t.dtype != torch.float32 or t.device != x.device for t in tensors):
        raise TypeError(f"{name}: all operands must be float32 on one CUDA device")
    b, c = x.shape[:2]
    if (s is not None and s.shape != (b, c)) or (d is not None and d.shape != (b, w.shape[0])):
        raise ValueError(f"{name}: s must be [B, C] and d [B, Co]")
    if max(x.numel(), out_elems) >= 2 ** 31:
        raise ValueError(f"{name}: tensor too large for the kernel's int sizes")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_3x3(name: str, x, w_scaled) -> None:
    c, co = x.shape[1], w_scaled.shape[0]
    if w_scaled.shape != (co, c, 3, 3):
        raise ValueError(f"{name}: weight {tuple(w_scaled.shape)} does not "
                         f"match {c} input channels with a 3x3 kernel")


def _launch_3x3(name: str, x, w_scaled, s, d) -> torch.Tensor:
    b, c, h, w = x.shape
    co = w_scaled.shape[0]
    _cuda_operands(name, x, w_scaled, s, d, b * co * h * w)
    x, w_scaled = x.contiguous(), w_scaled.contiguous()
    s = None if s is None else s.contiguous()
    d = None if d is None else d.contiguous()
    y = torch.empty((b, co, h, w), dtype=torch.float32, device=x.device)
    check(load_kernels().ganspace_modconv3x3(
        x.data_ptr(), w_scaled.data_ptr(), _ptr(s), _ptr(d), y.data_ptr(),
        b, c, h, w, co, stream_handle(x)), name)
    return y


def modconv3x3_plain(x: torch.Tensor, w_scaled: torch.Tensor, s: torch.Tensor,
                     d: torch.Tensor | None) -> torch.Tensor:
    """Plain PyTorch version of the modulated mode: the CPU path and its oracle."""
    y = F.conv2d(x * s[:, :, None, None], w_scaled, padding=1)
    return y if d is None else y * d[:, :, None, None]


def modconv3x3(x: torch.Tensor, w_scaled: torch.Tensor, s: torch.Tensor,
               d: torch.Tensor | None) -> torch.Tensor:
    """d * conv3x3(x * s, w_scaled), stride 1, zero padding 1, NCHW float32.

    x [B, C, H, W], w_scaled [Co, C, 3, 3] (the He scale already applied),
    s [B, C], d [B, Co] or None.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    _check_3x3("modconv3x3", x, w_scaled)
    if x.device.type == "cpu":
        return modconv3x3_plain(x, w_scaled, s, d)
    if s is None:
        raise ValueError("modconv3x3: s is required (conv3x3 is the plain mode)")
    y = _launch_3x3("modconv3x3", x, w_scaled, s, d)
    modconv3x3.launches += 1
    return y


#: kernel launches since the last reset (CPU calls do not count)
modconv3x3.launches = 0


def conv3x3_plain(x: torch.Tensor, w_scaled: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the plain mode: the CPU path and its oracle."""
    return F.conv2d(x, w_scaled, padding=1)


def conv3x3(x: torch.Tensor, w_scaled: torch.Tensor) -> torch.Tensor:
    """conv3x3(x, w_scaled), stride 1, zero padding 1, NCHW float32: the TPU
    kernel's own function, with no scale and no demodulation.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    _check_3x3("conv3x3", x, w_scaled)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w_scaled)
    y = _launch_3x3("conv3x3", x, w_scaled, None, None)
    conv3x3.launches += 1
    return y


#: kernel launches since the last reset (CPU calls do not count)
conv3x3.launches = 0


def upsample_conv_plain(x: torch.Tensor, w_scaled: torch.Tensor,
                        s: torch.Tensor | None = None, d: torch.Tensor | None = None,
                        pad: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the stride-2 mode: the CPU path and its oracle."""
    xs = x if s is None else x * s[:, :, None, None]
    y = F.conv_transpose2d(xs, w_scaled.transpose(0, 1), stride=2, padding=pad)
    return y if d is None else y * d[:, :, None, None]


def upsample_phases(k: int, pad: int, h: int, w: int):
    """The four output phases of a stride-2 transposed conv with a k x k
    kernel and padding ``pad`` on an h x w input, as the kernel runs them:
    ``(py, px, uy, ux, dy, dx, oh, ow)``.  Output row 2m + py collects the
    taps ``uy`` (in window order) from input rows m - 1 + dy + a, a < len(uy);
    the phase's grid is oh x ow.  Likewise for columns."""
    def axis(p, n):
        taps = sorted((u for u in range(k) if (u - p - pad) % 2 == 0), reverse=True)
        first = (p + pad - taps[0]) // 2          # input offset of the window's first tap
        size = 2 * n + k - 2 - 2 * pad
        return taps, first + 1, (size - p + 1) // 2
    phases = []
    for py in (0, 1):
        uy, dy, oh = axis(py, h)
        for px in (0, 1):
            ux, dx, ow = axis(px, w)
            phases.append((py, px, uy, ux, dy, dx, oh, ow))
    return phases


def phase_weight(w_scaled: torch.Tensor, uy, ux) -> torch.Tensor:
    """One phase's taps of ``w_scaled`` [Co, C, k, k] in the kernel's layout
    [Co, ceil(C / 8), len(uy) * len(ux), 8], zero past channel C.  A phase's
    taps are every other tap in descending order, so strided slices and a
    flip gather them on the weight's device (an index list would be copied
    from the host, and that copy waits for the device)."""
    co, c = w_scaled.shape[:2]
    taps = w_scaled[:, :, min(uy)::2, min(ux)::2].flip(2, 3).reshape(co, c, -1)
    taps = F.pad(taps, (0, 0, 0, -c % 8))
    return taps.reshape(co, -1, 8, taps.shape[-1]).transpose(2, 3).contiguous()


def phase_weights(w_scaled: torch.Tensor, pad: int) -> torch.Tensor:
    """The four phases' :func:`phase_weight` of a stride-2 transposed conv
    with padding ``pad``, flat and one after another in the order of
    :func:`upsample_phases`: the weight operand of the stride-2 kernel."""
    k = w_scaled.shape[-1]
    return torch.cat([phase_weight(w_scaled, uy, ux).reshape(-1)
                      for _, _, uy, ux, *_ in upsample_phases(k, pad, 1, 1)])


class PhaseWeights:
    """One layer's :func:`phase_weights`, gathered when its weight first
    reaches the stride-2 kernel and again only after that weight changes: a
    load, an in-place edit or a move changes its storage or its version."""

    def __init__(self, source: torch.Tensor):
        self.source = source
        self._key = None
        self._value = None

    def get(self, w_scaled: torch.Tensor, pad: int) -> torch.Tensor:
        """The phase weights of ``w_scaled``, the scaled form of ``source``."""
        key = (self.source.data_ptr(), self.source._version, w_scaled.device,
               tuple(w_scaled.shape), pad)
        if key != self._key:
            self._value = phase_weights(w_scaled, pad)
            self._key = key
        return self._value


@functools.lru_cache(maxsize=None)
def _phase_table(k: int, pad: int, h: int, w: int):
    """The kernel's phase descriptors [4][8] (ty, tx, dy, dx, oh, ow, py, px)."""
    rows = [(len(uy), len(ux), dy, dx, oh, ow, py, px)
            for py, px, uy, ux, dy, dx, oh, ow in upsample_phases(k, pad, h, w)]
    flat = [v for row in rows for v in row]
    return (ctypes.c_int * len(flat))(*flat), len(rows)


def upsample_conv(x: torch.Tensor, w_scaled: torch.Tensor,
                  s: torch.Tensor | None = None, d: torch.Tensor | None = None,
                  *, pad: int = 0, cache: PhaseWeights | None = None) -> torch.Tensor:
    """d * conv_transpose2d(x * s, w_scaled^T, stride 2, padding ``pad``),
    NCHW float32: x [B, C, H, W], w_scaled [Co, C, k, k] (k = 3 or 4, the
    correlation orientation of a conv weight), s [B, C] or None, d [B, Co]
    or None; the output is [B, Co, 2H + k - 2 - 2 pad, ...].  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel, its four
    output phases in one grid, or raises.  ``cache``, the layer's
    :class:`PhaseWeights`, keeps the gathered taps between calls."""
    b, c, h, w = x.shape
    co, _, k, _ = w_scaled.shape
    if w_scaled.shape != (co, c, k, k) or k not in (3, 4) or pad not in (0, 1):
        raise ValueError(f"upsample_conv: weight {tuple(w_scaled.shape)} with padding "
                         f"{pad} is not a 3x3 or 4x4 kernel over {c} channels")
    if x.device.type == "cpu":
        return upsample_conv_plain(x, w_scaled, s, d, pad)
    ho, wo = 2 * h + k - 2 - 2 * pad, 2 * w + k - 2 - 2 * pad
    _cuda_operands("upsample_conv", x, w_scaled, s, d, b * co * ho * wo)
    x = x.contiguous()
    s = None if s is None else s.contiguous()
    d = None if d is None else d.contiguous()
    wp = phase_weights(w_scaled, pad) if cache is None else cache.get(w_scaled, pad)
    table, n = _phase_table(k, pad, h, w)
    y = torch.empty((b, co, ho, wo), dtype=torch.float32, device=x.device)
    check(load_kernels().ganspace_upsample_conv(
        x.data_ptr(), wp.data_ptr(), _ptr(s), _ptr(d), y.data_ptr(), ctypes.addressof(table),
        n, b, c, h, w, co, ho, wo, stream_handle(x)), "upsample_conv")
    upsample_conv.launches += 1
    return y


#: kernel launches since the last reset, one per call (CPU calls do not count)
upsample_conv.launches = 0


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     style_scales: torch.Tensor, *, demodulate: bool = True,
                     upsample: bool = False,
                     blur_kernel: torch.Tensor | None = None,
                     phase_cache: PhaseWeights | None = None) -> torch.Tensor:
    """Modulated conv on an NCHW batch.

    Args:
      x: [B, in, H, W] activations.
      weight: [out, in, kh, kw], torch orientation.
      style_scales: [B, in] per-channel modulation from the style affine.
      blur_kernel: 2-D FIR kernel for the upsampling path (gain 1).
      phase_cache: the layer's :class:`PhaseWeights` of ``weight`` for the
        upsampling path.
    """
    out_ch, in_ch, kh, kw = weight.shape
    w = weight * (1.0 / math.sqrt(in_ch * kh * kw))
    s = style_scales.to(x.dtype)
    d = demodulation(w, s) if demodulate else None

    if upsample:
        y = upsample_conv(x, w, s, d, cache=phase_cache)
        # Blur of the transposed-conv path: taps scaled by factor^2 = 4,
        # p = (len - factor) - (k - 1).
        p = (blur_kernel.shape[0] - 2) - (kh - 1)
        return upfirdn2d(y, blur_kernel * 4.0, pad=((p + 1) // 2 + 1, p // 2 + 1))
    if kh == 3 and kw == 3:
        return modconv3x3(x, w, s, d)
    y = F.conv2d(x * s[:, :, None, None], w, padding=kh // 2)
    return y if d is None else y * d[:, :, None, None]
