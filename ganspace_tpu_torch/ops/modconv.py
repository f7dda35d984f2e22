"""Kernel B's modes: the 3x3 and stride-2 convolutions of every generator.

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
  (StyleGAN's ``conv``, ``conv1`` and sub-128-px ``conv0_up``, BigGAN's
  and ProGAN's stride-1 3x3 convs), the same kernel with no scale and no
  demodulation;
* :func:`upsample_conv`: the stride-2 transposed conv, with optional ``s``
  and ``d`` (StyleGAN2's upsampling StyledConvs, StyleGAN's fused
  ``conv0_up``, BigGAN's and ProGAN's nearest-up convs through
  :func:`nearest_up_kernel`, DCGAN's transposed convs), as one dense
  product of pixels by (tap, output channel) on
  Hopper's wgmma and an overlap-add of the taps (``csrc/upconv2x.cu``): a
  fixed summation order, so a repeated call gives identical bits, which
  cuDNN's transposed convolution does not.  A layer splits its weight into
  TF32 hi and lo once, in the layout the kernel reads
  (:class:`UpsampleWeights`).

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
from ganspace_tpu_torch.ops.tf32x3 import split_tf32, sw128_image
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


#: output channels per block of the stride-2 kernel, by kernel size: N =
#: k^2 * cot columns of taps x channels (144 for k = 3, 128 for k = 4)
UP_COT = {3: 16, 4: 8}
UP_KC = 32            # input channels per stage (a [N][32] weight tile pair)
UP_TILE_M = 128       # pixels per block
UP_MAX_SPT = 32       # whole samples per block at most


def _axis_tilings(n: int):
    """(owned, loaded, halo, tiles) of one axis of n input rows: the whole
    axis, or tiles of t rows plus the halo row above each."""
    yield n, n, 0, 1
    for t in range(1, min(n, UP_TILE_M)):
        yield t, t + 1, 1, -(-n // t)


@functools.lru_cache(maxsize=None)
def upsample_tiling(b: int, h: int, w: int) -> tuple:
    """The stride-2 kernel's block tiling of a [b, *, h, w] input:
    ``(spt, tr, lr, hr, tiles_r, tc, lc, hc, tiles_c)``.  A block holds at
    most 128 input pixels: ``spt`` whole samples when a sample fits, else a
    rectangle of one sample that owns ``tr`` x ``tc`` input pixels and loads
    ``lr`` x ``lc`` of them (``hr``, ``hc``: one halo row above, one halo
    column to the left, whose taps land in its outputs).  Of the tilings that
    fit, the one with the fewest blocks; among those, 16-byte row copies
    (whole rows of a width divisible by 4), then the fewest loaded pixels."""
    best = None
    for tr, lr, hr, nr in _axis_tilings(h):
        for tc, lc, hc, nc in _axis_tilings(w):
            if lr * lc > UP_TILE_M:
                continue
            spt = min(UP_TILE_M // (lr * lc), UP_MAX_SPT, b) if hr == hc == 0 else 1
            blocks = -(-b // spt) * nr * nc
            key = (blocks, not (hc == 0 and w % 4 == 0), blocks * lr * lc * spt)
            if best is None or key < best[0]:
                best = key, (spt, tr, lr, hr, nr, tc, lc, hc, nc)
    return best[1]


def upsample_weight_matrix(w_scaled: torch.Tensor) -> torch.Tensor:
    """The stride-2 kernel's B operand of ``w_scaled`` [Co, C, k, k]:
    [n_co, chunks, N, 32] with B[t, q, tap * cot + o, c] = w_scaled[t * cot
    + o, 32 q + c, u, v] for tap = u * k + v, zero past Co and C."""
    co, c, k, _ = w_scaled.shape
    cot = UP_COT[k]
    n_co, chunks = -(-co // cot), -(-c // UP_KC)
    wt = w_scaled.permute(2, 3, 0, 1).reshape(k * k, co, c)
    wt = F.pad(wt, (0, chunks * UP_KC - c, 0, n_co * cot - co))
    wt = wt.reshape(k * k, n_co, cot, chunks, UP_KC).permute(1, 3, 0, 2, 4)
    return wt.reshape(n_co, chunks, k * k * cot, UP_KC)


def upsample_weight_image(w_scaled: torch.Tensor) -> torch.Tensor:
    """The weight operand of the stride-2 kernel: :func:`upsample_weight_matrix`
    split into TF32 hi and lo (``ops/tf32x3.split_tf32``), each [N, 32] tile
    in the swizzled layout the kernel's wgmma reads (``sw128_image``):
    [n_co, chunks, 2 (hi, lo), N * 32], contiguous."""
    hi, lo = split_tf32(upsample_weight_matrix(w_scaled).contiguous())
    return sw128_image(torch.stack((hi, lo), dim=2)).contiguous()


class UpsampleWeights:
    """One layer's :func:`upsample_weight_image`, split and laid out when its
    weight first reaches the stride-2 kernel and again only after that weight
    changes: a load, an in-place edit or a move changes its storage or its
    version."""

    def __init__(self, source: torch.Tensor):
        self.source = source
        self._key = None
        self._value = None

    def get(self, w_scaled: torch.Tensor) -> torch.Tensor:
        """The weight image of ``w_scaled``, the scaled form of ``source``."""
        key = (self.source.data_ptr(), self.source._version, w_scaled.device,
               tuple(w_scaled.shape))
        if key != self._key:
            self._value = upsample_weight_image(w_scaled)
            self._key = key
        return self._value


# Per-axis tap sums of a nearest 2x upsample followed by a 3-tap correlation
# (``ganspace_tpu/ops/s2d.py:_NEAREST_TAPS``): composite tap e of the 4-tap
# kernel sums taps u of the 3-tap one where A[e][u] is 1.
_NEAREST_TAPS = ((1, 0, 0), (1, 1, 0), (0, 1, 1), (0, 0, 1))


def nearest_up_kernel(w: torch.Tensor) -> torch.Tensor:
    """The 4x4 kernel of the stride-2 transposed conv (padding 1) that equals
    nearest 2x upsampling followed by the 3x3 correlation ``w`` (padding 1):
    ``upsample_conv(x, nearest_up_kernel(w), pad=1) == conv2d(up2(x), w, padding=1)``.
    BigGAN's and ProGAN's up-convs run so, on 4/9 of the products."""
    a = torch.tensor(_NEAREST_TAPS, dtype=w.dtype, device=w.device)
    return torch.einsum("eu,ocuv,fv->ocef", a, w, a).flip(2, 3).contiguous()


def upsample_conv(x: torch.Tensor, w_scaled: torch.Tensor,
                  s: torch.Tensor | None = None, d: torch.Tensor | None = None,
                  *, pad: int = 0, cache: UpsampleWeights | None = None) -> torch.Tensor:
    """d * conv_transpose2d(x * s, w_scaled^T, stride 2, padding ``pad``),
    NCHW float32: x [B, C, H, W], w_scaled [Co, C, k, k] (k = 3 or 4, the
    correlation orientation of a conv weight), s [B, C] or None, d [B, Co]
    or None; the output is [B, Co, 2H + k - 2 - 2 pad, ...].  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    ``cache``, the layer's :class:`UpsampleWeights`, keeps the split weight
    between calls."""
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
    image = upsample_weight_image(w_scaled) if cache is None else cache.get(w_scaled)
    tiling = (ctypes.c_int * 9)(*upsample_tiling(b, h, w))
    y = torch.empty((b, co, ho, wo), dtype=torch.float32, device=x.device)
    check(load_kernels().ganspace_upsample_conv(
        x.data_ptr(), image.data_ptr(), _ptr(s), _ptr(d), y.data_ptr(), ctypes.addressof(tiling),
        b, c, h, w, co, k, pad, stream_handle(x)), "upsample_conv")
    upsample_conv.launches += 1
    return y


#: kernel launches since the last reset, one per call (CPU calls do not count)
upsample_conv.launches = 0


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     style_scales: torch.Tensor, *, demodulate: bool = True,
                     upsample: bool = False,
                     blur_kernel: torch.Tensor | None = None,
                     weight_cache: UpsampleWeights | None = None) -> torch.Tensor:
    """Modulated conv on an NCHW batch.

    Args:
      x: [B, in, H, W] activations.
      weight: [out, in, kh, kw], torch orientation.
      style_scales: [B, in] per-channel modulation from the style affine.
      blur_kernel: 2-D FIR kernel for the upsampling path (gain 1).
      weight_cache: the layer's :class:`UpsampleWeights` of ``weight`` for
        the upsampling path.
    """
    out_ch, in_ch, kh, kw = weight.shape
    w = weight * (1.0 / math.sqrt(in_ch * kh * kw))
    s = style_scales.to(x.dtype)
    d = demodulation(w, s) if demodulate else None

    if upsample:
        y = upsample_conv(x, w, s, d, cache=weight_cache)
        # Blur of the transposed-conv path: taps scaled by factor^2 = 4,
        # p = (len - factor) - (k - 1).
        p = (blur_kernel.shape[0] - 2) - (kh - 1)
        return upfirdn2d(y, blur_kernel * 4.0, pad=((p + 1) // 2 + 1, p // 2 + 1))
    if kh == 3 and kw == 3:
        return modconv3x3(x, w, s, d)
    y = F.conv2d(x * s[:, :, None, None], w, padding=kh // 2)
    return y if d is None else y * d[:, :, None, None]
