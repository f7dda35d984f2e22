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
  (:class:`LayerWeights`); its bf16 datapath reads a bf16 image of the
  rounded weight instead (:func:`upsample_weight_image_bf16`).

Each mode has two datapaths, chosen per call by ``ops/precision.py``'s
rule (:func:`~ganspace_tpu_torch.ops.precision.bf16_operands`): 3xTF32 on
float32 operands, or, under the preview policy or on a bf16 ``x``, the
TPU kernel's bf16 case: ``x * s`` and the weight rounded to bf16, float32
accumulation, ``d`` in float32, and the output in ``x``'s dtype (float32
or bf16).  Kernel B's bf16 datapath has a body of its own
(``csrc/implicit_conv_bf16.cuh``: bf16 MMAs on tiles staged by
``cp.async``), its weight a bf16 tensor in the layout it reads
(:func:`bf16_taps`); so has the stride-2 mode's
(``csrc/upconv2x_bf16.cuh``: bf16 wgmma on shared tiles, the weight image
by TMA, x by a TMA tensor copy in its own storage, with a tiling of its own,
:func:`upsample_tiling_bf16`).  The plain version of the bf16 datapath is that
function exactly: the operands rounded, then ``F.conv2d`` /
``conv_transpose2d`` in float32 on the rounded values, then the output
rounded to ``x``'s dtype.

The blur after an upsampling conv and the 1x1 ``to_rgb`` conv stay stock
PyTorch ops, as the JAX package leaves them to XLA; they run under the
same policy (``ops/precision.conv2d``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ganspace_tpu_torch.ops import precision
from ganspace_tpu_torch.ops._build import check, load_kernels, stream_handle
from ganspace_tpu_torch.ops.precision import StorageCopies, bf16_operands, round_bf16
from ganspace_tpu_torch.ops.tf32x3 import split_tf32, sw128_image
from ganspace_tpu_torch.ops.upfirdn import upfirdn2d

#: the kernels' datapath modes (the C entries' ``mode``)
MODE_F32, MODE_BF16_OPS, MODE_BF16 = 0, 1, 2


def datapath_mode(x: torch.Tensor) -> int:
    """The kernels' mode for ``x``: float32 storage in 3xTF32, float32
    storage on the bf16 datapath (the preview precision), or bf16 storage."""
    if x.dtype == torch.bfloat16:
        return MODE_BF16
    return MODE_BF16_OPS if bf16_operands(x) else MODE_F32


def demodulation(w_scaled: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """d [B, out] = rsqrt(s^2 @ sum_kk(w^2).T + 1e-8) for the scaled weight."""
    w2 = torch.sum(w_scaled * w_scaled, dim=(2, 3))       # [out, in]
    return torch.rsqrt((s * s) @ w2.T + 1e-8)


def _cuda_operands(name: str, x: torch.Tensor, w: torch.Tensor, s, d,
                   out_elems: int) -> None:
    """Raise on what the kernels do not take: a non-CUDA device, x neither
    float32 nor bf16, another dtype than float32 or another device among the
    other operands, a wrong s or d shape, int overflow."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    tensors = [w] + [t for t in (s, d) if t is not None]
    if any(t.dtype != torch.float32 or t.device != x.device for t in tensors):
        raise TypeError(f"{name}: w, s and d must be float32 on x's CUDA device")
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


def _scale(t):
    """s as the kernels read it: float32, a bf16 s (x's storage) widened
    exactly; another dtype is left for :func:`_cuda_operands` to refuse."""
    if t is None:
        return None
    return (t.float() if t.dtype == torch.bfloat16 else t).contiguous()


def _count(wrapper, x) -> None:
    """One more launch of ``wrapper``'s kernel on ``x``'s datapath:
    ``launches`` (3xTF32) or ``launches_bf16`` (the bf16 datapath)."""
    if datapath_mode(x) == MODE_F32:
        wrapper.launches += 1
    else:
        wrapper.launches_bf16 += 1


def bf16_taps(w_scaled: torch.Tensor) -> torch.Tensor:
    """Kernel B's weight operand on the bf16 datapath: ``w_scaled`` [Co, C,
    3, 3] rounded to bf16 (to nearest even), as a bf16 tensor [Co, 3, 3, Cp]
    with the channels innermost, Cp = C rounded up to 16, zeros past C."""
    c = w_scaled.shape[1]
    taps = w_scaled.to(torch.bfloat16).permute(0, 2, 3, 1)
    return F.pad(taps, (0, -c % 16)).contiguous()


def _launch_3x3(name: str, x, w_scaled, s, d, cache) -> torch.Tensor:
    b, c, h, w = x.shape
    co = w_scaled.shape[0]
    mode = datapath_mode(x)
    s = _scale(s)
    _cuda_operands(name, x, w_scaled, s, d, b * co * h * w)
    x = x.contiguous()
    if mode == MODE_F32:
        wt = w_scaled.contiguous()
    else:
        wt = bf16_taps(w_scaled) if cache is None else cache.taps_bf16(w_scaled)
    d = None if d is None else d.contiguous()
    y = torch.empty((b, co, h, w), dtype=x.dtype, device=x.device)
    check(load_kernels().ganspace_modconv3x3(
        x.data_ptr(), wt.data_ptr(), _ptr(s), _ptr(d), y.data_ptr(),
        b, c, h, w, co, mode, stream_handle(x)), name)
    return y


def _bf16_plain(conv, x, w_scaled, s, d) -> torch.Tensor:
    """The bf16 datapath's plain version: ``x * s`` and the weight rounded
    to bf16, ``conv`` in float32 on the rounded values, ``d`` in float32,
    the output rounded to ``x``'s dtype."""
    xs = x.float() if s is None else x.float() * s.float()[:, :, None, None]
    y = conv(round_bf16(xs), round_bf16(w_scaled.float()))
    if d is not None:
        y = y * d.float()[:, :, None, None]
    return y.to(x.dtype)


def modconv3x3_plain(x: torch.Tensor, w_scaled: torch.Tensor, s: torch.Tensor,
                     d: torch.Tensor | None) -> torch.Tensor:
    """Plain PyTorch version of the modulated mode: the CPU path and its oracle."""
    if bf16_operands(x):
        return _bf16_plain(lambda a, k: F.conv2d(a, k, padding=1), x, w_scaled, s, d)
    y = F.conv2d(x * s[:, :, None, None], w_scaled, padding=1)
    return y if d is None else y * d[:, :, None, None]


def modconv3x3(x: torch.Tensor, w_scaled: torch.Tensor, s: torch.Tensor,
               d: torch.Tensor | None, *, cache: LayerWeights | None = None) -> torch.Tensor:
    """d * conv3x3(x * s, w_scaled), stride 1, zero padding 1, NCHW.

    x [B, C, H, W] float32 or bf16, w_scaled [Co, C, 3, 3] (the He scale
    already applied), s [B, C], d [B, Co] or None; the output is in x's
    dtype, on the datapath ``ops/precision.py`` picks.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises.
    ``cache``, the layer's :class:`LayerWeights`, keeps the rounded weight
    of the bf16 datapath between calls."""
    _check_3x3("modconv3x3", x, w_scaled)
    if x.device.type == "cpu":
        return modconv3x3_plain(x, w_scaled, s, d)
    if s is None:
        raise ValueError("modconv3x3: s is required (conv3x3 is the plain mode)")
    y = _launch_3x3("modconv3x3", x, w_scaled, s, d, cache)
    _count(modconv3x3, x)
    return y


#: kernel launches since the last reset, on the float32 datapath and on the
#: bf16 one (CPU calls do not count)
modconv3x3.launches = modconv3x3.launches_bf16 = 0


def conv3x3_plain(x: torch.Tensor, w_scaled: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the plain mode: the CPU path and its oracle."""
    if bf16_operands(x):
        return _bf16_plain(lambda a, k: F.conv2d(a, k, padding=1), x, w_scaled, None, None)
    return F.conv2d(x, w_scaled, padding=1)


def conv3x3(x: torch.Tensor, w_scaled: torch.Tensor, *,
            cache: LayerWeights | None = None) -> torch.Tensor:
    """conv3x3(x, w_scaled), stride 1, zero padding 1, NCHW, the output in
    x's dtype: the TPU kernel's own function, with no scale and no
    demodulation.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises.  ``cache`` as for :func:`modconv3x3`."""
    _check_3x3("conv3x3", x, w_scaled)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w_scaled)
    y = _launch_3x3("conv3x3", x, w_scaled, None, None, cache)
    _count(conv3x3, x)
    return y


#: kernel launches since the last reset, by datapath (CPU calls do not count)
conv3x3.launches = conv3x3.launches_bf16 = 0


def upsample_conv_plain(x: torch.Tensor, w_scaled: torch.Tensor,
                        s: torch.Tensor | None = None, d: torch.Tensor | None = None,
                        pad: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the stride-2 mode: the CPU path and its oracle."""
    if bf16_operands(x):
        return _bf16_plain(lambda a, k: F.conv_transpose2d(a, k.transpose(0, 1), stride=2,
                                                           padding=pad),
                           x, w_scaled, s, d)
    xs = x if s is None else x * s[:, :, None, None]
    y = F.conv_transpose2d(xs, w_scaled.transpose(0, 1), stride=2, padding=pad)
    return y if d is None else y * d[:, :, None, None]


#: output channels per block of the stride-2 kernel, by kernel size: N =
#: k^2 * cot columns of taps x channels (144 for k = 3, 128 for k = 4)
UP_COT = {3: 16, 4: 8}
UP_KC = 32            # input channels per stage (a [N][32] weight tile pair)
UP_TILE_M = 128       # pixels per block
UP_MAX_SPT = 32       # whole samples per block at most
# the bf16 datapath's body (csrc/upconv2x_bf16.cuh): N = k^2 * 16 (144 or
# 256), 64 input channels per stage (a [N][64] bf16 weight tile), at most 8
# whole samples and 168 raw elements per channel a stage (runs of 16 bytes)
UP_COT_BF16 = 16
UP_KC_BF16 = 64
UP_MAX_SPT_BF16 = 8
UP_RAW_PIX = 168
UP_PIECE = 8          # bf16 elements of a 16-byte piece


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


def _bf16_raw(spt: int, lr: int, lc: int, hc: int, whole: bool, h: int, w: int) -> int:
    """Raw elements of one channel of a stage of the bf16 body for a tiling,
    each run padded to 16 bytes of bf16: whole samples, one run of h * w per
    sample; else one run per loaded row, of lc, or with a halo column of 7
    more (the run starts on the 16-byte boundary before it)."""
    def pad(n):
        return -(-n // UP_PIECE) * UP_PIECE
    return spt * pad(h * w) if whole else lr * pad(lc + hc * (UP_PIECE - 1))


@functools.lru_cache(maxsize=None)
def upsample_tiling_bf16(b: int, h: int, w: int) -> tuple:
    """The tiling of the stride-2 kernel's bf16 datapath, in the form of
    :func:`upsample_tiling`: at most 128 input pixels and 8 whole samples a
    block, a stage's raw x at most 168 elements per channel
    (:func:`_bf16_raw`), and owned columns a multiple of 8 where a block has
    a halo column (so that its rows start on 16-byte boundaries).  Of the
    tilings that fit, the one with the fewest blocks; among those, one that
    a tensor copy can load (a width divisible by 8, or whole samples of 8k
    pixels), then the fewest raw elements."""
    best = None
    for tr, lr, hr, nr in _axis_tilings(h):
        for tc, lc, hc, nc in _axis_tilings(w):
            if lr * lc > UP_TILE_M or (hc and tc % UP_PIECE):
                continue
            whole = hr == hc == 0
            spt = min(UP_TILE_M // (lr * lc), UP_MAX_SPT_BF16, b) if whole else 1
            raw = _bf16_raw(spt, lr, lc, hc, whole, h, w)
            if raw > UP_RAW_PIX:
                continue
            blocks = -(-b // spt) * nr * nc
            tma = h * w % UP_PIECE == 0 if whole else w % UP_PIECE == 0
            key = (blocks, not tma, blocks * raw)
            if best is None or key < best[0]:
                best = key, (spt, tr, lr, hr, nr, tc, lc, hc, nc)
    return best[1]


def upsample_weight_matrix(w_scaled: torch.Tensor, cot: int | None = None,
                           kc: int = UP_KC) -> torch.Tensor:
    """The stride-2 kernel's B operand of ``w_scaled`` [Co, C, k, k]:
    [n_co, chunks, N, kc] with B[t, q, tap * cot + o, c] = w_scaled[t * cot
    + o, kc q + c, u, v] for tap = u * k + v, zero past Co and C; ``cot``
    output channels per tile (default ``UP_COT[k]``, the 3xTF32 mode's)."""
    co, c, k, _ = w_scaled.shape
    cot = UP_COT[k] if cot is None else cot
    n_co, chunks = -(-co // cot), -(-c // kc)
    wt = w_scaled.permute(2, 3, 0, 1).reshape(k * k, co, c)
    wt = F.pad(wt, (0, chunks * kc - c, 0, n_co * cot - co))
    wt = wt.reshape(k * k, n_co, cot, chunks, kc).permute(1, 3, 0, 2, 4)
    return wt.reshape(n_co, chunks, k * k * cot, kc)


def upsample_weight_image(w_scaled: torch.Tensor) -> torch.Tensor:
    """The weight operand of the stride-2 kernel: :func:`upsample_weight_matrix`
    split into TF32 hi and lo (``ops/tf32x3.split_tf32``), each [N, 32] tile
    in the swizzled layout the kernel's wgmma reads (``sw128_image``):
    [n_co, chunks, 2 (hi, lo), N * 32], contiguous."""
    hi, lo = split_tf32(upsample_weight_matrix(w_scaled).contiguous())
    return sw128_image(torch.stack((hi, lo), dim=2)).contiguous()


def upsample_weight_image_bf16(w_scaled: torch.Tensor) -> torch.Tensor:
    """The weight operand of the stride-2 kernel's bf16 datapath:
    :func:`upsample_weight_matrix` at 16 output channels and 64 input
    channels a tile, rounded to bf16 (to nearest even), each [N, 64] tile in
    the 128-byte swizzle its wgmma reads (``sw128_image``): a bf16 tensor
    [n_co, chunks, N * 64], contiguous."""
    mat = upsample_weight_matrix(w_scaled, UP_COT_BF16, UP_KC_BF16)
    return sw128_image(mat.to(torch.bfloat16).contiguous()).contiguous()


class LayerWeights:
    """One layer's weight as the kernels read it, made when the weight first
    reaches a kernel and again only after it changes (a load, an in-place
    edit or a move changes its storage or its version): the scaled weight
    rounded to bf16 once for the bf16 datapath (the demodulation's operand,
    kernel B's in its :func:`bf16_taps` layout, and the stride-2 kernel's
    :func:`upsample_weight_image_bf16`), and the stride-2 kernel's
    :func:`upsample_weight_image` for the float32 datapath.  They are kept in ``copies``, the layer's
    :class:`~ganspace_tpu_torch.ops.precision.StorageCopies`, by what they
    are, the shape of the ``w_scaled`` they came from and ``tag``, which
    names how that ``w_scaled`` derives from ``source`` where two
    derivations have one shape (:meth:`derived`, :meth:`nearest_up`)."""

    def __init__(self, source: torch.Tensor, copies: StorageCopies | None = None,
                 tag=None):
        self.source = source
        self.copies = StorageCopies() if copies is None else copies
        self.tag = tag

    def derived(self, tag) -> "LayerWeights":
        """The kernels' weights of another derivation of ``source``, named
        by ``tag``, in the same store."""
        return LayerWeights(self.source, self.copies, (self.tag, tag))

    def _get(self, what, w_scaled: torch.Tensor, make) -> torch.Tensor:
        return self.copies(self.source, None, (self.tag, what, tuple(w_scaled.shape)),
                           lambda _: make(w_scaled))

    def rounded(self, w_scaled: torch.Tensor) -> torch.Tensor:
        """``w_scaled``, the scaled form of ``source``, rounded to bf16."""
        return self._get("rounded", w_scaled, round_bf16)

    def in_dtype(self, w_scaled: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``w_scaled``, the scaled form of ``source``, in the activation
        storage ``dtype`` (a stock conv's weight operand)."""
        if dtype == w_scaled.dtype:
            return w_scaled
        return self._get(("dtype", dtype), w_scaled, lambda w: w.to(dtype))

    def taps_bf16(self, w_scaled: torch.Tensor) -> torch.Tensor:
        """:func:`bf16_taps` of ``w_scaled``, the scaled form of ``source``."""
        return self._get("taps_bf16", w_scaled, bf16_taps)

    def get(self, w_scaled: torch.Tensor, bf16: bool = False) -> torch.Tensor:
        """The stride-2 weight image of ``w_scaled``, the scaled form of
        ``source``: :func:`upsample_weight_image`, or with ``bf16``
        :func:`upsample_weight_image_bf16` of its rounded form."""
        if bf16:
            return self._get("image_bf16", w_scaled,
                             lambda w: upsample_weight_image_bf16(self.rounded(w)))
        return self._get("image", w_scaled, upsample_weight_image)

    def nearest_up(self, dtype: torch.dtype, scale: float = 1.0):
        """(:func:`nearest_up_kernel` of ``source * scale`` for the storage
        ``dtype``, the :class:`LayerWeights` of that kernel): the up-conv's
        4x4 composite and its stride-2 weight images, each made once."""
        view = self.derived(("nearest_up", dtype, scale))
        kernel = view._get("kernel", self.source,
                           lambda w: nearest_up_kernel(w * scale, dtype))
        return kernel, view


def _rounded(w_scaled: torch.Tensor, cache: LayerWeights | None) -> torch.Tensor:
    return round_bf16(w_scaled) if cache is None else cache.rounded(w_scaled)


#: The JAX package's space-to-depth tail, on by default there
#: (``ganspace_tpu/ops/s2d.py:55-62``): BigGAN's and ProGAN's up-convs from
#: the first one whose width is at most this many channels (BigGAN: the
#: bottleneck of an up-block after the attention) run in it on the composite
#: kernel, the earlier ones in pixel layout as nearest 2x then the 3x3 conv.
#: Under the preview policy the two round differently (the composite formed
#: in bf16, or the 3x3 weight alone), so the port keeps the split: the
#: models' ``pixel_up`` layers.
S2D_MAX_CH = 64


def nearest_up2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of an NCHW map, in its dtype."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


# Per-axis tap sums of a nearest 2x upsample followed by a 3-tap correlation
# (``ganspace_tpu/ops/s2d.py:_NEAREST_TAPS``): composite tap e of the 4-tap
# kernel sums taps u of the 3-tap one where A[e][u] is 1.
_NEAREST_TAPS = ((1, 0, 0), (1, 1, 0), (0, 1, 1), (0, 0, 1))


def nearest_up_kernel(w: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 4x4 kernel of the stride-2 transposed conv (padding 1) that equals
    nearest 2x upsampling followed by the 3x3 correlation ``w`` (padding 1):
    ``upsample_conv(x, nearest_up_kernel(w), pad=1) == conv2d(up2(x), w, padding=1)``.
    BigGAN's and ProGAN's up-convs run so, on 4/9 of the products.  For a
    bf16 activation storage ``dtype`` it is formed as the JAX package forms
    it there, from the weight cast to x's dtype (``ganspace_tpu/ops/s2d.py:
    370-380``): the composite of the rounded weight, rounded, returned as
    float32 values (the kernels' weight operand)."""
    if dtype != torch.float32:
        return nearest_up_kernel(w.to(dtype).float()).to(dtype).float()
    a = torch.tensor(_NEAREST_TAPS, dtype=w.dtype, device=w.device)
    return torch.einsum("eu,ocuv,fv->ocef", a, w, a).flip(2, 3).contiguous()


def upsample_conv(x: torch.Tensor, w_scaled: torch.Tensor,
                  s: torch.Tensor | None = None, d: torch.Tensor | None = None,
                  *, pad: int = 0, cache: LayerWeights | None = None) -> torch.Tensor:
    """d * conv_transpose2d(x * s, w_scaled^T, stride 2, padding ``pad``),
    NCHW: x [B, C, H, W] float32 or bf16, w_scaled [Co, C, k, k] (k = 3 or
    4, the correlation orientation of a conv weight), s [B, C] or None, d
    [B, Co] or None; the output is [B, Co, 2H + k - 2 - 2 pad, ...] in x's
    dtype, on the datapath ``ops/precision.py`` picks.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises.
    ``cache``, the layer's :class:`LayerWeights`, keeps the weight image
    between calls."""
    b, c, h, w = x.shape
    co, _, k, _ = w_scaled.shape
    if w_scaled.shape != (co, c, k, k) or k not in (3, 4) or pad not in (0, 1):
        raise ValueError(f"upsample_conv: weight {tuple(w_scaled.shape)} with padding "
                         f"{pad} is not a 3x3 or 4x4 kernel over {c} channels")
    if x.device.type == "cpu":
        return upsample_conv_plain(x, w_scaled, s, d, pad)
    ho, wo = 2 * h + k - 2 - 2 * pad, 2 * w + k - 2 - 2 * pad
    mode = datapath_mode(x)
    s = _scale(s)
    _cuda_operands("upsample_conv", x, w_scaled, s, d, b * co * ho * wo)
    x = x.contiguous()
    d = None if d is None else d.contiguous()
    if mode == MODE_F32:
        image = upsample_weight_image(w_scaled) if cache is None else cache.get(w_scaled)
        tiling = upsample_tiling(b, h, w)
    else:
        image = (upsample_weight_image_bf16(round_bf16(w_scaled)) if cache is None
                 else cache.get(w_scaled, bf16=True))
        tiling = upsample_tiling_bf16(b, h, w)
    tiling = (ctypes.c_int * 9)(*tiling)
    y = torch.empty((b, co, ho, wo), dtype=x.dtype, device=x.device)
    check(load_kernels().ganspace_upsample_conv(
        x.data_ptr(), image.data_ptr(), _ptr(s), _ptr(d), y.data_ptr(), ctypes.addressof(tiling),
        b, c, h, w, co, k, pad, mode, stream_handle(x)), "upsample_conv")
    _count(upsample_conv, x)
    return y


#: kernel launches since the last reset, one per call, by datapath (CPU calls
#: do not count)
upsample_conv.launches = upsample_conv.launches_bf16 = 0


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     style_scales: torch.Tensor, *, demodulate: bool = True,
                     upsample: bool = False,
                     blur_kernel: torch.Tensor | None = None,
                     weight_cache: LayerWeights | None = None) -> torch.Tensor:
    """Modulated conv on an NCHW batch.

    Args:
      x: [B, in, H, W] activations.
      weight: [out, in, kh, kw], torch orientation.
      style_scales: [B, in] per-channel modulation from the style affine.
      blur_kernel: 2-D FIR kernel for the upsampling path (gain 1).
      weight_cache: the layer's :class:`LayerWeights` of ``weight``.
    """
    out_ch, in_ch, kh, kw = weight.shape
    w = weight * (1.0 / math.sqrt(in_ch * kh * kw))
    # the style scale in x's storage, as JAX casts it, read by the 3x3 and
    # stride-2 kernels as float32 (exact); the demodulation in float32 from
    # the operands the conv multiplies
    s = style_scales.to(x.dtype)
    if upsample or (kh == 3 and kw == 3) or demodulate:
        sf = s.float()
    d = None
    if demodulate:
        d = demodulation(_rounded(w, weight_cache) if bf16_operands(x) else w, sf)

    if upsample:
        y = upsample_conv(x, w, sf, d, cache=weight_cache)
        # Blur of the transposed-conv path: taps scaled by factor^2 = 4,
        # p = (len - factor) - (k - 1).
        p = (blur_kernel.shape[0] - 2) - (kh - 1)
        return upfirdn2d(y, blur_kernel, pad=((p + 1) // 2 + 1, p // 2 + 1), gain=4.0)
    if kh == 3 and kw == 3:
        return modconv3x3(x, w, sf, d, cache=weight_cache)
    if weight_cache is not None:
        w = weight_cache.in_dtype(w, x.dtype)
    y = precision.conv2d(x * s[:, :, None, None], w, padding=kh // 2)
    return y if d is None else y * d.to(y.dtype)[:, :, None, None]
