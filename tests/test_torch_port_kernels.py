"""The port's kernel modules against the JAX package, on the CPU.

A CPU tensor takes each kernel's plain PyTorch version, so these tests
hold that version (the kernel's oracle on the card) against the Pallas
kernels in interpret mode and against the JAX ops around them.  The
kernels themselves run only on an NVIDIA GPU; their tests are in
``test_torch_port_cuda.py``."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganspace_tpu.ops import s2d
from ganspace_tpu.ops.modconv import modulated_conv2d as jax_modconv
from ganspace_tpu.ops.pallas.blockconv import conv3x3_blocks_pallas
from ganspace_tpu.ops.pallas.moments import centered_gram as jax_centered_gram
from ganspace_tpu.ops.upfirdn import make_fir_kernel as jax_fir

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.ops import precision
from ganspace_tpu_torch.ops.modconv import (
    conv3x3, conv3x3_plain, demodulation, modconv3x3, modconv3x3_plain, modulated_conv2d,
    UP_COT, UP_COT_BF16, UP_KC_BF16, LayerWeights, upsample_conv, upsample_conv_plain,
    upsample_tiling, upsample_tiling_bf16, upsample_weight_image, upsample_weight_image_bf16,
    upsample_weight_matrix)
from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
from ganspace_tpu_torch.ops.tf32x3 import sw128_image, wgmma_tile_bf16
from ganspace_tpu_torch.ops.upfirdn import make_fir_kernel


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# -- kernel A: centered Gram ------------------------------------------------

@pytest.mark.parametrize("n,d,explicit_mu", [
    (512, 256, False), (300, 130, False), (77, 515, False), (256, 128, True)])
def test_centered_gram_matches_pallas(n, d, explicit_mu):
    rs = np.random.RandomState(n + d)
    x = rs.randn(n, d).astype(np.float32)
    mu = rs.randn(d).astype(np.float32) if explicit_mu else None
    ref = np.asarray(jax_centered_gram(
        jnp.asarray(x), None if mu is None else jnp.asarray(mu), interpret=True))
    got = centered_gram(torch.from_numpy(x),
                        None if mu is None else torch.from_numpy(mu)).numpy()
    assert got.shape == (d, d)
    # the bar of tests/test_pallas_moments.py
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max() + 1e-4


# -- kernel B: modulated 3x3 conv -------------------------------------------

def _conv_inputs(b, hw, c, co, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, c, hw, hw).astype(np.float32)
    w = rs.randn(co, c, 3, 3).astype(np.float32)
    s = (1.0 + 0.5 * rs.randn(b, c)).astype(np.float32)
    return x, w, s


# the shapes of tests/test_pallas_blockconv.py, in NCHW
BLOCKCONV_SHAPES = [(2, 16, 8, 8), (1, 16, 32, 16), (1, 8, 64, 64), (2, 8, 4, 12)]


@pytest.mark.parametrize("b,hw,c,co", BLOCKCONV_SHAPES)
def test_modconv3x3_matches_jax_modconv(b, hw, c, co):
    x, w, s = _conv_inputs(b, hw, c, co)
    ref = np.asarray(jax_modconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)))
    got = modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(s)).numpy()
    assert got.shape == (b, co, hw, hw)
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("b,hw,c,co", BLOCKCONV_SHAPES)
def test_modconv3x3_matches_pallas_blockconv(b, hw, c, co):
    """The TPU kernel in interpret mode, with the style scale before it and
    the demodulation after it as ``ops/s2d.py`` applies them."""
    x, w, s = _conv_inputs(b, hw, c, co, seed=1)
    ws = w / math.sqrt(9 * c)
    d = np.asarray(demodulation(torch.from_numpy(ws), torch.from_numpy(s)))
    xb = s2d.nchw_to_blocks(jnp.asarray(x * s[:, :, None, None]))
    y = s2d.blocks_to_nchw(conv3x3_blocks_pallas(xb, jnp.asarray(ws), interpret=True))
    ref = np.asarray(y) * d[:, :, None, None]
    got = modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(s)).numpy()
    assert _rel(got, ref) < 1e-5


def test_modconv3x3_without_demodulation():
    x, w, s = _conv_inputs(2, 8, 16, 24, seed=2)
    ref = np.asarray(jax_modconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                 demodulate=False))
    got = modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(s), demodulate=False).numpy()
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("b,hw,c,co", BLOCKCONV_SHAPES + [(2, 32, 16, 16)])
def test_conv3x3_plain_mode_matches_pallas_blockconv(b, hw, c, co):
    """Kernel B's plain mode is the TPU kernel's own function: its plain
    version against ``conv3x3_blocks_pallas`` in interpret mode on the
    block layout, with no scale and no demodulation around it."""
    x, w, _ = _conv_inputs(b, hw, c, co, seed=6)
    ws = w / math.sqrt(9 * c)
    ref = np.asarray(s2d.blocks_to_nchw(conv3x3_blocks_pallas(
        s2d.nchw_to_blocks(jnp.asarray(x)), jnp.asarray(ws), interpret=True)))
    launches = conv3x3.launches
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(ws)).numpy()
    assert conv3x3.launches == launches              # CPU: the plain version
    assert got.shape == (b, co, hw, hw)
    assert _rel(got, ref) < 1e-5


def _unswizzle(image, n):
    """The [..., N, K] tiles of a swizzled weight image (K values in 128
    bytes; the swizzle is its own inverse)."""
    tiles = image.reshape(*image.shape[:-1], n, 128 // image.element_size())
    return sw128_image(tiles).reshape(tiles.shape)


def _emulate_upsample(x, w, s, d, pad, image, bf16=False):
    """The stride-2 kernel in plain torch: per block of
    :func:`upsample_tiling`, the dense product of its loaded pixels (x * s,
    zero outside the image) with the split weight read back from ``image``
    (hi + lo), then the overlap-add into the block's own output rectangle in
    the kernel's tap order (u, then v, ascending).  With ``bf16``, the bf16
    datapath's body: the blocks of :func:`upsample_tiling_bf16`, x * s
    rounded to bf16, the weight read back from its bf16 image.  Also
    returns how many blocks wrote each output."""
    b, c, h, wd = x.shape
    co, _, k, _ = w.shape
    cot = UP_COT_BF16 if bf16 else UP_COT[k]
    n = k * k * cot
    ho, wo = 2 * h + k - 2 - 2 * pad, 2 * wd + k - 2 - 2 * pad
    tiles = _unswizzle(image, n)
    if bf16:                                              # [n_co, chunks, N, 64]
        bmat = tiles.double()
    else:                                                 # [n_co, chunks, 2, N, 32]
        bmat = (tiles[:, :, 0].double() + tiles[:, :, 1].double())
    bmat = bmat.permute(0, 2, 1, 3).reshape(bmat.shape[0], n, -1)   # [n_co, N, K]
    xs = x if s is None else x * s[:, :, None, None]
    xs = (precision.round_bf16(xs) if bf16 else xs).double()
    tiling = upsample_tiling_bf16 if bf16 else upsample_tiling
    spt, tr, lr, hr, nr, tc, lc, hc, nc = tiling(b, h, wd)
    y = torch.zeros(b, co, ho, wo, dtype=torch.float64)
    written = torch.zeros(b, co, ho, wo, dtype=torch.int64)
    for b0 in range(0, b, spt):
        for i0 in range(0, h, tr):
            for j0 in range(0, wd, tc):
                ilo, jlo = i0 - hr, j0 - hc
                a = torch.zeros(spt, bmat.shape[-1], lr, lc, dtype=torch.float64)
                for sb in range(min(spt, b - b0)):
                    for r in range(lr):
                        if 0 <= ilo + r < h:
                            lo_c, hi_c = max(0, -jlo), min(lc, wd - jlo)
                            a[sb, :c, r, lo_c:hi_c] = xs[b0 + sb, :, ilo + r,
                                                         jlo + lo_c:jlo + hi_c]
                y0 = 0 if i0 == 0 else 2 * i0 - pad
                y1 = ho if i0 + tr >= h else 2 * (i0 + tr) - pad
                x0 = 0 if j0 == 0 else 2 * j0 - pad
                x1 = wo if j0 + tc >= wd else 2 * (j0 + tc) - pad
                for ct in range(bmat.shape[0]):
                    p = torch.einsum("scij,nc->sijn", a, bmat[ct])
                    out = torch.zeros(spt, ho, wo, cot, dtype=torch.float64)[:, y0:y1, x0:x1]
                    ys, xs_ = torch.arange(y0, y1), torch.arange(x0, x1)
                    for u in range(k):
                        iy = ys + pad - u
                        vy = (iy >= 0) & (iy % 2 == 0) & (iy // 2 < h)
                        r = torch.where(vy, iy // 2 - ilo, 0)
                        assert ((r >= 0) & (r < lr)).all()
                        for v in range(k):
                            jx = xs_ + pad - v
                            vx = (jx >= 0) & (jx % 2 == 0) & (jx // 2 < wd)
                            q = torch.where(vx, jx // 2 - jlo, 0)
                            assert ((q >= 0) & (q < lc)).all()
                            tap = p[:, r][:, :, q][..., (u * k + v) * cot:(u * k + v + 1) * cot]
                            out = out + tap * (vy[:, None] & vx[None, :])[None, :, :, None]
                    nb, no = min(spt, b - b0), min(cot, co - ct * cot)
                    y[b0:b0 + nb, ct * cot:ct * cot + no, y0:y1, x0:x1] = \
                        out[:nb, :, :, :no].permute(0, 3, 1, 2)
                    written[b0:b0 + nb, ct * cot:ct * cot + no, y0:y1, x0:x1] += 1
    if d is not None:
        y = y * d[:, :, None, None].double()
    return y, written


# (k, pad, C, Co, B, H, W): whole-sample blocks (4x4 and 8x8 maps, a last
# partial block), halo rectangles, C off 8 and above one 32-channel stage,
# Co off the 16- and 8-channel tiles
UP_EMULATION = [(3, 0, 16, 20, 9, 4, 4), (3, 0, 5, 6, 2, 13, 20), (3, 1, 40, 16, 3, 8, 8),
                (3, 1, 12, 3, 1, 17, 11), (4, 1, 16, 12, 2, 12, 12), (4, 1, 12, 8, 3, 5, 7),
                (4, 0, 40, 9, 1, 16, 16), (4, 0, 8, 24, 4, 3, 9)]


@pytest.mark.parametrize("k,pad,c,co,b,h,w", UP_EMULATION)
def test_upsample_emulation_matches_the_transposed_conv(k, pad, c, co, b, h, w):
    """What the stride-2 kernel computes from its weight operand, emulated
    block by block: every output written by exactly one block, and equal to
    the plain version, with s and d."""
    rs = np.random.RandomState(k + c + h)
    x = torch.from_numpy(rs.randn(b, c, h, w).astype(np.float32))
    wt = torch.from_numpy(rs.randn(co, c, k, k).astype(np.float32)) / (k * k * c) ** 0.5
    s = torch.from_numpy((1.0 + 0.5 * rs.randn(b, c)).astype(np.float32))
    d = demodulation(wt, s)
    got, written = _emulate_upsample(x, wt, s, d, pad, upsample_weight_image(wt))
    assert (written == 1).all()
    ref = upsample_conv_plain(x, wt, s, d, pad=pad)
    assert got.shape == ref.shape
    assert _rel(got.float().numpy(), ref.numpy()) < 1e-5


@pytest.mark.parametrize("k,pad,c,co,b,h,w", UP_EMULATION)
def test_upsample_bf16_emulation_matches_the_plain_version(k, pad, c, co, b, h, w):
    """What the bf16 datapath's body computes from its bf16 weight image,
    emulated block by block over its own tiling: every output written by
    exactly one block, and equal to the plain version under the preview
    policy (x * s and the weight rounded to bf16, float32 sums), with s and
    d."""
    rs = np.random.RandomState(k + c + h + 1)
    x = torch.from_numpy(rs.randn(b, c, h, w).astype(np.float32))
    wt = torch.from_numpy(rs.randn(co, c, k, k).astype(np.float32)) / (k * k * c) ** 0.5
    s = torch.from_numpy((1.0 + 0.5 * rs.randn(b, c)).astype(np.float32))
    d = demodulation(precision.round_bf16(wt), s)
    image = upsample_weight_image_bf16(precision.round_bf16(wt))
    got, written = _emulate_upsample(x, wt, s, d, pad, image, bf16=True)
    assert (written == 1).all()
    with precision.precision("default"):
        ref = upsample_conv_plain(x, wt, s, d, pad=pad)
    assert got.shape == ref.shape
    assert _rel(got.float().numpy(), ref.numpy()) < 1e-5


@pytest.mark.parametrize("k,c", [(3, 8), (3, 13), (4, 8), (4, 13)])
def test_upsample_weight_image_is_the_split_weight(k, c):
    """The cached operand: hi and lo are TF32 (13 low bits clear), hi + lo is
    the weight to float32 rounding, in the [tile, chunk, tap * cot + o, c]
    order, zero past C and Co, each [N, 32] tile swizzled."""
    rs = np.random.RandomState(k * c)
    co = 11
    wt = torch.from_numpy(rs.randn(co, c, k, k).astype(np.float32))
    image = upsample_weight_image(wt)
    cot, n = UP_COT[k], k * k * UP_COT[k]
    assert image.shape == (-(-co // cot), 1, 2, n * 32) and image.is_contiguous()
    tiles = _unswizzle(image, n)
    hi, lo = tiles[:, :, 0], tiles[:, :, 1]
    for half in (hi, lo):
        assert not (half.contiguous().view(torch.int32) & 0x1FFF).any()
    mat = upsample_weight_matrix(wt)
    # within one float32 unit of each weight: lo keeps 11 of the 13 bits hi drops
    assert ((hi + lo - mat).abs() <= 2.0 ** -22 * mat.abs()).all()
    assert ((mat - hi).abs() <= 2.0 ** -11 * mat.abs()).all()
    for u in range(k):
        for v in range(k):
            tap = mat[:, 0, (u * k + v) * cot:(u * k + v + 1) * cot].reshape(-1, 32)
            assert torch.equal(tap[:co, :c], wt[:, :, u, v])
            assert not tap[co:].any() and not tap[:, c:].any()


@pytest.mark.parametrize("k,c", [(3, 8), (3, 70), (4, 13), (4, 64)])
def test_upsample_weight_image_bf16_is_the_rounded_weight(k, c):
    """The bf16 datapath's operand: a bf16 image, un-swizzled equal to the
    weight rounded to bf16 in the [tile, chunk, tap * 16 + o, c] order of 16
    output and 64 input channels a tile, zero past C and Co."""
    rs = np.random.RandomState(k * c + 1)
    co = 19
    wt = torch.from_numpy(rs.randn(co, c, k, k).astype(np.float32))
    image = upsample_weight_image_bf16(wt)
    n, chunks = k * k * UP_COT_BF16, -(-c // UP_KC_BF16)
    assert image.dtype == torch.bfloat16 and image.is_contiguous()
    assert image.shape == (-(-co // UP_COT_BF16), chunks, n * UP_KC_BF16)
    tiles = _unswizzle(image, n)
    mat = upsample_weight_matrix(wt, UP_COT_BF16, UP_KC_BF16)
    assert torch.equal(tiles, precision.round_bf16(mat).to(torch.bfloat16))
    flat = tiles.float().permute(0, 2, 1, 3).reshape(tiles.shape[0], n, -1)   # [n_co, N, K]
    for u in range(k):
        for v in range(k):
            tap = flat[:, (u * k + v) * UP_COT_BF16:(u * k + v + 1) * UP_COT_BF16]
            tap = tap.reshape(-1, flat.shape[-1])
            assert torch.equal(tap[:co, :c], precision.round_bf16(wt[:, :, u, v]))
            assert not tap[co:].any() and not tap[:, c:].any()


def test_wgmma_tile_bf16_plain_is_the_rounded_product():
    """The bf16 wgmma step's plain version (its CPU path and oracle on the
    card): the product of the operands rounded to bf16, float32 sums."""
    rs = np.random.RandomState(12)
    a = torch.from_numpy(rs.randn(64, 64).astype(np.float32))
    b = torch.from_numpy(rs.randn(144, 64).astype(np.float32))
    ref = (precision.round_bf16(a).double() @ precision.round_bf16(b).double().T).float()
    got = wgmma_tile_bf16(a, b)
    assert got.shape == (64, 144)
    assert np.abs(got.numpy() - ref.numpy()).max() <= 1e-5 * np.abs(ref.numpy()).max()
    with pytest.raises(ValueError):
        wgmma_tile_bf16(a, b[:100])


def test_upsample_weights_rebuilt_only_for_a_new_weight():
    """A layer's split weight is built again only when its weight changes:
    an in-place edit (a load) bumps the version, a move the storage."""
    rs = np.random.RandomState(8)
    weight = torch.nn.Parameter(torch.from_numpy(rs.randn(6, 16, 3, 3).astype(np.float32)))
    cache = LayerWeights(weight)
    first = cache.get(weight * 0.5)
    assert torch.equal(first, upsample_weight_image(weight * 0.5))
    assert cache.get(weight * 0.5) is first
    with torch.no_grad():
        weight.mul_(2.0)
    again = cache.get(weight * 0.5)
    assert again is not first and torch.equal(again, upsample_weight_image(weight * 0.5))
    weight.data = weight.data.clone()
    assert cache.get(weight * 0.5) is not again


def test_layer_weights_round_once_for_the_bf16_datapath():
    """The bf16 datapath's weight is rounded once per layer and weight: kernel
    B's operand, the demodulation's, and the stride-2 image's source."""
    rs = np.random.RandomState(9)
    weight = torch.nn.Parameter(torch.from_numpy(rs.randn(6, 16, 3, 3).astype(np.float32)))
    cache = LayerWeights(weight)
    first = cache.rounded(weight * 0.5)
    assert torch.equal(first, precision.round_bf16(weight * 0.5))
    assert cache.rounded(weight * 0.5) is first
    image = cache.get(weight * 0.5, bf16=True)
    assert torch.equal(image, upsample_weight_image_bf16(first)) and image.dtype == torch.bfloat16
    assert cache.get(weight * 0.5, bf16=True) is image
    with torch.no_grad():
        weight.mul_(3.0)
    again = cache.rounded(weight * 0.5)
    assert again is not first and torch.equal(again, precision.round_bf16(weight * 0.5))
    x = torch.from_numpy(rs.randn(2, 16, 8, 8).astype(np.float32))
    s = torch.from_numpy((1.0 + 0.5 * rs.randn(2, 16)).astype(np.float32))
    layer = LayerWeights(weight)            # a layer's cache, at the conv's own scale
    with precision.precision("default"):
        ref = modulated_conv2d(x, weight, s)
        for _ in range(2):
            assert torch.equal(modulated_conv2d(x, weight, s, weight_cache=layer), ref)


# (B, H, W, whole-sample blocks expected): the conv-tap path's 4 and 8 px
# inputs at batch 128 and the render's and StyleGAN's maps at batch 5, then
# BigGAN-512's up-convs (4 -> 8 ... 256 -> 512 px) at the render's batch and
# its shape annotation's batch-1 probe
UP_TILINGS = [(128, 4, 4, 8), (128, 8, 8, 2), (5, 4, 4, 5), (5, 16, 16, 0), (5, 64, 64, 0),
              (16, 128, 128, 0), (5, 512, 512, 0),
              (5, 8, 8, 2), (5, 32, 32, 0), (5, 128, 128, 0), (5, 256, 256, 0), (1, 4, 4, 1)]


@pytest.mark.parametrize("b,h,w,spt", UP_TILINGS)
def test_upsample_tiling_of_the_paths_shapes(b, h, w, spt):
    """Whole samples where a sample fits 128 pixels (no halo, x read once);
    else rectangles with one halo row and column that cover every input
    pixel once as their own."""
    got = upsample_tiling(b, h, w)
    g_spt, tr, lr, hr, nr, tc, lc, hc, nc = got
    assert lr * lc * g_spt <= 128 and lr == tr + hr and lc == tc + hc
    if spt:
        assert (g_spt, hr, hc, nr, nc) == (spt, 0, 0, 1, 1)
    else:
        assert g_spt == 1 and nr == -(-h // tr) and nc == -(-w // tc)
        # no more than 1.6x the input's pixels are loaded
        assert nr * nc * lr * lc <= 1.6 * h * w


@pytest.mark.parametrize("b,h,w,spt", UP_TILINGS + [(1, 3, 3, 1), (2, 13, 13, 0), (2, 9, 40, 0)])
def test_upsample_tiling_bf16_of_the_paths_shapes(b, h, w, spt):
    """The bf16 body's tiling: whole samples where a sample fits 128 pixels
    (at most 8 a block); else rectangles with one halo row and column, their
    owned columns a multiple of 8 where there is a halo column, a stage's
    raw x within 168 elements per channel, every input pixel owned once."""
    from ganspace_tpu_torch.ops.modconv import UP_MAX_SPT_BF16, UP_RAW_PIX, _bf16_raw
    got = upsample_tiling_bf16(b, h, w)
    g_spt, tr, lr, hr, nr, tc, lc, hc, nc = got
    assert lr * lc * g_spt <= 128 and lr == tr + hr and lc == tc + hc
    assert (hr == 1 or tr == h) and (hc == 1 or tc == w)
    assert _bf16_raw(g_spt, lr, lc, hc, hr == hc == 0, h, w) <= UP_RAW_PIX
    assert hc == 0 or tc % 8 == 0
    if spt:
        assert (g_spt, hr, hc, nr, nc) == (min(spt, UP_MAX_SPT_BF16), 0, 0, 1, 1)
    else:
        assert g_spt == 1 and nr == -(-h // tr) and nc == -(-w // tc)
        # no more than 1.7x the input's pixels are loaded
        assert nr * nc * lr * lc <= 1.7 * h * w


def test_upsample_conv_matches_jax_stylegan2_formulation():
    """The stride-2 twin against the JAX package's transposed conv of
    StyleGAN2's upsampling StyledConv (``ops/modconv.py``), with s and d."""
    from ganspace_tpu.ops.modconv import _shared_conv_transpose2x
    x, w, s = _conv_inputs(2, 8, 16, 12, seed=7)
    ws = w / math.sqrt(9 * 16)
    d = demodulation(torch.from_numpy(ws), torch.from_numpy(s)).numpy()
    ref = np.asarray(_shared_conv_transpose2x(jnp.asarray(x * s[:, :, None, None]),
                                              jnp.asarray(ws))) * d[:, :, None, None]
    launches = upsample_conv.launches
    got = upsample_conv(torch.from_numpy(x), torch.from_numpy(ws), torch.from_numpy(s),
                        torch.from_numpy(d)).numpy()
    assert upsample_conv.launches == launches
    assert got.shape == ref.shape == (2, 12, 17, 17)
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("b,c,co,hw", [(2, 16, 8, 8), (1, 8, 16, 5)])
def test_upsample_conv_matches_jax_stylegan_fused_conv0_up(b, c, co, hw):
    """StyleGAN's fused ``conv0_up`` (the 3x3 kernel summed into 4x4, a
    stride-2 transposed conv with padding 1, the [1, 2, 1] blur, the bias)
    through the port's stride-2 mode against the JAX package's
    ``_my_conv2d``."""
    from ganspace_tpu.models.stylegan import _my_conv2d
    from ganspace_tpu_torch.models.stylegan import UpBlock, _blur121, blur121_kernel
    rs = np.random.RandomState(b + c + co)
    x = rs.randn(b, c, hw, hw).astype(np.float32)
    w = rs.randn(co, c, 3, 3).astype(np.float32)
    bias = rs.randn(co).astype(np.float32)
    ref, _ = _my_conv2d({"u.weight": jnp.asarray(w), "u.bias": jnp.asarray(bias)}, "u",
                        jnp.asarray(x), upscale=True, blur_after=True, fused_ok=True)
    block = UpBlock(c, co, 512, res=128)
    block.conv0_up.weight.copy_(torch.from_numpy(w))
    block.conv0_up.bias.copy_(torch.from_numpy(bias))
    got = block.conv0_up.add_bias(
        _blur121(block.upconv(torch.from_numpy(x)), blur121_kernel())).numpy()
    assert got.shape == np.asarray(ref).shape == (b, co, 2 * hw, 2 * hw)
    assert _rel(got, np.asarray(ref)) < 1e-5


@pytest.mark.parametrize("k,upsample,demodulate", [
    (3, True, True),     # StyledConv upsampling path: transposed conv + blur
    (1, False, False),   # to_rgb path
])
def test_modconv_stock_paths_match_jax(k, upsample, demodulate):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 16, 8, 8).astype(np.float32)
    w = rs.randn(12, 16, k, k).astype(np.float32)
    s = (1.0 + 0.5 * rs.randn(2, 16)).astype(np.float32)
    ref = np.asarray(jax_modconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                 demodulate=demodulate, upsample=upsample,
                                 blur_kernel=jax_fir([1, 3, 3, 1])))
    got = modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(s), demodulate=demodulate,
                           upsample=upsample,
                           blur_kernel=make_fir_kernel([1, 3, 3, 1])).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-5


# -- no fallback ---------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(64, 32).astype(np.float32))
    a0 = centered_gram.launches
    assert torch.equal(centered_gram(x), centered_gram_plain(x))
    xc, w, s = (torch.from_numpy(a) for a in _conv_inputs(1, 8, 8, 8, seed=5))
    d = demodulation(w, s)
    b0 = modconv3x3.launches
    assert torch.equal(modconv3x3(xc, w, s, d), modconv3x3_plain(xc, w, s, d))
    assert (centered_gram.launches, modconv3x3.launches) == (a0, b0)


def test_require_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        require_device("cuda")
    assert require_device("cpu").type == "cpu"


def test_kernels_reject_bad_operands():
    with pytest.raises(ValueError):
        centered_gram(torch.zeros(4, 4, 4))
    x, w, s = (torch.from_numpy(a) for a in _conv_inputs(1, 8, 8, 8))
    with pytest.raises(ValueError):
        modconv3x3(x, w[:, :4], s, None)
    with pytest.raises(ValueError):
        conv3x3(x, w[:, :4])
    with pytest.raises(ValueError):
        upsample_conv(x, torch.zeros(8, 8, 5, 5))

