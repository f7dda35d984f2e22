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
from ganspace_tpu_torch.ops.modconv import (
    conv3x3, conv3x3_plain, demodulation, modconv3x3, modconv3x3_plain, modulated_conv2d,
    PhaseWeights, phase_weight, phase_weights, upsample_conv, upsample_conv_plain,
    upsample_phases)
from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
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


@pytest.mark.parametrize("k,pad,c", [(3, 0, 16), (3, 0, 5), (4, 1, 16), (4, 1, 12)])
def test_upsample_phases_reassemble_the_transposed_conv(k, pad, c):
    """The geometry the stride-2 kernel is given: each phase's gathered taps
    (in the kernel's [Co, C/8, taps, 8] layout, zero past channel C) as a
    stride-1 correlation over the window the kernel reads, written
    interleaved, is the transposed conv."""
    import torch.nn.functional as F
    rs = np.random.RandomState(k + c)
    x = torch.from_numpy(rs.randn(2, c, 5, 7))
    w = torch.from_numpy(rs.randn(6, c, k, k))
    ref = upsample_conv_plain(x, w, pad=pad)
    got = torch.full_like(ref, float("nan"))
    flat, offset = phase_weights(w, pad), 0     # the kernel's weight operand
    for py, px, uy, ux, dy, dx, oh, ow in upsample_phases(k, pad, 5, 7):
        wp = phase_weight(w, uy, ux)
        assert wp.shape == (6, -(-c // 8), len(uy) * len(ux), 8) and wp.is_contiguous()
        assert torch.equal(flat[offset:offset + wp.numel()], wp.reshape(-1))
        offset += wp.numel()
        win = wp.transpose(2, 3).reshape(6, -1, len(uy), len(ux))
        assert not win[:, c:].any()
        xp = F.pad(x, (1, 2, 1, 2))            # row m - 1 + dy + a of x
        got[:, :, py::2, px::2] = F.conv2d(xp[:, :, dy:, dx:], win[:, :c])[:, :, :oh, :ow]
    assert offset == flat.numel()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_phase_weights_gathered_once_per_weight():
    """A layer's phase weights are gathered again only when its weight
    changes: an in-place edit (a load) bumps the version, a move the
    storage."""
    rs = np.random.RandomState(8)
    weight = torch.nn.Parameter(torch.from_numpy(rs.randn(6, 16, 3, 3).astype(np.float32)))
    cache = PhaseWeights(weight)
    first = cache.get(weight * 0.5, 0)
    assert torch.equal(first, phase_weights(weight * 0.5, 0))
    assert cache.get(weight * 0.5, 0) is first
    with torch.no_grad():
        weight.mul_(2.0)
    again = cache.get(weight * 0.5, 0)
    assert again is not first and torch.equal(again, phase_weights(weight * 0.5, 0))
    weight.data = weight.data.clone()
    assert cache.get(weight * 0.5, 0) is not again


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

