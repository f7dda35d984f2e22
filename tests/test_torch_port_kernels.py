"""The port's two kernel modules against the JAX package, on the CPU.

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
    demodulation, modconv3x3, modconv3x3_plain, modulated_conv2d)
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

