"""The port's stock-PyTorch layers and its random init against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganspace_tpu.ops import linear as jax_linear
from ganspace_tpu.ops import upfirdn as jax_upfirdn
from ganspace_tpu.models import stylegan2 as jax_sg2

from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.ops import linear, upfirdn


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def test_pixel_norm_and_equal_linear():
    rs = np.random.RandomState(0)
    x = rs.randn(6, 32).astype(np.float32)
    w = rs.randn(24, 32).astype(np.float32)
    b = rs.randn(24).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    assert _rel(linear.pixel_norm(xt), jax_linear.pixel_norm(jnp.asarray(x))) < 1e-6
    for lr_mul in (0.01, 1.0):
        ref = jax_linear.equal_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      lr_mul=lr_mul, gain=1.0)
        assert _rel(linear.equal_linear(xt, wt, bt, lr_mul=lr_mul), ref) < 1e-5


@pytest.mark.parametrize("shape,axis", [((4, 6, 5, 5), 1), ((4, 24), -1)])
def test_fused_leaky_relu(shape, axis):
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(shape[axis]).astype(np.float32)
    ref = jax_linear.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b), channel_axis=axis)
    got = linear.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b),
                                  channel_dim=axis)
    assert _rel(got, ref) < 1e-6


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 2)), (2, 1, (2, 1)),
                                         (1, 2, (1, 1)), (2, 1, (-1, 0))])
def test_upfirdn2d(up, down, pad):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 9, 7).astype(np.float32)
    k_np = np.asarray(jax_upfirdn.make_fir_kernel([1, 3, 3, 1]))
    k_t = upfirdn.make_fir_kernel([1, 3, 3, 1])
    assert np.array_equal(k_t.numpy(), k_np)
    ref = jax_upfirdn.upfirdn2d(jnp.asarray(x), jnp.asarray(k_np), up=up, down=down,
                                pad=pad)
    got = upfirdn.upfirdn2d(torch.from_numpy(x), k_t, up=up, down=down, pad=pad)
    assert tuple(got.shape) == ref.shape
    assert _rel(got, ref) < 1e-5


def test_upsample2x():
    rs = np.random.RandomState(3)
    x = rs.randn(1, 3, 8, 8).astype(np.float32)
    ref = jax_upfirdn.upsample2x(jnp.asarray(x), jax_upfirdn.make_fir_kernel([1, 3, 3, 1]))
    got = upfirdn.upsample2x(torch.from_numpy(x), upfirdn.make_fir_kernel([1, 3, 3, 1]))
    assert tuple(got.shape) == (1, 3, 16, 16)
    assert _rel(got, ref) < 1e-5


def test_init_params_and_noise_bitwise():
    jcfg = jax_sg2.SG2Config(resolution=64, channels=((4, 64), (8, 64), (16, 64),
                                                     (32, 32), (64, 16)))
    tcfg = torch_sg2.SG2Config(resolution=64, channels=jcfg.channels)
    ref, got = jax_sg2.init_params(jcfg, seed=5), torch_sg2.init_params(tcfg, seed=5)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    for a, b in zip(torch_sg2.make_noise(tcfg, 3), jax_sg2.make_noise(jcfg, 3),
                    strict=True):
        assert np.array_equal(a, b)
