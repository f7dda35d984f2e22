"""Why the port's kernels take three TF32 products (``csrc/tf32x3.cuh``).

Both CUDA kernels compute their float32 products on the tensor cores as
3xTF32: hi = tf32(a), lo = tf32(a - hi), and hi*hi + hi*lo + lo*hi with
float32 accumulation.  No kernel runs here: numpy emulates the split (TF32
keeps 10 mantissa bits, rounded to nearest with ties away from zero, as
``cvt.rna.tf32.f32`` does) and each product's float32 accumulation, at the
main path's shapes:

* kernel A, the centered Gram of one fit block, N = 4096, D = 512, with a
  mean offset; bar max|d| <= 1e-5 max|ref| + 1e-4 against the IEEE
  float32 product;
* kernel B as a GEMM with K = 9 * 512, the style-scaled input against the
  He-scaled weight; bar max|d| / max|ref| < 1e-5.

Three passes are within both bars, also on wide-range inputs, and as close
to the exact product as IEEE float32 is; one pass misses both bars.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tf32(a: np.ndarray) -> np.ndarray:
    """Round float32 to TF32: 10 mantissa bits, nearest, ties away from zero."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray):
    hi = tf32(a)
    return hi, tf32(a - hi)


def product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b from TF32 halves, each product accumulated in float32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def gram_operands(wide: bool):
    """X^T and X of one centered 4096 x 512 fit block."""
    rs = np.random.RandomState(0)
    x = rs.randn(4096, 512).astype(np.float32)
    x = x * np.float32(1e3) + np.float32(1e2) if wide else x * np.float32(2) + np.float32(0.5)
    xc = x - x.mean(axis=0, dtype=np.float32)
    return np.ascontiguousarray(xc.T), xc


def conv_operands(wide: bool):
    """Style-scaled im2col rows [M, 9C] and the He-scaled weight [9C, Co]."""
    rs = np.random.RandomState(1)
    c, m, co = 512, 256, 64
    s = (10.0 ** rs.uniform(-2, 2, c) if wide else 1.0 + 0.5 * rs.randn(c)).astype(np.float32)
    x = rs.randn(m, c, 9).astype(np.float32)
    a = (x * s[None, :, None]).reshape(m, 9 * c)
    w = (rs.randn(9 * c, co) / np.sqrt(9 * c)).astype(np.float32)
    return a, w


def gram_error(got, ref):
    """max|d| against kernel A's bar: <= 1 means within it."""
    return float(np.abs(got - ref).max() / (1e-5 * np.abs(ref).max() + 1e-4))


def conv_error(got, ref):
    """max|d| / max|ref| against kernel B's bar of 1e-5: < 1 means within it."""
    return float(np.abs(got - ref).max() / np.abs(ref).max() / 1e-5)


CASES = {"gram": (gram_operands, gram_error), "conv": (conv_operands, conv_error)}


def test_tf32_rounding():
    one = np.float32(1.0)
    assert tf32(np.float32([1 + 2 ** -12]))[0] == one               # below half: down
    assert tf32(np.float32([1 + 2 ** -11]))[0] == one + 2 ** -10    # tie: away from 0
    assert tf32(np.float32([-1 - 2 ** -11]))[0] == -one - 2 ** -10
    a = np.random.RandomState(2).randn(10000).astype(np.float32)
    hi, lo = split(a)
    assert (tf32(hi) == hi).all() and (tf32(lo) == lo).all()
    # hi + lo keeps 22 of float32's 24 significant bits
    assert np.abs((hi.astype(np.float64) + lo - a) / a).max() < 2 ** -21


@pytest.mark.parametrize("wide", [False, True], ids=["main", "wide"])
@pytest.mark.parametrize("kernel", ["gram", "conv"])
def test_three_passes_within_bar(kernel, wide):
    operands, error = CASES[kernel]
    a, b = operands(wide)
    assert error(product(a, b, 3), a @ b) < 0.1       # > 10x inside the bar


@pytest.mark.parametrize("kernel", ["gram", "conv"])
def test_one_pass_misses_bar(kernel):
    operands, error = CASES[kernel]
    a, b = operands(False)
    assert error(product(a, b, 1), a @ b) > 1.0


@pytest.mark.parametrize("kernel", ["gram", "conv"])
def test_three_passes_as_close_to_exact_as_ieee(kernel):
    operands, _ = CASES[kernel]
    a, b = operands(False)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ieee = np.abs(a @ b - exact).max()
    three = np.abs(product(a, b, 3) - exact).max()
    one = np.abs(product(a, b, 1) - exact).max()
    assert three < 4 * ieee
    assert one > 30 * ieee


def test_weight_split_on_the_host_is_the_kernels():
    """``ops/tf32x3.split_tf32``, which splits the stride-2 kernel's weight
    once per layer, rounds as the kernels' in-register split does, bit for
    bit, over magnitudes from 1e-30 to 1e30 and both signs."""
    import torch
    from ganspace_tpu_torch.ops.tf32x3 import split_tf32
    rs = np.random.RandomState(3)
    a = (rs.randn(4096) * 10.0 ** rs.uniform(-30, 30, 4096)).astype(np.float32)
    hi, lo = split_tf32(torch.from_numpy(a))
    want_hi, want_lo = split(a)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
