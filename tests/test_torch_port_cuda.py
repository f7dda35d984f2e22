"""The port's CUDA kernels on the card.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  The
file imports no jax (the GPU machine has none), so run it there without
the suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda -q
"""

import pytest
import torch

from ganspace_tpu_torch.ops.modconv import (
    conv3x3, conv3x3_plain, demodulation, modconv3x3, modconv3x3_plain, modulated_conv2d,
    upsample_conv, upsample_conv_plain)
from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
from ganspace_tpu_torch.ops.precision import ieee_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n,d,explicit_mu", [(4096, 512, False), (1000, 300, False),
                                             (77, 515, False), (256, 128, True)])
def test_centered_gram_on_card(gen, n, d, explicit_mu):
    x = torch.randn(n, d, generator=gen, device="cuda") + 1.0
    mu = torch.randn(d, generator=gen, device="cuda") if explicit_mu else None
    launches = centered_gram.launches
    with ieee_f32():
        got, ref = centered_gram(x, mu), centered_gram_plain(x, mu)
    assert centered_gram.launches == launches + 1
    assert torch.equal(got, got.T)                     # mirrored tiles
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-4


# the nine plain 3x3 convs of a 1024-px forward at the render's batch of 5
# (4-32 px take the cluster split of K)
RENDER_SHAPES = [(5, c, c, r, r) for c, r in [
    (512, 4), (512, 8), (512, 16), (512, 32), (512, 64), (256, 128), (128, 256),
    (64, 512), (32, 1024)]]
# channel counts off the 8-channel stage and the 64-channel tile, maps off
# the power-of-two pixel tiles, C % 4 != 0 (4-byte weight copies)
RAGGED_SHAPES = [(2, 48, 40, 37, 23), (3, 24, 36, 5, 7), (1, 520, 72, 6, 6),
                 (4, 17, 33, 9, 2)]


@pytest.mark.parametrize("b,c,co,h,w", [(2, 512, 512, 4, 4), (2, 40, 48, 19, 33),
                                        (1, 32, 32, 64, 64), (3, 64, 3, 16, 16)]
                         + RENDER_SHAPES + RAGGED_SHAPES)
def test_modconv3x3_on_card(gen, b, c, co, h, w):
    x = torch.randn(b, c, h, w, generator=gen, device="cuda")
    wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    s = 1.0 + 0.5 * torch.randn(b, c, generator=gen, device="cuda")
    launches = modconv3x3.launches
    with ieee_f32():
        for d in (demodulation(wt, s), None):
            got, ref = modconv3x3(x, wt, s, d), modconv3x3_plain(x, wt, s, d)
            assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
    assert modconv3x3.launches == launches + 2


# StyleGAN-1024's ten 3x3 shapes (4 px to 1024 px, 512 to 16 channels) at
# batch 2, plus ragged ones: Co <= 16 takes the 16-channel tile
SG1_SHAPES = [(2, c, co, r, r) for c, co, r in [
    (512, 512, 4), (512, 512, 8), (512, 512, 16), (512, 512, 32), (512, 256, 64),
    (256, 256, 64), (128, 128, 128), (64, 64, 256), (32, 32, 512), (16, 16, 1024)]]


@pytest.mark.parametrize("b,c,co,h,w", SG1_SHAPES + [(3, 20, 16, 9, 13), (2, 16, 7, 5, 5)])
def test_conv3x3_plain_mode_on_card(gen, b, c, co, h, w):
    x = torch.randn(b, c, h, w, generator=gen, device="cuda")
    wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    launches = conv3x3.launches
    with ieee_f32():
        got, ref = conv3x3(x, wt), conv3x3_plain(x, wt)
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
        assert torch.equal(got, conv3x3(x, wt))
    assert conv3x3.launches == launches + 2


# (b, c, co, h, w, k, pad): StyleGAN2's tap and render upsampling convs
# (k = 3, pad 0), StyleGAN's fused conv0_up (k = 4, pad 1), and ragged ones
UP_SHAPES = [(8, 512, 512, 4, 4, 3, 0), (8, 512, 512, 8, 8, 3, 0),
             (2, 256, 128, 64, 64, 3, 0), (2, 64, 32, 256, 256, 3, 0),
             (2, 256, 128, 64, 64, 4, 1), (2, 32, 16, 512, 512, 4, 1),
             (3, 20, 24, 5, 7, 3, 0), (2, 12, 16, 6, 3, 4, 1), (1, 8, 3, 9, 9, 3, 0)]


@pytest.mark.parametrize("b,c,co,h,w,k,pad", UP_SHAPES)
def test_upsample_conv_on_card(gen, b, c, co, h, w, k, pad):
    x = torch.randn(b, c, h, w, generator=gen, device="cuda")
    wt = torch.randn(co, c, k, k, generator=gen, device="cuda") / (k * k * c) ** 0.5
    s = 10.0 ** (2.0 * torch.rand(b, c, generator=gen, device="cuda") - 1.0)
    launches = upsample_conv.launches
    with ieee_f32():
        for ss, d in ((s, demodulation(wt, s)), (None, None)):
            got = upsample_conv(x, wt, ss, d, pad=pad)
            ref = upsample_conv_plain(x, wt, ss, d, pad=pad)
            assert got.shape == ref.shape == (b, co, 2 * h + k - 2 - 2 * pad,
                                              2 * w + k - 2 - 2 * pad)
            assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
            assert torch.equal(got, upsample_conv(x, wt, ss, d, pad=pad))
    assert upsample_conv.launches == launches + 4          # four calls, one launch each


def test_cuda_operands_never_fall_back(gen):
    """On the card a wrapper launches its kernel or raises."""
    x = torch.randn(64, 32, generator=gen, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        centered_gram(x)
    xc = torch.randn(1, 8, 8, 8, generator=gen, device="cuda")
    w = torch.randn(8, 8, 3, 3, generator=gen, device="cuda")
    with pytest.raises(TypeError):
        modconv3x3(xc, w, torch.ones(1, 8, dtype=torch.float64, device="cuda"), None)
    launches = modconv3x3.launches
    modulated_conv2d(xc, w, torch.ones(1, 8, device="cuda"))
    assert modconv3x3.launches == launches + 1


# -- the 3xTF32 tensor-core kernels ------------------------------------------

def test_tf32x3_tile_on_card(gen):
    from ganspace_tpu_torch.ops.tf32x3 import tile_3xtf32
    a = torch.randn(16, 8, generator=gen, device="cuda")
    b = torch.randn(8, 8, generator=gen, device="cuda")
    ref = a.double() @ b.double().T
    got = tile_3xtf32(a, b).double()
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


@pytest.mark.parametrize("n", [144, 128])
def test_wgmma_tile_on_card(gen, n):
    """The stride-2 kernel's wgmma step: register A, swizzled B."""
    from ganspace_tpu_torch.ops.tf32x3 import wgmma_tile_3xtf32
    a = torch.randn(64, 32, generator=gen, device="cuda")
    b = torch.randn(n, 32, generator=gen, device="cuda")
    ref = a.double() @ b.double().T
    got = wgmma_tile_3xtf32(a, b).double()
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


@pytest.mark.parametrize("res", [8, 64])
def test_modconv3x3_wide_range_and_deterministic_on_card(gen, res):
    """|s| from 1e-2 to 1e2; 8 px takes the cluster split of K."""
    x = torch.randn(5, 512, res, res, generator=gen, device="cuda")
    wt = torch.randn(512, 512, 3, 3, generator=gen, device="cuda") / (9 * 512) ** 0.5
    s = 10.0 ** (4.0 * torch.rand(5, 512, generator=gen, device="cuda") - 2.0)
    with ieee_f32():
        d = demodulation(wt, s)
        got, ref = modconv3x3(x, wt, s, d), modconv3x3_plain(x, wt, s, d)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
    assert torch.equal(got, modconv3x3(x, wt, s, d))   # no atomics


@pytest.mark.parametrize("n,d", [(4096, 512), (300, 130), (77, 515), (5000, 64)])
def test_centered_gram_wide_range_and_deterministic_on_card(gen, n, d):
    """1e3 randn + 1e2; N split across a cluster where the grid is small."""
    x = torch.randn(n, d, generator=gen, device="cuda") * 1e3 + 1e2
    with ieee_f32():
        got, ref = centered_gram(x), centered_gram_plain(x)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-4
    assert torch.equal(got, centered_gram(x))


@pytest.mark.parametrize("n", [5120, 65536])
def test_centered_gram_fused_w_blocks_on_card(gen, n):
    """The fused W stream's blocks (n = 40960 and n = 1M runs): the wrapper
    launches the kernel at both, and it meets the bar against the plain
    version with the block mean given, as the moments update passes it."""
    x = torch.randn(n, 512, generator=gen, device="cuda") * 2.0 + 0.5
    mu = x.mean(dim=0)
    launches = centered_gram.launches
    with ieee_f32():
        got, ref = centered_gram(x, mu), centered_gram_plain(x, mu)
    assert centered_gram.launches == launches + 1
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-4
    assert torch.equal(got, centered_gram(x, mu))


# -- the device streams (Philox on the card) ---------------------------------

def test_philox_blocks_depend_on_their_index_alone(gen):
    """Block i drawn alone equals block i drawn after blocks 0..i-1; the four
    streams differ; the draws are standard normal; the baseline directions
    are unit rows and repeat."""
    from ganspace_tpu_torch import sampling

    def draw(stream, i):
        g = sampling.block_generator(1, stream, i, "cuda")
        assert g.device.type == "cuda"
        return sampling.device_gaussian(g, 1024, 512)
    seq = [draw(sampling.STREAM_MAIN, i) for i in range(5)]
    assert torch.equal(draw(sampling.STREAM_MAIN, 3), seq[3])
    assert not torch.equal(seq[0], seq[1])
    for stream in (sampling.STREAM_W_TAIL, sampling.STREAM_LINREG,
                   sampling.STREAM_RAND_DIRS):
        assert not torch.equal(draw(stream, 0), seq[0])
    assert abs(float(seq[0].mean())) < 0.01 and abs(float(seq[0].std()) - 1.0) < 0.01
    dirs = sampling.random_directions_device(80, 131072, "cuda")
    assert dirs.device.type == "cuda"
    assert torch.equal(dirs, sampling.random_directions_device(80, 131072, "cuda"))
    assert float((dirs.norm(dim=1) - 1.0).abs().max()) < 1e-5


def test_device_streams_agree_on_card(gen):
    """On a small StyleGAN2 on the card, the pre-sampled device stream and
    the fused activation stream draw the same latents for block i, whatever
    the number of blocks asked for."""
    from ganspace_tpu_torch.decomposition import acts_stream_block
    from ganspace_tpu_torch.models import stylegan2 as sg2
    cfg = sg2.SG2Config(resolution=32, channels=((4, 64), (8, 64), (16, 32), (32, 32)))
    model = sg2.StyleGAN2("ffhq", cfg=cfg, params=sg2.init_params(cfg, seed=3),
                          device="cuda")
    long, short = (model.sample_latents_device(k, 16, seed=1) for k in (5, 3))
    assert all(torch.equal(a, b) for a, b in zip(long, short))
    assert long[0].device.type == "cuda"
    acts, lat = acts_stream_block(model, "convs.1", 16, seed=1)(4)
    assert torch.equal(lat, long[4]) and acts.shape[0] == 16
    # every kernel of the tap forward sums in a fixed order: a regenerated
    # block repeats its activations bit for bit
    again = acts_stream_block(model, "convs.1", 16, seed=1)(4)[0]
    assert torch.equal(again, acts)


# -- the sketch tier of the IPCA estimator (plain cuBLAS GEMMs) ---------------

def test_sketch_tier_on_card_matches_cpu(gen):
    """The same blocks and Omega through the sketch tier with its refine pass
    on the card and on the CPU; numpy blocks follow the state to the card."""
    import numpy as np
    from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
    rs = np.random.RandomState(0)
    spec = (0.97 ** np.arange(4096)).astype(np.float32)
    blocks = [rs.randn(1000, 4096).astype(np.float32) * spec + 0.5 for _ in range(4)]
    comps = []
    for first in (torch.from_numpy(blocks[0]).cuda(), blocks[0]):
        est = IPCAEstimator(16, mode="nystrom", refine="always")
        with ieee_f32():
            for b in [first] + blocks[1:]:
                assert est.fit_partial(b)
            assert est.should_refine() and est.begin_refine()
            for b in blocks:
                assert est.fit_partial(b)
            comps.append(est.get_components(device=True)[0])
    assert comps[0].device.type == "cuda" and comps[1].device.type == "cpu"
    cos = (comps[0].cpu() * comps[1]).sum(1).abs()
    assert float(cos.min()) > 0.9999
