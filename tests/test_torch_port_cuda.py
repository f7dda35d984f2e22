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
from ganspace_tpu_torch.ops.precision import ieee_f32, precision


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


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
    with pytest.raises(TypeError):
        conv3x3(xc.double(), w)
    launches = modconv3x3.launches
    modulated_conv2d(xc, w, torch.ones(1, 8, device="cuda"))
    assert modconv3x3.launches == launches + 1


# -- the bf16 datapath (the preview policy) ----------------------------------

def _bf16_close(got, ref, storage):
    """float32 storage: the float32 bar (the summation order alone differs);
    bf16 storage: elementwise one bf16 rounding flip, one ulp of |ref|."""
    assert got.dtype == ref.dtype == storage
    if storage == torch.float32:
        return float((got - ref).abs().max() / ref.abs().max()) < 1e-5
    g, r = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    return bool(((g - r).abs() <= ulp + 1e-6 * r.abs().max()).all())


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,co,h,w", RENDER_SHAPES + RAGGED_SHAPES)
def test_modconv3x3_and_conv3x3_bf16_datapath_on_card(gen, storage, b, c, co, h, w):
    x = torch.randn(b, c, h, w, generator=gen, device="cuda").to(storage)
    wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    s = 1.0 + 0.5 * torch.randn(b, c, generator=gen, device="cuda")
    d = demodulation(wt, s)
    counts = modconv3x3.launches_bf16, conv3x3.launches_bf16, modconv3x3.launches
    with ieee_f32(), precision("default"):
        got = modconv3x3(x, wt, s, d)
        assert _bf16_close(got, modconv3x3_plain(x, wt, s, d), storage)
        assert torch.equal(got, modconv3x3(x, wt, s, d))
        got = conv3x3(x, wt)
        assert _bf16_close(got, conv3x3_plain(x, wt), storage)
        assert torch.equal(got, conv3x3(x, wt))
    assert (modconv3x3.launches_bf16, conv3x3.launches_bf16, modconv3x3.launches) == (
        counts[0] + 2, counts[1] + 2, counts[2])


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,co,h,w,k,pad", UP_SHAPES)
def test_upsample_conv_bf16_datapath_on_card(gen, storage, b, c, co, h, w, k, pad):
    x = torch.randn(b, c, h, w, generator=gen, device="cuda").to(storage)
    wt = torch.randn(co, c, k, k, generator=gen, device="cuda") / (k * k * c) ** 0.5
    s = 1.0 + 0.5 * torch.randn(b, c, generator=gen, device="cuda")
    launches = upsample_conv.launches_bf16
    with ieee_f32(), precision("default"):
        for ss, d in ((s, demodulation(wt, s)), (None, None)):
            got = upsample_conv(x, wt, ss, d, pad=pad)
            assert _bf16_close(got, upsample_conv_plain(x, wt, ss, d, pad=pad), storage)
            assert torch.equal(got, upsample_conv(x, wt, ss, d, pad=pad))
    assert upsample_conv.launches_bf16 == launches + 4


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


@pytest.mark.parametrize("n", [144, 256])
def test_wgmma_tile_bf16_on_card(gen, n):
    """The bf16 datapath's wgmma step: A formed into its swizzled shared
    tile as the body's pass forms it, B's bf16 image, both by descriptor."""
    from ganspace_tpu_torch.ops.precision import round_bf16
    from ganspace_tpu_torch.ops.tf32x3 import wgmma_tile_bf16
    a = torch.randn(64, 64, generator=gen, device="cuda")
    b = torch.randn(n, 64, generator=gen, device="cuda")
    ref = round_bf16(a).double() @ round_bf16(b).double().T
    got = wgmma_tile_bf16(a, b).double()
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


# -- the sketch tier of the IPCA estimator (the kernel pair of ops/sketch.py) --

def test_sketch_tier_on_card_matches_cpu(gen):
    """The same blocks and Omega through the sketch tier with its refine pass
    on the card (one kernel-pair launch a block) and on the CPU; numpy
    blocks follow the state to the card."""
    import numpy as np
    from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
    from ganspace_tpu_torch.ops.sketch import sketch_update
    launches = sketch_update.launches
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
    assert sketch_update.launches == launches + 2 * len(blocks)
    cos = (comps[0].cpu() * comps[1]).sum(1).abs()
    assert float(cos.min()) > 0.9999


# -- BigGAN-512 (kernel B's plain and stride-2 modes at its shapes) -----------

# (C, resolution) of BigGAN-512's stride-1 3x3 convs: conv_1 of the blocks that
# keep their size and every conv_2, 512 channels at 4 px to 32 at 512 px
BIGGAN_3X3 = [(512, 4), (512, 8), (512, 16), (256, 16), (256, 32), (256, 64), (128, 64),
              (128, 128), (64, 128), (64, 256), (32, 256), (32, 512)]
# (C, input resolution) of its seven up-blocks' conv_1 (nearest 2x, then 3x3)
BIGGAN_UP = [(512, 4), (512, 8), (256, 16), (256, 32), (128, 64), (64, 128), (32, 256)]


@pytest.mark.parametrize("c,co,r", [(c, c, r) for c, r in BIGGAN_3X3]
                         + [(128, 3, 512), (128, 128, 512)])
def test_conv3x3_biggan_shapes_on_card(gen, c, co, r):
    """The stride-1 convs and ``conv_to_rgb`` (three output rows when the
    tap is not read, all 128 when it is) at batch 2."""
    x = torch.randn(2, c, r, r, generator=gen, device="cuda")
    wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    with ieee_f32():
        got, ref = conv3x3(x, wt), conv3x3_plain(x, wt)
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
        assert torch.equal(got, conv3x3(x, wt))


@pytest.mark.parametrize("c,r", BIGGAN_UP)
def test_nearest_up_conv_on_card(gen, c, r):
    """An up-block's conv_1 through the stride-2 mode with the composite 4x4
    kernel (padding 1) against cuDNN's conv of the nearest-upsampled map."""
    import torch.nn.functional as F
    from ganspace_tpu_torch.ops.modconv import nearest_up_kernel
    x = torch.randn(2, c, r, r, generator=gen, device="cuda")
    wt = torch.randn(c, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    with ieee_f32():
        ck = nearest_up_kernel(wt)
        got = upsample_conv(x, ck, pad=1)
        ref = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), wt, padding=1)
        assert got.shape == ref.shape == (2, c, 2 * r, 2 * r)
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
        assert torch.equal(got, upsample_conv(x, ck, pad=1))


def test_biggan_on_card_matches_cpu(gen):
    """A small BigGAN on the card (kernels) and on the CPU (plain versions):
    the image, the gen_z and a block's taps, and the pure tap function of a
    regenerated fused block bit for bit."""
    from ganspace_tpu_torch.decomposition import acts_stream_block
    from ganspace_tpu_torch.models import biggan as bg
    from ganspace_tpu_torch.models.base import InstrumentedModel
    cfg = bg.BigGANConfig(output_dim=32, z_dim=16, channel_width=8,
                          layers=((False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2)),
                          attention_layer_position=2)
    params = bg.init_params(cfg, seed=3)
    models = [bg.BigGAN(32, "husky", truncation=0.7, cfg=cfg, params=params, device=d)
              for d in ("cuda", "cpu")]
    z = models[1].sample_latent(4, seed=2)
    taps = ("generator.gen_z", "generator.layers.1", "generator.layers.4.relu")
    out = []
    launches = (conv3x3.launches, upsample_conv.launches)
    for m in models:
        inst = InstrumentedModel(m)
        inst.retain_layers(taps)
        img = m.forward(z.to(m.device))
        out.append([img.cpu()] + [inst.retained_features()[t].cpu() for t in taps])
    # per forward: conv_1 of block 0, four conv_2, conv_to_rgb; three up-convs
    assert (conv3x3.launches - launches[0], upsample_conv.launches - launches[1]) == (6, 3)
    for got, ref in zip(*out):
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-4
    block = acts_stream_block(models[0], "generator.layers.1", 16, seed=1)
    (acts, lat), again = block(2), block(2)
    assert float(lat.abs().max()) <= 1.4 and torch.equal(again[0], acts)


# ProGAN-256's stride-1 3x3 convs (C, resolution) and its up layers (C, Co,
# input resolution); DCGAN-64's stride-2 transposed convs (C, Co, input
# resolution), the last to three channels (5 of the 8 columns of its k = 4
# channel group are padding)
PROGAN_3X3 = [(512, 4), (512, 8), (512, 16), (256, 32), (128, 64), (64, 128), (32, 256)]
PROGAN_UP = [(512, 512, 4), (512, 512, 8), (512, 256, 16), (256, 128, 32), (128, 64, 64),
             (64, 32, 128)]
DCGAN_UP = [(512, 256, 4), (256, 128, 8), (128, 64, 16), (64, 3, 32), (16, 1, 5)]


@pytest.mark.parametrize("c,r", PROGAN_3X3)
def test_conv3x3_progan_shapes_on_card(gen, c, r):
    x = torch.randn(2, c, r, r, generator=gen, device="cuda")
    wt = torch.randn(c, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    with ieee_f32():
        got, ref = conv3x3(x, wt), conv3x3_plain(x, wt)
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
        assert torch.equal(got, conv3x3(x, wt))


@pytest.mark.parametrize("c,co,r", PROGAN_UP)
def test_progan_up_conv_on_card(gen, c, co, r):
    """An up layer through the stride-2 mode with the composite kernel of
    its scaled 3x3 weight, against cuDNN's conv of the nearest-upsampled map."""
    import torch.nn.functional as F
    from ganspace_tpu_torch.ops.modconv import nearest_up_kernel
    x = torch.randn(2, c, r, r, generator=gen, device="cuda")
    wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    with ieee_f32():
        got = upsample_conv(x, nearest_up_kernel(wt), pad=1)
        ref = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), wt, padding=1)
        assert got.shape == ref.shape == (2, co, 2 * r, 2 * r)
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("c,co,r", DCGAN_UP)
def test_dcgan_transposed_conv_on_card(gen, c, co, r):
    """The zoo's ConvTranspose2d (k = 4, stride 2, padding 1) through the
    stride-2 mode, its [in, out, 4, 4] weight read as [out, in, 4, 4],
    against the plain version and cuDNN's transposed conv; Co below one
    channel group (3, 1) included."""
    import torch.nn.functional as F
    x = torch.randn(3, c, r, r, generator=gen, device="cuda")
    w = torch.randn(c, co, 4, 4, generator=gen, device="cuda") / (16 * c) ** 0.5
    with ieee_f32():
        got = upsample_conv(x, w.transpose(0, 1), pad=1)
        ref = F.conv_transpose2d(x, w, stride=2, padding=1)
        plain = upsample_conv_plain(x, w.transpose(0, 1), pad=1)
        assert got.shape == ref.shape == (3, co, 2 * r, 2 * r)
        for want in (ref, plain):
            assert float((got - want).abs().max() / want.abs().max()) < 1e-5
        assert torch.equal(got, upsample_conv(x, w.transpose(0, 1), pad=1))


@pytest.mark.parametrize("family", ["ProGAN", "DCGAN"])
def test_progan_and_dcgan_on_card_match_cpu(gen, family):
    """Small ProGAN and DCGAN on the card (kernels) and on the CPU (plain
    versions): the image and every tap, the launches per forward."""
    from ganspace_tpu_torch.models import dcgan, proggan
    from ganspace_tpu_torch.models.base import InstrumentedModel
    if family == "ProGAN":
        cfg = proggan.ProGANConfig((64, 64, 64, 32))
        params = proggan.init_params(cfg, seed=3)
        models = [proggan.ProGAN("bedroom", cfg=cfg, params=params, device=d)
                  for d in ("cuda", "cpu")]
        want = (3, 2)           # layer2, layer4, layer6; layer3, layer5
    else:
        cfg = dcgan.DCGANConfig(resolution=16, base_channels=64)
        params = dcgan.init_params(cfg, seed=3)
        models = [dcgan.GANZooModel(cfg=cfg, params=params, device=d) for d in ("cuda", "cpu")]
        want = (0, 2)           # deconv1, deconv2
    z = models[1].sample_latent(4, seed=2)
    taps = models[0].tap_names()
    out = []
    launches = (conv3x3.launches, upsample_conv.launches)
    for m in models:
        inst = InstrumentedModel(m)
        inst.retain_layers(taps)
        img = m.forward(z.to(m.device))
        out.append([img.cpu()] + [inst.retained_features()[t].cpu() for t in taps])
    assert (conv3x3.launches - launches[0], upsample_conv.launches - launches[1]) == want
    for got, ref in zip(*out):
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-4


@pytest.mark.parametrize("name", ["pca", "ica"])
def test_full_batch_estimators_take_kernel_a_on_card(gen, name):
    """PCA's Gram and ICA's whitening covariance: one kernel-A launch over
    the whole matrix (n >= d, 512 <= d <= 8192), components as on the CPU.
    ICA on planted Laplace sources, where its answer is unique."""
    import numpy as np
    from ganspace_tpu_torch.estimators import get_estimator
    rs = np.random.RandomState(0)
    src = rs.laplace(size=(8192, 16)) if name == "ica" else rs.randn(8192, 64)
    x = torch.from_numpy((src @ rs.randn(src.shape[1], 512)).astype(np.float32)).cuda()
    x -= x.mean(dim=0, keepdim=True)
    launches = centered_gram.launches
    card = get_estimator(name, 16, device="cuda")
    card.fit(x)
    assert centered_gram.launches == launches + 1
    cpu = get_estimator(name, 16, device="cpu")
    cpu.fit(x.cpu())
    cos = np.abs(np.sum(card.components_.astype(np.float64) * cpu.components_, axis=1))
    assert cos.min() > 0.999
    np.testing.assert_allclose(card.stdev, cpu.stdev, rtol=1e-4)


def test_dissection_on_card_matches_cpu(gen):
    """A tiny ProGAN's fused stats + conditional pass and tally on the card
    (kernel B's plain and stride-2 modes) and on the CPU: the same top-k
    values and levels (the sketch flips are host draws on both), IoUs within
    1e-3."""
    import importlib

    import numpy as np
    from ganspace_tpu_torch.models import proggan as pg
    from ganspace_tpu_torch.models.base import InstrumentedModel
    td = importlib.import_module("ganspace_tpu_torch.dissection.dissect")
    cfg = pg.ProGANConfig((64, 32, 32, 16))
    params = pg.init_params(cfg, 3)
    out = {}
    launches = (conv3x3.launches, upsample_conv.launches)
    for device in ("cuda", "cpu"):
        inst = InstrumentedModel(pg.ProGAN("bedroom", cfg=cfg, params=params, device=device))
        with ieee_f32():
            stats, cond = td.collect_stats_and_cond_quantiles(
                inst, "layer2", td.ColorSegmenter(), n_samples=32, batch=8, seed=1)
            report = td.dissect(inst, "layer2", td.ColorSegmenter(), n_samples=32,
                                batch=8, seed=1, stats=stats)
        out[device] = stats, cond, report
    assert conv3x3.launches > launches[0] and upsample_conv.launches > launches[1]
    (s, c, r), (s0, c0, r0) = out["cuda"], out["cpu"]
    vals = s0["topk_values"]
    assert np.abs(s["topk_values"] - vals).max() <= 1e-4 * np.abs(vals).max()
    qs = np.array([0.01, 0.5, 0.995])
    span = float(np.ptp(vals))
    assert np.abs(s["quantiles"].quantiles(qs) - s0["quantiles"].quantiles(qs)).max() <= 1e-4 * span
    assert np.abs(r["iou_matrix"] - r0["iou_matrix"]).max() <= 1e-3


def _adjoint_case(gen, b, c, co, h, w):
    """x (requiring grad), a 3x3 weight, s, d and a same-size y-bar."""
    x = torch.randn(b, c, h, w, generator=gen, device="cuda").requires_grad_(True)
    wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    s = 1.0 + 0.5 * torch.randn(b, c, generator=gen, device="cuda")
    gy = torch.randn(b, co, h, w, generator=gen, device="cuda")
    return x, wt, s, demodulation(wt, s), gy


def _grad(fn, x, gy):
    return torch.autograd.grad(fn(x), x, gy)[0]


@pytest.mark.parametrize("mode", ["modulated", "modulated_no_d", "plain"])
@pytest.mark.parametrize("b,c,co,h,w", [(2, 512, 512, 16, 16), (2, 40, 48, 19, 33),
                                        (1, 32, 32, 64, 64)])
def test_kernel_b_adjoint_on_card(gen, mode, b, c, co, h, w):
    """x-bar through kernel B (one forward and one backward launch of the
    mode) against autograd through the plain version."""
    x, wt, s, d, gy = _adjoint_case(gen, b, c, co, h, w)
    if mode == "plain":
        wrapper, fn, plain = conv3x3, lambda t: conv3x3(t, wt), lambda t: conv3x3_plain(t, wt)
    else:
        dd = None if mode == "modulated_no_d" else d
        wrapper = modconv3x3
        fn, plain = (lambda t: modconv3x3(t, wt, s, dd),
                     lambda t: modconv3x3_plain(t, wt, s, dd))
    launches = wrapper.launches
    with ieee_f32():
        got, ref = _grad(fn, x, gy), _grad(plain, x, gy)
    assert wrapper.launches == launches + 2
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("b,c,co,h,w,pad", [(2, 512, 512, 16, 16, 0), (2, 64, 32, 9, 7, 1)])
def test_upsample_adjoint_on_card(gen, b, c, co, h, w, pad):
    """x-bar of the stride-2 mode (the kernel forward, the stock adjoint)
    against autograd through the plain version."""
    x, wt, s, d, _ = _adjoint_case(gen, b, c, co, h, w)
    ho, wo = 2 * h + 1 - 2 * pad, 2 * w + 1 - 2 * pad
    gy = torch.randn(b, co, ho, wo, generator=gen, device="cuda")
    launches, stock = upsample_conv.launches, upsample_conv.stock_adjoints
    with ieee_f32():
        got = _grad(lambda t: upsample_conv(t, wt, s, d, pad=pad), x, gy)
        ref = _grad(lambda t: upsample_conv_plain(t, wt, s, d, pad=pad), x, gy)
    assert (upsample_conv.launches, upsample_conv.stock_adjoints) == (launches + 1, stock + 1)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_adjoints_refuse_what_they_do_not_take(gen):
    """w, s or d requiring grad, or the bf16 datapath, raise before any
    launch."""
    x, wt, s, d, _ = _adjoint_case(gen, 2, 32, 32, 8, 8)
    for fn in (lambda: modconv3x3(x, wt.clone().requires_grad_(True), s, d),
               lambda: modconv3x3(x, wt, s.clone().requires_grad_(True), d),
               lambda: upsample_conv(x, wt, s, d.clone().requires_grad_(True)),
               lambda: conv3x3(x.detach(), wt.clone().requires_grad_(True))):
        with pytest.raises(ValueError, match="with respect to x"):
            fn()
    with precision("default"), pytest.raises(ValueError, match="bf16"):
        conv3x3(x, wt)
    with pytest.raises(ValueError, match="bf16"):
        upsample_conv(x.detach().to(torch.bfloat16).requires_grad_(True), wt)
    with torch.no_grad():                     # no grad wanted: the plain launch
        assert not modconv3x3(x, wt, s, d).requires_grad
