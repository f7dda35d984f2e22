"""The port's StyleGAN3-T against the benchmark's plain reference.

A small generator (32 px, channel_max 16, the full 14 layers: a x4 layer
with negative padding at L5, the critically sampled L13) on the benchmark
family's seeded weights.  The taps and the image agree to < 1e-5 relative
(the order of the float32 sums differs: kernel B or cuDNN against one
conv, separable filters against their 2-D outer products); a 5-frame W
strip through ``edit.create_strip_centered`` is off by at most 2 uint8
values, the bar of ``benchmark/tests/test_bench_reference.py``.  The
filtered leaky ReLU's plain version is held to its definition by zero
insertion and a 2-D outer-product convolution, the Kaiser design to
``scipy.signal.firwin``, and the schedule at 1024 px to the official layer
names."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.models import stylegan3 as family
from benchmark.reference import stylegan3 as ref_sg3
from benchmark.reference.sampling import host_gaussian
from benchmark.reference.stylegan2 import centered_strip_ws, to_uint8
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.edit import create_strip_centered
from ganspace_tpu_torch.models import get_instrumented_model
from ganspace_tpu_torch.models import stylegan3 as sg3
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_plain
from ganspace_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


OFFICIAL = ("L0_36_512 L1_36_512 L2_52_512 L3_52_512 L4_84_512 L5_148_512 L6_148_512 "
            "L7_276_323 L8_276_203 L9_532_128 L10_1044_81 L11_1044_51 L12_1044_32 "
            "L13_1024_32 L14_1024_3").split()
CFG = json.loads((harness.ROOT / "benchmark/configs/StyleGAN3-T-FFHQ-1024.json").read_text())
TINY = {**CFG, "resolution": 32, "channel_max": 16}


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def tiny():
    weights = family.make_weights(TINY, 7, "cpu")
    inst = family.build_port(TINY, weights, {"layer": "style", "use_w": False}, "cpu")
    return inst, family.reference(TINY, weights, {})


def test_schedule_at_1024_gives_the_official_layers():
    layers = sg3.layer_schedule(sg3.SG3Config())
    assert [lay.name for lay in layers[1:]] == OFFICIAL
    assert [lay["name"] for lay in ref_sg3.schedule(CFG)[1:]] == OFFICIAL
    by = {lay.name: lay for lay in layers}
    assert (by["L10_1044_81"].up, by["L10_1044_81"].down, by["L10_1044_81"].up_taps) == (4, 2, 24)
    assert by["L13_1024_32"].pad == (-11, -12) and by["L14_1024_3"].up_taps == 1
    assert sg3.SG3Config().n_latent == 16


@pytest.mark.parametrize("numtaps, cutoff, width, fs", [
    (12, 2.0, 2 * 6.29, 32), (24, 64.0, 2 * 69.3, 512), (12, 512.0, 2 * 118.4, 2048),
    (12, 181.0, 2 * 75.0, 1024)])
def test_kaiser_design_matches_scipy(numtaps, cutoff, width, fs):
    signal = pytest.importorskip("scipy.signal")
    want = signal.firwin(numtaps, cutoff, width=width, fs=fs)
    assert np.abs(sg3.kaiser_lowpass(numtaps, cutoff, width, fs) - want).max() < 1e-12
    assert np.abs(ref_sg3.firwin(numtaps, cutoff, width, fs) - want).max() < 1e-12


@pytest.mark.parametrize("layer", ["style", "input", "L5_52_16", "L9_52_16", "L13_32_16",
                                   "L14_32_3"])
def test_taps_match_the_reference(tiny, layer):
    """L5: x4 with negative padding; L9: x2 with positive padding; L13:
    critically sampled, cropped; L14: ToRGB."""
    inst, ref = tiny
    z = family.latent_block(TINY, {}, 5, 0, 4, "cpu")
    inst.close()
    inst.retain_layer(layer)
    inst.model.partial_forward(z, layer)
    got = inst.retained_features()[layer].reshape(4, -1)
    want = ref.tap(z, layer)
    assert got.shape == want.shape == (4, family.tap_dim(TINY, layer))
    assert _rel(got, want) < 1e-5


def test_image_matches_the_reference(tiny):
    inst, ref = tiny
    z = family.latent_block(TINY, {}, 6, 0, 3, "cpu")
    img = inst.model.forward(z) * 2 - 1
    want = ref.synthesis(ref.mapping(z)[:, None].expand(-1, ref.n_latent, -1))
    assert img.shape == want.shape == (3, 3, 32, 32)
    assert _rel(img, want) < 1e-5


def _strip(inst, ref, seed):
    """A 5-frame centered W strip by the program and by the reference."""
    gen = torch.Generator().manual_seed(seed)
    d = torch.nn.functional.normalize(torch.randn(1, 512, generator=gen), dim=1)
    mean = 0.5 * torch.randn(512, generator=gen)
    stdev = 1.3
    inst.model.use_w()
    try:
        w = inst.model.sample_latent(1, seed=seed)
        got = np.stack(create_strip_centered(inst, "latent", "style", [w], d, d, stdev, stdev,
                                             mean, mean, 2.0, 0, -1, 5, as_uint8=True)[0])
    finally:
        inst.model.use_z()
    w_ref = ref.mapping(torch.from_numpy(host_gaussian(seed, 512)))
    ws = centered_strip_ws(w_ref, d[0], stdev, mean, 2.0, 5, ref.n_latent, 0, ref.n_latent)
    return got, to_uint8(ref.synthesis(ws)).numpy()


def test_strip_matches_the_reference(tiny):
    got, want = _strip(*tiny, seed=21)
    assert got.shape == want.shape == (5, 32, 32, 3) and got.dtype == np.uint8
    assert np.count_nonzero(got != want) <= 2
    assert np.abs(got.astype(int) - want).max() <= 1
    # the strip is one request whose record names every layer and the filter
    strip = tracing.units("edit.strip")[-1]["spans"]
    names = {"synth.input", "flrelu", "imaging.readback", "model.forward"}
    names |= {"synth." + n for n in tiny[0].model.synthesis.layer_names}
    assert names <= set(strip), sorted(names - set(strip))
    assert strip["flrelu"][0] == 15 and "synth.mapping" not in strip


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_frames_are_neither_saturated_nor_flat(seed):
    weights = family.make_weights(TINY, seed, "cpu")
    inst = family.build_port(TINY, weights, {"layer": "style", "use_w": False}, "cpu")
    frames, _ = _strip(inst, family.reference(TINY, weights, {}), seed=seed + 1)
    assert np.count_nonzero((frames == 0) | (frames == 255)) < frames.size // 2
    assert np.count_nonzero(frames[0] != frames[-1]) > frames[0].size // 10


def _definition(x, fu, fd, b, up, down, pad, gain, slope, clamp):
    """Zero insertion, padding, the 2-D outer products as single true
    convolutions (the benchmark reference's filter)."""
    y = ref_sg3.filter2d(x + b[None, :, None, None], fu, up, 1, pad, float(up * up))
    y = torch.clamp(torch.nn.functional.leaky_relu(y, slope) * gain, -clamp, clamp)
    return ref_sg3.filter2d(y, fd, 1, down, (0, 0), 1.0)


@pytest.mark.parametrize("n, up, pad, cut_in, cut_out", [
    (38, 2, (9, 8), 2.0, 2.0),            # L0's settings at 36 px
    (38, 4, (-6, -9), 2.52, 3.17),        # a x4 layer with negative padding
    (30, 2, (-11, -12), 16.0, 16.0)])     # a critically sampled, cropped one
def test_filtered_lrelu_plain_matches_its_definition(n, up, pad, cut_in, cut_out):
    gen = torch.Generator().manual_seed(n + up)
    x = 3 * torch.randn(2, 5, n, n, generator=gen, dtype=torch.float64)
    b = torch.randn(5, generator=gen, dtype=torch.float64)
    rate = 16 * up
    fu = sg3.kaiser_lowpass(6 * up, cut_in, 2 * 4.0, rate)
    fd = sg3.kaiser_lowpass(12, cut_out, 2 * 4.0, rate)
    args = (up, 2, pad, 2 ** 0.5, 0.2, 4.0)            # a low clamp, so that it bites
    want = _definition(x, fu, fd, b, *args)
    got = filtered_lrelu_plain(x.float(), torch.tensor(fu, dtype=torch.float32),
                               torch.tensor(fd, dtype=torch.float32), b.float(), *args)
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max() / want.abs().max()) < 1e-6
    # the entry runs the plain version on the CPU
    assert torch.equal(filtered_lrelu(x.float(), torch.tensor(fu, dtype=torch.float32),
                                      torch.tensor(fd, dtype=torch.float32), b.float(), *args),
                       got)


@pytest.mark.parametrize("layer", ["style", "L0_36_4"])
def test_fits_through_the_decomposition(tmp_path, monkeypatch, layer):
    """A W fit and a conv-tap fit through ``get_or_compute``, and the model
    built by name through ``get_instrumented_model`` at that tap."""
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "1")
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "1024")      # the sketch tier at D 20736
    cfg = sg3.SG3Config(resolution=32, channel_max=4)
    inst = get_instrumented_model("StyleGAN3", "ffhq", layer, "cpu", cfg=cfg,
                                  params=sg3.init_params(cfg, seed=2), use_w=layer == "style")
    assert isinstance(inst, InstrumentedModel) and inst.model.get_max_latents() == 16
    path = get_or_compute(Config(device="cpu", model="StyleGAN3", output_class="ffhq",
                                 layer=layer, use_w=layer == "style", estimator="ipca",
                                 components=4, n=128, batch_size=64), inst)
    with np.load(path) as d:
        comp, lat = d["act_comp"], d["lat_comp"]
    dim = 512 if layer == "style" else 4 * 36 * 36
    assert comp.reshape(4, -1).shape == (4, dim) and lat.reshape(4, -1).shape == (4, 512)
    assert np.all(np.isfinite(comp))
