"""StyleGAN3-T's operations and pipeline on the card.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  The
file imports no jax (the GPU machine has none), so run it there without
the suite's conftest:

    python -m pytest --noconftest tests/test_torch_port_stylegan3_cuda.py -m cuda -q

Kernel B's modulated mode at StyleGAN3's 3x3 shapes (odd channel counts,
widths = 2 mod 4, the input padded by one pixel for the full padding)
meets the bar of ``tests/test_torch_port_cuda.py`` against its plain
version; the filtered leaky ReLU on the card meets its plain version in
float64 on the CPU; the 1024-px model builds by name at ``style`` (W) and
at a conv tap, fits through the decomposition and renders a strip.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.edit import create_strip_centered
from ganspace_tpu_torch.models import get_instrumented_model
from ganspace_tpu_torch.models import stylegan3 as sg3
from ganspace_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_plain
from ganspace_tpu_torch.ops.modconv import demodulation, modconv3x3, modconv3x3_plain
from ganspace_tpu_torch.ops.precision import ieee_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    return torch.Generator(device="cuda").manual_seed(0)


#: (C, Co, input size) of StyleGAN3-T's 3x3 convs, from its schedule
SG3_3X3 = sorted({(lay.cin, lay.cout, lay.in_size)
                  for lay in sg3.layer_schedule(sg3.SG3Config())[1:] if not lay.torgb})


@pytest.mark.parametrize("c,co,n", SG3_3X3)
def test_modconv3x3_at_stylegan3_shapes_on_card(gen, c, co, n):
    b = 5 if n < 1000 else 2
    x = F.pad(torch.randn(b, c, n, n, generator=gen, device="cuda"), [1, 1, 1, 1])
    wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda")
    wt = wt * wt.square().mean([1, 2, 3], keepdim=True).rsqrt()
    s = 1.0 + 0.5 * torch.randn(b, c, generator=gen, device="cuda")
    launches = modconv3x3.launches
    with ieee_f32():
        d = demodulation(wt, s)
        got, ref = modconv3x3(x, wt, 0.7 * s, d), modconv3x3_plain(x, wt, 0.7 * s, d)
    assert got.shape == (b, co, n + 2, n + 2)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
    assert modconv3x3.launches == launches + 1


def _layer(name):
    return next(lay for lay in sg3.layer_schedule(sg3.SG3Config()) if lay.name == name)


@pytest.mark.parametrize("name", ["L10_1044_81", "L13_1024_32", "L2_52_512"])
def test_filtered_lrelu_on_card_matches_plain(gen, name):
    lay = _layer(name)
    n = lay.in_size + 2
    x = 2 * torch.randn(1, lay.cout, n, n, generator=gen, device="cuda")
    b = torch.randn(lay.cout, generator=gen, device="cuda")
    taps = [torch.tensor(sg3.kaiser_lowpass(t, c, 2 * h, lay.tmp_rate), dtype=torch.float32)
            for t, c, h in ((lay.up_taps, lay.in_cutoff, lay.in_half_width),
                            (lay.down_taps, lay.out_cutoff, lay.out_half_width))]
    args = (lay.up, lay.down, lay.pad, 2 ** 0.5, 0.2, 256.0)
    got = filtered_lrelu(x, taps[0].cuda(), taps[1].cuda(), b, *args)
    want = filtered_lrelu_plain(x.cpu().double(), taps[0].double(), taps[1].double(),
                                b.cpu().double(), *args)
    assert got.shape == want.shape == (1, lay.cout, lay.out_size, lay.out_size)
    assert float((got.cpu().double() - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("layer", ["style", "L3_52_512"])
def test_stylegan3_1024_fits_and_renders_on_card(gen, tmp_path, monkeypatch, layer):
    """``get_instrumented_model`` by name at the published size, a fit
    through ``get_or_compute`` and a centered W strip, as for StyleGAN2."""
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "1")
    use_w = layer == "style"
    inst = get_instrumented_model("StyleGAN3", "ffhq", layer, "cuda", use_w=use_w)
    assert inst.model.resolution == 1024 and inst.model.get_max_latents() == 16
    n, batch = (2000, 500) if use_w else (256, 32)
    path = get_or_compute(Config(model="StyleGAN3", output_class="ffhq", layer=layer,
                                 use_w=use_w, estimator="ipca", components=8, n=n,
                                 batch_size=batch), inst)
    with np.load(path) as d:
        comp, lat, stdev = d["act_comp"], d["lat_comp"], d["act_stdev"]
    assert np.all(np.isfinite(comp)) and np.all(np.isfinite(lat)) and np.all(stdev > 0)
    if not use_w:
        assert comp.reshape(8, -1).shape[1] == 512 * 52 * 52
        return
    w = inst.model.sample_latent(1, seed=4)
    frames = create_strip_centered(inst, "latent", "style", [w], lat[:1], lat[:1], 1.0, 1.0,
                                   np.zeros(512, np.float32), np.zeros(512, np.float32), 2.0,
                                   0, -1, 5, as_uint8=True)[0]
    assert len(frames) == 5 and frames[0].shape == (1024, 1024, 3)
    assert frames[0].dtype == np.uint8
