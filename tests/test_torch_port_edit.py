"""The port's edit engine (``create_strip``, ``create_strip_centered``,
``save_frames``) against the JAX package's.

The cases of ``tests/test_edit.py`` run on the port's strips; then both
packages render the same strips on the same small StyleGAN2 (the JAX
package's weights carried across with ``params_from_jax``), in both edit
modes, centered or not, whole or chunked by ``max_batch``: every frame
within ``FRAME_TOL`` (absolute, frames in [0, 1]; the ROADMAP's 1e-4 bar);
and ``save_frames`` writes the same files with the same pixels as JAX's
from the same frames.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from ganspace_tpu import edit as jax_edit
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch.edit import create_strip, create_strip_centered, save_frames
from ganspace_tpu_torch.imaging import to_uint8
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel

# tests/helpers.tiny_stylegan2's configuration
CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))
FRAME_TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_sg2.SG2Config(resolution=32, channels=CHANNELS)
    jax_model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jcfg,
                                  params=jax_sg2.init_params(jcfg, seed=3))
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=32,
                                                              channels=CHANNELS),
                               init_seed=11, device="cpu")
    port.params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()})
    return jax_model, port


@pytest.fixture
def setup(models):
    port = models[1]
    port.use_z()
    yield port, InstrumentedModel(port)
    port.use_z()


def _unit(shape, seed):
    v = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return v / np.linalg.norm(v)


def _tap_shape(model, inst, layer, z):
    inst.retain_layer(layer)
    model.partial_forward(z, layer)
    return tuple(inst.retained_features()[layer].shape[1:])


def test_latent_strip_shapes(setup):
    model, inst = setup
    z = model.sample_latent(1, seed=3)
    frames = create_strip(inst, "latent", "conv1", [z], np.zeros((1, 64, 4, 4)),
                          _unit((1, 512), 0), 1.0, 1.0, sigma=2.0, layer_start=0,
                          layer_end=-1, num_frames=5)
    assert len(frames) == 1 and len(frames[0]) == 5
    assert frames[0][0].shape == (32, 32, 3)
    assert np.abs(frames[0][0] - frames[0][2]).max() > 1e-4
    assert np.abs(frames[0][4] - frames[0][2]).max() > 1e-4


def test_activation_strip_changes_output(setup):
    model, inst = setup
    z = model.sample_latent(1, seed=4)
    frames = create_strip(inst, "activation", "conv1", [z], _unit((1, 64, 4, 4), 1),
                          np.zeros((1, 512), np.float32), 5.0, 1.0, sigma=2.0,
                          layer_start=0, layer_end=-1, num_frames=3)[0]
    assert np.abs(frames[0] - frames[1]).max() > 1e-4
    # edits must not leak into later plain forwards
    img_a = model.sample_np(z)
    inst.remove_edits()
    assert np.array_equal(img_a, model.sample_np(z))


def test_centered_strip_zero_sigma_on_mean(setup):
    model, inst = setup
    model.use_w()
    w = model.sample_latent(1, seed=5).numpy()
    z_comp = _unit((1, 512), 0)
    lat_mean = model.sample_latent(200, seed=6).numpy().mean(0, keepdims=True)
    dotp = np.sum((w - lat_mean) * z_comp)
    w_centered = w - dotp * z_comp
    frames = create_strip_centered(inst, "latent", "style", [w],
                                   np.zeros((1, 512), np.float32), z_comp,
                                   1.0, 1.0, np.zeros((1, 512), np.float32),
                                   lat_mean, sigma=2.0, layer_start=0,
                                   layer_end=-1, num_frames=3)[0]
    expected_mid = model.sample_np([w_centered] * model.get_max_latents())
    assert np.abs(frames[1] - expected_mid).max() < 1e-4


def test_layer_window_limits_effect(setup):
    model, inst = setup
    z = model.sample_latent(1, seed=7)
    z_comp = _unit((1, 512), 2)
    full = create_strip(inst, "latent", "conv1", [z], np.zeros((1, 64, 4, 4)),
                        z_comp, 1.0, 1.0, 2.0, 0, -1, 3)[0]
    late = create_strip(inst, "latent", "conv1", [z], np.zeros((1, 64, 4, 4)),
                        z_comp, 1.0, 1.0, 2.0, 4, -1, 3)[0]
    assert np.abs(full[0] - late[0]).max() > 1e-4


def test_cached_component_placeholder_dims(setup):
    """Components from the npz cache keep the placeholder batch dim
    ([c, 1, C, H, W] / [c, 1, D]); the strips collapse it."""
    model, inst = setup
    z = model.sample_latent(1, seed=0).numpy()
    feat = (64, 4, 4)
    x_comp = np.random.RandomState(0).randn(1, 1, *feat).astype(np.float32)
    z_comp = np.random.RandomState(1).randn(1, 1, z.shape[-1]).astype(np.float32)
    for mode in ("activation", "latent"):
        frames = create_strip_centered(
            inst, mode, "conv1", [z], x_comp, z_comp, 1.0, 1.0,
            np.zeros((1, *feat), np.float32), np.zeros((1, z.shape[-1]), np.float32),
            2.0, 0, -1, num_frames=3)
        assert len(frames[0]) == 3
        for img in frames[0]:
            assert img.ndim == 3 and img.shape[-1] == 3, img.shape


def _mode_cases(model, inst, seed):
    z = model.sample_latent(1, seed=seed)
    rs = np.random.RandomState(seed)
    z_comp = rs.randn(1, 512).astype(np.float32)
    feat = _tap_shape(model, inst, "convs.0", z)
    return z, z_comp, (("latent", z_comp),
                       ("activation", rs.randn(1, *feat).astype(np.float32)))


def test_strip_chunked_matches_unchunked(setup):
    """max_batch chunking, with a chunk size that does not divide the
    frames, changes no frame in either mode."""
    model, inst = setup
    z, z_comp, cases = _mode_cases(model, inst, 7)
    for mode, x_comp in cases:
        args = (inst, mode, "convs.0", [z], x_comp, z_comp,
                np.ones(1, np.float32), np.ones(1, np.float32),
                np.zeros_like(x_comp[0]), np.zeros_like(z_comp[0]))
        common = dict(sigma=2.0, layer_start=0, layer_end=-1, num_frames=5)
        full = create_strip_centered(*args, **common)[0]
        chunked = create_strip_centered(*args, max_batch=2, **common)[0]
        assert len(full) == len(chunked) == 5
        for a, b in zip(full, chunked):
            assert np.allclose(a, b, atol=1e-5), mode


def test_strip_uint8_matches_quantized_float(setup):
    """as_uint8=True quantizes on the device: equal to the quantized float
    frames, in both modes."""
    model, inst = setup
    z, z_comp, cases = _mode_cases(model, inst, 5)
    for mode, x_comp in cases:
        args = (inst, mode, "convs.0", [z], x_comp, z_comp,
                np.ones(1, np.float32), np.ones(1, np.float32),
                np.zeros_like(x_comp[0]), np.zeros_like(z_comp[0]))
        common = dict(sigma=2.0, layer_start=0, layer_end=-1, num_frames=3)
        f32 = create_strip_centered(*args, **common)[0]
        u8 = create_strip_centered(*args, as_uint8=True, **common)[0]
        for a, b in zip(f32, u8):
            assert b.dtype == np.uint8
            assert np.array_equal(to_uint8(a), b), mode


@pytest.mark.parametrize("mode", ["latent", "activation", "both"])
@pytest.mark.parametrize("centered", [False, True], ids=["strip", "centered"])
@pytest.mark.parametrize("max_batch", [None, 4], ids=["whole", "chunked"])
def test_strips_match_jax(models, mode, centered, max_batch):
    """Two latents, a layer window, a non-zero mean: the same strips from
    both packages.  At max_batch 4 JAX pads its tail chunk of 2 frames to 4;
    the port renders the tail as it is."""
    jax_model, port = models
    for m in models:
        m.use_w()
    try:
        w = port.sample_latent(2, seed=9).numpy()
        x_comp = _unit((1, 64, 8, 8), 3)           # convs.0 of the 32-px model
        z_comp = _unit((1, 512), 4)
        act_mean = np.full((1, 64, 8, 8), 0.01, np.float32)
        lat_mean = w.mean(0, keepdims=True) + 0.1
        common = dict(mode=mode, layer="convs.0", latents=list(w[:, None]),
                      x_comp=x_comp, z_comp=z_comp, act_stdev=3.0, lat_stdev=2.0,
                      sigma=2.0, layer_start=1, layer_end=6, num_frames=5,
                      max_batch=max_batch)
        if centered:
            common.update(act_mean=act_mean, lat_mean=lat_mean)
        fn = (create_strip_centered, jax_edit.create_strip_centered) if centered \
            else (create_strip, jax_edit.create_strip)
        got = fn[0](InstrumentedModel(port), **common)
        ref = fn[1](JaxInstrumented(jax_model), **common)
        assert len(got) == len(ref) == 2
        for strip_g, strip_r in zip(got, ref):
            assert len(strip_g) == len(strip_r) == 5
            for g, r in zip(strip_g, strip_r):
                assert g.shape == r.shape == (32, 32, 3)
                assert np.abs(g - np.asarray(r)).max() < FRAME_TOL
    finally:
        for m in models:
            m.use_z()


def _frames(n_strips, h, w, dtype, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_strips):
        strip = [rs.rand(h, w, 3).astype(np.float32) * 1.2 - 0.1 for _ in range(3)]
        out.append([to_uint8(f) for f in strip] if dtype == np.uint8 else strip)
    return out


@pytest.mark.parametrize("case", [(10, 40, 24, np.float32), (12, 600, 20, np.float32),
                                  (10, 40, 24, np.uint8), (4, 40, 24, np.float32)],
                         ids=["grid", "tall_grid", "grid_uint8", "too_few"])
def test_save_frames_matches_jax(tmp_path, case):
    """The grid of the first 10 strips (two columns, a 30-px gutter), one
    PNG per strip, frames taller than 512 px scaled down by LANCZOS, and
    strips only below 10: JAX's files, pixel for pixel."""
    n_strips, h, w, dtype = case
    frames = _frames(n_strips, h, w, dtype)
    jax_edit.save_frames("edit: a/b", "StyleGAN2-ffhq", tmp_path / "jax", frames)
    save_frames("edit: a/b", "StyleGAN2-ffhq", tmp_path / "port", frames)
    ref_dir = tmp_path / "jax" / "StyleGAN2-ffhq" / "edit__a_b"
    got_dir = tmp_path / "port" / "StyleGAN2-ffhq" / "edit__a_b"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    assert ("edit__a_b_all.png" in names) == (n_strips >= 10)
    assert len(names) == min(n_strips, 10) + (n_strips >= 10)
    for name in names:
        got = np.asarray(Image.open(got_dir / name))
        assert np.array_equal(got, np.asarray(Image.open(ref_dir / name))), name
    with Image.open(got_dir / "edit__a_b_0.png") as im:
        assert im.size[1] == int(min(1.0, 512 / h) * h)
