"""The port's StyleGAN2 against the JAX package's on identical weights.

A small generator (64 px, channels <= 64) gets the JAX package's flat
parameter dict through ``params_from_jax``; image and taps must agree to
< 1e-4 relative (the bar of ``tests/test_torch_parity.py``) for one W, two
Ws (style mixing) and W+ input."""

import numpy as np
import pytest
import torch

from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


CHANNELS = ((4, 64), (8, 64), (16, 64), (32, 32), (64, 16))
TAPS = ("conv1", "convs.2", "to_rgbs.1")


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def models():
    jcfg = jax_sg2.SG2Config(resolution=64, channels=CHANNELS)
    jax_model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jcfg,
                                  params=jax_sg2.init_params(jcfg, seed=5))
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=64,
                                                              channels=CHANNELS),
                               init_seed=11, device="cpu")
    port.params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()})
    return jax_model, port


def _run_both(models, inputs, taps, w_space, mix_seed=None):
    jax_model, port = models
    for m in models:
        m.use_w() if w_space else m.use_z()
    jinst, tinst = JaxInstrumented(jax_model), InstrumentedModel(port)
    jinst.retain_layers(taps)
    tinst.retain_layers(taps)
    if mix_seed is not None:       # the style-mixing point is a host draw
        np.random.seed(mix_seed)
        port.seed_host_rng(mix_seed)
    ref_img = np.asarray(jax_model.forward(inputs if len(inputs) > 1 else inputs[0]))
    tin = [torch.from_numpy(a) for a in inputs]
    img = port.forward(tin if len(tin) > 1 else tin[0]).numpy()
    out = {"image": (img, ref_img)}
    for t in taps:
        out[t] = (tinst.retained_features()[t].numpy(),
                  np.asarray(jinst.retained_features()[t]))
    jinst.close()
    tinst.close()
    return out


def test_single_w_from_z(models):
    z = np.random.RandomState(17).randn(2, 512).astype(np.float32)
    for name, (got, ref) in _run_both(models, [z], ("style",) + TAPS,
                                      w_space=False).items():
        assert got.shape == ref.shape, name
        assert _rel(got, ref) < 1e-4, name


def test_two_ws_style_mixing(models):
    rs = np.random.RandomState(18)
    ws = [rs.randn(2, 512).astype(np.float32) for _ in range(2)]
    for name, (got, ref) in _run_both(models, ws, TAPS, w_space=True,
                                      mix_seed=9).items():
        assert _rel(got, ref) < 1e-4, name


def test_w_plus(models):
    n_latent = models[1].get_max_latents()
    rs = np.random.RandomState(19)
    base = rs.randn(2, 512).astype(np.float32)
    ws = [base + 0.3 * rs.randn(2, 512).astype(np.float32)
          for _ in range(n_latent)]
    for name, (got, ref) in _run_both(models, ws, TAPS, w_space=True).items():
        assert _rel(got, ref) < 1e-4, name


def test_partial_forward_stops_at_style(models):
    """In W mode the style tap never fires and nothing is synthesized."""
    _, port = models
    port.use_w()
    inst = InstrumentedModel(port)
    inst.retain_layer("style")
    assert port.partial_forward(torch.zeros(1, 512), "style") is None
    assert inst.retained_features()["style"] is None
    inst.close()


@pytest.mark.parametrize("mode,layer", [("latent", "style"), ("activation", "conv1")])
def test_edit_strips_match_jax(models, mode, layer):
    """Centered edit strips (``edit.create_strip_centered``) on both stacks."""
    from ganspace_tpu.edit import create_strip_centered as jax_strip
    from ganspace_tpu_torch.edit import create_strip_centered

    jax_model, port = models
    for m in models:
        m.use_w()
    rs = np.random.RandomState(23)
    w = rs.randn(1, 512).astype(np.float32)
    z_comp = rs.randn(1, 512).astype(np.float32)
    z_comp /= np.linalg.norm(z_comp)
    x_comp = rs.randn(1, 1, 64, 4, 4).astype(np.float32)
    x_comp /= np.linalg.norm(x_comp)
    act_mean = 0.1 * rs.randn(1, 64, 4, 4).astype(np.float32)
    lat_mean = 0.1 * rs.randn(1, 512).astype(np.float32)
    args = (mode, layer, [w], x_comp, z_comp, np.float32(2.0), np.float32(1.5),
            act_mean, lat_mean, 2.0, 2, 7)
    ref = jax_strip(JaxInstrumented(jax_model), *args, num_frames=3)
    got = create_strip_centered(InstrumentedModel(port), *args, num_frames=3)
    assert len(got) == len(ref) == 1 and len(got[0]) == 3
    for g, r in zip(got[0], ref[0]):
        assert g.shape == r.shape == (64, 64, 3)
        assert _rel(g, r) < 1e-4


def test_truncation_toward_latent_avg():
    jcfg = jax_sg2.SG2Config(resolution=64, channels=CHANNELS)
    params = jax_sg2.init_params(jcfg, seed=6)
    avg = np.random.RandomState(24).randn(512).astype(np.float32)
    jax_model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jcfg, params=params,
                                  truncation=0.6, latent_avg=avg, use_w=True)
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=64,
                                                              channels=CHANNELS),
                               params=params, truncation=0.6, latent_avg=avg,
                               use_w=True, device="cpu")
    w = np.random.RandomState(25).randn(2, 512).astype(np.float32)
    ref = np.asarray(jax_model.forward(w))
    got = port.forward(torch.from_numpy(w)).numpy()
    assert _rel(got, ref) < 1e-4
