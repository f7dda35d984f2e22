"""The port's pure tap function (``StyleGAN2.pure_acts_fn``), the block of
the fused activation stream, against its own instrumented
``partial_forward`` and against the JAX package's ``pure_acts_fn`` on the
same weights and latents (``tests/test_pure_acts.py`` is the JAX
package's own check of the same pair).  Bar: 1e-5 relative to the tap's
largest magnitude."""

import numpy as np
import pytest
import torch

from ganspace_tpu.models import stylegan2 as jax_sg2

from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel

CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))
TAPS = ("input", "conv1", "to_rgb1", "convs.0.conv", "convs.1", "convs.3", "to_rgbs.2")
REL = 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jax_sg2.SG2Config(resolution=32, channels=CHANNELS)
    params = jax_sg2.init_params(jcfg, seed=3)
    jax_model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jcfg, params=params)
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=32,
                                                              channels=CHANNELS),
                               params=params, device="cpu")
    return jax_model, port


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("w_space", [False, True], ids=["z", "w"])
@pytest.mark.parametrize("layer", TAPS)
def test_pure_acts_matches_partial_forward_and_jax(models, layer, w_space):
    jax_model, port = models
    for m in models:
        m.use_w() if w_space else m.use_z()
    lat = np.random.RandomState(11).randn(5, 512).astype(np.float32)
    got = port.pure_acts_fn(layer)(torch.from_numpy(lat))

    inst = InstrumentedModel(port)
    inst.retain_layer(layer)
    port.partial_forward(torch.from_numpy(lat), layer)
    retained = inst.retained_features()[layer].reshape(5, -1)
    inst.close()
    ref = np.asarray(jax_model.pure_acts_fn(layer)(lat))

    assert got.shape == retained.shape == ref.shape == (5, ref.shape[1])
    assert torch.isfinite(got).all()
    # the same synthesis with the same TapState stop: identical bits
    assert torch.equal(got, retained), _rel(got, retained)
    assert _rel(got, ref) <= REL, _rel(got, ref)


def test_pure_acts_ignores_the_instrumentation(models):
    """Edits and retained layers on the wrapper do not reach the pure tap
    function (the fused stream runs it while an ``InstrumentedModel`` holds
    the model)."""
    _, port = models
    port.use_z()
    lat = torch.from_numpy(np.random.RandomState(12).randn(3, 512).astype(np.float32))
    fn = port.pure_acts_fn("convs.1")
    clean = fn(lat)
    inst = InstrumentedModel(port)
    inst.retain_layer("convs.0")
    inst.edit_layer("convs.0", offset=np.full((1, 64, 8, 8), 5.0, np.float32))
    try:
        assert torch.equal(fn(lat), clean)
        assert inst.retained_features()["convs.0"] is None
    finally:
        inst.close()
