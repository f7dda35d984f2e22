"""The port's pytorch_GAN_zoo DCGAN against the JAX package's on identical
weights.

``tests/helpers.py``'s tiny config (16 px, base width 64) with trained-like
batch-norm statistics.  On the CPU the stride-2 kernel's wrapper takes its
plain version, so these tests hold the model around it against the JAX
package: the image and every tap to < 1e-4 relative; a sample's output
independent of its batch-mates (the running statistics,
``tests/test_partial_forward.py:80``); the conditional slice; the
full-forward ``partial_forward`` and the pure tap function's ``output``
rule; the latents bit for bit; the full-width config; and the
decomposition at ``deconv1`` (the sketch tier, as at 64 px) and the
visualize CLI against the JAX package's."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganspace_tpu import models as jax_models
from ganspace_tpu.apps import visualize as jax_visualize
from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.models import dcgan as jax_dc
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.models import dcgan as torch_dc
from ganspace_tpu_torch.models import get_model
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops.modconv import upsample_conv

TINY = dict(resolution=16, base_channels=64)
REL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _params(seed=3):
    """The seeded init with batch-norm statistics and affines away from the
    identity, as a trained checkpoint has them."""
    params = jax_dc.init_params(jax_dc.DCGANConfig(**TINY), seed)
    rs = np.random.RandomState(seed + 1)
    for k, v in params.items():
        if k.startswith("bn"):
            v = v + 0.2 * rs.randn(*v.shape).astype(np.float32)
            params[k] = (np.abs(v) + 0.5 if k.endswith("running_var") else v).astype(np.float32)
    return params


def _pair(seed=3):
    params = _params(seed)
    jax_model = jax_dc.GANZooModel(cfg=jax_dc.DCGANConfig(**TINY), params=params)
    port = torch_dc.GANZooModel(cfg=torch_dc.DCGANConfig(**TINY), params=params, device="cpu")
    return jax_model, port


def test_init_params_config_and_taps_match_jax():
    for kw in (TINY, {}):
        ref = jax_dc.init_params(jax_dc.DCGANConfig(**kw), 7)
        got = torch_dc.init_params(torch_dc.DCGANConfig(**kw), 7)
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    jax_model, port = _pair()
    assert port.tap_names() == jax_model.tap_names() == ("deconv0", "deconv1", "output")
    assert set(port.state_dict()) == set(jax_model.params)
    assert (port.name, port.model_name, port.outclass) == ("DCGAN", "DCGAN", "default")
    assert port.resolution == jax_model.resolution == 16
    assert port.get_max_latents() == 1 and port.latent_space_name() == "Z"


def test_full_width_builds_on_the_card_by_default(monkeypatch, tmp_path):
    """The GAN-zoo DCGAN at full width (64 px, 140-dim latent, 512 to 64
    channels): 3.91 M parameters; the entry points refuse without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("GANCONTROL_CHECKPOINT_DIR", str(tmp_path))
    for build in (lambda: get_model("DCGAN"), lambda: torch_dc.GANZooModel()):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    model = get_model("DCGAN", device="cpu")
    n = sum(p.numel() for p in model.parameters())
    ref = jax_dc.init_params(jax_dc.DCGANConfig(), 0)
    assert sum(v.size for v in ref.values()) == n == 3_907_267
    assert model.cfg.channels() == [512, 256, 128, 64, 3]
    assert model.sample_latent(2).shape == (2, 140)


def test_image_and_every_tap_match_jax():
    jax_model, port = _pair()
    z = np.asarray(jax_model.sample_latent(4, seed=5))
    taps = port.tap_names()
    jinst, tinst = JaxInstrumented(jax_model), InstrumentedModel(port)
    jinst.retain_layers(taps)
    tinst.retain_layers(taps)
    launches = upsample_conv.launches
    img = port.forward(torch.tensor(z)).numpy()
    assert upsample_conv.launches == launches                  # CPU: plain version
    pairs = {"image": (img, np.asarray(jax_model.forward(z)))}
    pairs.update({t: (tinst.retained_features()[t].numpy(),
                      np.asarray(jinst.retained_features()[t])) for t in taps})
    for tap, (got, ref) in pairs.items():
        assert got.shape == ref.shape and np.isfinite(got).all(), tap
        assert _rel(got, ref) < REL, (tap, _rel(got, ref))
    assert img.shape == (4, 3, 16, 16)


def test_activation_edit_matches_jax():
    jax_model, port = _pair()
    z = np.asarray(jax_model.sample_latent(2, seed=6))
    offset = np.random.RandomState(1).randn(32, 8, 8).astype(np.float32)
    jinst, tinst = JaxInstrumented(jax_model), InstrumentedModel(port)
    jinst.edit_layer("deconv1", offset=offset)
    tinst.edit_layer("deconv1", offset=offset)
    ref = np.asarray(jax_model.forward(z))
    assert _rel(port.forward(torch.tensor(z)).numpy(), ref) < REL


def test_sample_independent_of_its_batch_mates():
    """Eval-mode batch norm: a sample's image and taps are the same alone
    and in a batch (running statistics, never the batch's)."""
    _, port = _pair()
    inst = InstrumentedModel(port)
    inst.retain_layer("deconv1")
    z = port.sample_latent(5, seed=2)
    batch = port.forward(z)
    tap = inst.retained_layer("deconv1", clear=True)
    alone = port.forward(z[2:3])
    assert torch.allclose(alone, batch[2:3], rtol=1e-5, atol=1e-6)
    assert torch.allclose(inst.retained_layer("deconv1"), tap[2:3], rtol=1e-5, atol=1e-6)


def test_conditional_state_matches_jax():
    jax_model, port = _pair()
    z = port.sample_latent(3, seed=4)
    zj = jnp.asarray(z.numpy())
    c = port.get_conditional_state(z)
    assert c.shape == (3, 20)
    assert np.array_equal(c.numpy(), np.asarray(jax_model.get_conditional_state(zj)))
    c2 = torch.from_numpy(np.random.RandomState(0).randn(3, 20).astype(np.float32))
    got = port.set_conditional_state(z, c2)
    ref = jax_model.set_conditional_state(zj, jnp.asarray(c2.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got[:, :120], z[:, :120]) and torch.equal(got[:, 120:], c2)


@pytest.mark.parametrize("layer", ["deconv0", "deconv1", "output"])
def test_partial_forward_is_a_full_forward(layer):
    """As in the reference, ``partial_forward`` runs the whole trunk and
    returns the raw image; the tap still retains what the full run does.
    The pure tap function stops at the tap, and is None at ``output``."""
    jax_model, port = _pair()
    inst = InstrumentedModel(port)
    inst.retain_layer(layer)
    z = port.sample_latent(2, seed=4)
    img = port.forward(z)
    full = inst.retained_layer(layer, clear=True)
    raw = port.partial_forward(z, layer)
    assert torch.equal(0.5 * (raw + 1), img)
    assert torch.equal(inst.retained_layer(layer, clear=True), full)
    port.partial_forward(port.sample_latent(2, seed=5), layer)
    assert not torch.allclose(inst.retained_layer(layer), full)
    fn = port.pure_acts_fn(layer)
    assert (fn is None) == (jax_model.pure_acts_fn_p(layer) is None) == (layer == "output")
    if fn is not None:
        assert torch.equal(fn(z), full.reshape(2, -1))


def test_latents_bit_identical_and_default_seed_zero():
    """``sample_latent``'s default seed is 0 (not a host-stream draw), as
    in the JAX package; the seedless prefetched stream follows numpy's."""
    jax_model, port = _pair()
    assert np.array_equal(port.sample_latent(3).numpy(), np.asarray(jax_model.sample_latent(3)))
    assert np.array_equal(port.sample_latent(3, seed=0).numpy(), port.sample_latent(3).numpy())
    np.random.seed(2)
    ref = [np.asarray(z) for z in jax_model.sample_latents_prefetched(2, 4)]
    port.seed_host_rng(2)
    got = port.sample_latents_prefetched(2, 4, keep_on="cpu")
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), r)


# -- the decomposition and the CLI against the JAX package -------------------

def _jax_omega(d, l):
    return np.array(jax.random.normal(jax.random.PRNGKey(0xA5), (d, l), jnp.float32))


@pytest.fixture
def sketch_env(monkeypatch):
    """Host RNG; ``deconv1`` (D = 32 * 8 * 8 = 2048 here, 256 * 8 * 8 =
    16384 at 64 px) on the sketch tier, as at full width; JAX's Omega."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "1024")
    monkeypatch.delenv("GANSPACE_IPCA_REFINE", raising=False)
    monkeypatch.setattr(ipca, "sketch_test_matrix", _jax_omega)


def _load(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _expect_close_refine_stats(got, ref):
    """The sketch's convergence statistics: the tail share to 1e-3 relative;
    the smallest relative eigengap, 1 - lambda_(i+1) / lambda_i, to 2e-3
    absolute, what eigenvalues held to 1e-3 relative (``act_stdev``'s bar
    on their roots) allow a ratio of two of them."""
    assert (got is None) == (ref is None)
    if ref is not None:
        assert set(got) == set(ref)
        np.testing.assert_allclose(got["sketch_tail_frac"], ref["sketch_tail_frac"], rtol=1e-3)
        np.testing.assert_allclose(got["min_rel_gap_topc"], ref["min_rel_gap_topc"], atol=2e-3)


def _min_cos(a, b, c):
    a, b = a.reshape(c, -1), b.reshape(c, -1)
    cos = np.abs(np.sum(a * b, axis=-1)
                 / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)))
    return float(cos.min())


def test_decomposition_matches_jax(tmp_path, monkeypatch, sketch_env):
    c = 6
    kw = dict(model="DCGAN", layer="deconv1", estimator="ipca", components=c, n=3000,
              batch_size=500)
    jax_model, port = _pair()
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    ref_path = jax_get_or_compute(JaxConfig(mesh_shape="1", **kw), JaxInstrumented(jax_model))
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    path = get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))

    assert path.name == ref_path.name == f"dcgan-None_deconv1_ipca_c{c}_n3000.npz"
    ref, got = _load(ref_path), _load(path)
    assert set(got) == set(ref)
    meta, meta_ref = json.loads(got["_meta"].item()), json.loads(ref["_meta"].item())
    assert set(meta) == set(meta_ref) and meta["refine_skipped"] is not None
    _expect_close_refine_stats(meta["refine_stats"], meta_ref["refine_stats"])
    assert {k: v for k, v in meta.items() if k != "refine_stats"} == \
        {k: v for k, v in meta_ref.items() if k != "refine_stats"}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert got["act_comp"].shape == (c, 1, 32, 8, 8)
    assert _min_cos(got["act_comp"], ref["act_comp"], c) > 0.99
    assert _min_cos(got["lat_comp"], ref["lat_comp"], c) > 0.99
    np.testing.assert_allclose(got["act_stdev"], ref["act_stdev"], rtol=1e-3)


def test_visualize_cli_matches_jax(tmp_path, monkeypatch, sketch_env):
    """``visualize --model TinyDCGAN --layer deconv1 --device cpu`` on a
    registered tiny DCGAN, as ``tests/test_visualize_cli.py`` drives the JAX
    package's: the same cache, grid tree and components."""
    jax_model, port = _pair()
    monkeypatch.setitem(jax_models._CUSTOM_MODELS, "TinyDCGAN", lambda oc, **kw: jax_model)
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyDCGAN", lambda oc, device, **kw: port)
    args = ["--model", "TinyDCGAN", "--layer", "deconv1", "--est", "ipca", "-c", "2",
            "-n", "2000", "-b", "500"]
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    jax_visualize.main(args + ["--mesh", "1"])
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    result = visualize.main(args + ["--device", "cpu"])

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in (root / "out").rglob("*.jpg"))
    names = tree(tmp_path / "torch")
    assert names == tree(tmp_path / "jax")
    summ = "out/DCGAN/deconv1/ipca/summ"
    assert len(names) == 24 and f"{summ}/components_ACT.jpg" in names
    assert f"{summ}/random_dirs_Z.jpg" in names
    assert result.images == 24 * 2 * 5
    got = visualize.load_components(result.cache)
    ref = visualize.load_components(tmp_path / "jax" / "cache" / "components" /
                                    result.cache.name)
    assert _min_cos(got.X_comp, ref.X_comp, 2) > 0.99
    assert _min_cos(got.Z_comp, ref.Z_comp, 2) > 0.99
