"""The port's ProGAN against the JAX package's on identical weights.

Two small generators: ``tests/helpers.py``'s tiny config (sizes 64, 32,
32, 16) and one whose tail has stride-1 3x3 convs at 64 and 32 channels
(sizes 64, 64, 64, 32), where the JAX package's block-layout tail reaches
its Pallas conv under ``GANSPACE_PALLAS_CONV=1``.  On the CPU each kernel
wrapper takes its plain version, so these tests hold the model around the
kernels against the JAX package: the image and every tap to < 1e-4
relative with the JAX package's space-to-depth tail on, off, and on with
the Pallas conv run in interpret mode (as ``tests/test_pallas_blockconv.py``
runs it); ``layer1``'s flipped read of its kernel; the reference's
``partial_forward`` properties; the host latents bit for bit; the pure tap
function; and the decomposition (``layer2`` on the moments tier, a conv
tap on the sketch tier) and the visualize CLI against the JAX package's."""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ganspace_tpu import models as jax_models
from ganspace_tpu.apps import visualize as jax_visualize
from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.models import proggan as jax_pg
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented
from ganspace_tpu.ops.pallas import blockconv

from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.models import get_instrumented_model, get_model
from ganspace_tpu_torch.models import proggan as torch_pg
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops.modconv import conv3x3, upsample_conv

SIZES = {"tiny": (64, 32, 32, 16), "pallas": (64, 64, 64, 32)}
REL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    """Small models gain nothing from many intra-op threads, and under
    several test workers many threads per worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(name="tiny", seed=3):
    sizes = SIZES[name]
    params = jax_pg.init_params(jax_pg.ProGANConfig(sizes), seed)
    jax_model = jax_pg.ProGAN("bedroom", cfg=jax_pg.ProGANConfig(sizes), params=params)
    port = torch_pg.ProGAN("bedroom", cfg=torch_pg.ProGANConfig(sizes), params=params,
                           device="cpu")
    return jax_model, port


@pytest.mark.parametrize("name", sorted(SIZES))
def test_init_params_bit_identical(name):
    ref = jax_pg.init_params(jax_pg.ProGANConfig(SIZES[name]), 7)
    got = torch_pg.init_params(torch_pg.ProGANConfig(SIZES[name]), 7)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_schedules_plans_and_taps_match_jax():
    assert torch_pg.VALID_CLASSES == jax_pg.VALID_CLASSES
    assert torch_pg.SIZES_FOR_RESOLUTION == jax_pg.SIZES_FOR_RESOLUTION
    for res in torch_pg.SIZES_FOR_RESOLUTION:
        assert (torch_pg.ProGANConfig.for_resolution(res).layer_plan()
                == jax_pg.ProGANConfig.for_resolution(res).layer_plan())
    jax_model, port = _pair("pallas")
    assert port.tap_names() == jax_model.tap_names()
    assert port.tap_names()[-1] == "output_16x16"
    assert set(port.state_dict()) == set(jax_model.params)
    assert port.name == jax_model.name == "ProGAN-bedroom"
    assert port.resolution == jax_model.resolution == 16
    assert port.get_max_latents() == 1 and port.latent_space_name() == "Z"
    with pytest.raises(ValueError, match="Invalid LSUN class"):
        torch_pg.ProGAN("husky", cfg=torch_pg.ProGANConfig(SIZES["tiny"]), device="cpu")


def test_full_width_256_builds_on_the_card_by_default(monkeypatch, tmp_path):
    """ProGAN-256 at full width: 18.34 M parameters, the JAX package's count;
    the entry points refuse without a card and build on the CPU when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("GANCONTROL_CHECKPOINT_DIR", str(tmp_path))
    for build in (lambda: get_model("ProGAN", "bedroom"),
                  lambda: torch_pg.ProGAN("bedroom")):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    model = get_model("ProGAN", "bedroom", device="cpu")
    n = sum(p.numel() for p in model.parameters())
    ref = jax_pg.init_params(jax_pg.ProGANConfig.for_resolution(256), 0)
    assert sum(v.size for v in ref.values()) == n == 18_344_995
    assert model.resolution == 256 and model.tap_names()[-1] == "output_256x256"
    assert (sum(m.up for m in model.children()), len(list(model.children()))) == (6, 15)


def _run_both(pair, z, taps, edit=None):
    """(port, JAX) image and retained taps of one forward over ``z``."""
    jax_model, port = pair
    jinst, tinst = JaxInstrumented(jax_model), InstrumentedModel(port)
    jinst.retain_layers(taps)
    tinst.retain_layers(taps)
    if edit is not None:
        jinst.edit_layer(edit[0], offset=edit[1])
        tinst.edit_layer(edit[0], offset=edit[1])
    ref_img = np.asarray(jax_model.forward(z))
    img = port.forward(torch.tensor(z)).numpy()
    out = {"image": (img, ref_img)}
    for t in taps:
        out[t] = (tinst.retained_features()[t].numpy(), np.asarray(jinst.retained_features()[t]))
    jinst.close()
    tinst.close()
    return out


@pytest.fixture
def pallas_calls(monkeypatch):
    """``GANSPACE_PALLAS_CONV=1`` with the JAX package's Pallas block conv
    run in interpret mode; the list of its calls."""
    calls = []
    orig = blockconv.conv3x3_blocks_pallas

    def interpreted(x, w, **kw):
        calls.append(tuple(x.shape))
        return orig(x, w, interpret=True)
    monkeypatch.setattr(blockconv, "conv3x3_blocks_pallas", interpreted)
    monkeypatch.setenv("GANSPACE_PALLAS_CONV", "1")
    return calls


@pytest.mark.parametrize("name,setting", [
    ("tiny", "s2d"), ("tiny", "nchw"), ("tiny", "pallas"),
    ("pallas", "s2d"), ("pallas", "nchw"), ("pallas", "pallas")])
def test_image_and_every_tap_match_jax(monkeypatch, request, name, setting):
    monkeypatch.setenv("GANSPACE_S2D", "0" if setting == "nchw" else "1")
    calls = request.getfixturevalue("pallas_calls") if setting == "pallas" else None
    pair = _pair(name)
    z = np.asarray(pair[0].sample_latent(3, seed=5))
    launches = (conv3x3.launches, upsample_conv.launches)
    out = _run_both(pair, z, pair[1].tap_names())
    assert (conv3x3.launches, upsample_conv.launches) == launches  # CPU: plain versions
    if calls is not None:
        # the stride-1 3x3 convs of the block-layout tail at C = 32 and 64
        # (C = 16 is not a Pallas shape)
        want = {"tiny": {32 * 4}, "pallas": {64 * 4, 32 * 4}}[name]
        assert {shape[-1] for shape in calls} == want
    for tap, (got, ref) in out.items():
        assert got.shape == ref.shape, tap
        assert np.isfinite(got).all(), tap
        assert _rel(got, ref) < REL, (tap, _rel(got, ref))
    assert out["image"][0].shape == (3, 3, 16, 16)


@pytest.mark.parametrize("layer", ["layer3", "layer4"])
def test_activation_edit_matches_jax(monkeypatch, layer):
    monkeypatch.setenv("GANSPACE_S2D", "0")
    pair = _pair("pallas")
    z = np.asarray(pair[0].sample_latent(2, seed=6))
    offset = np.random.RandomState(1).randn(64, 8, 8).astype(np.float32)
    out = _run_both(pair, z, ["output_16x16"], edit=(layer, offset))
    for tap, (got, ref) in out.items():
        assert _rel(got, ref) < REL, tap


def test_layer1_reads_its_kernel_flipped():
    """``layer1`` as a product equals the 4x4 correlation with padding 3 of
    the 1x1 map on a weight with no symmetry (the flip matters)."""
    _, port = _pair("tiny")
    layer = port.layer1
    w = layer.conv.weight
    assert not torch.equal(w, w.flip(2, 3))
    z = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
    ref = F.leaky_relu(F.conv2d(x[:, :, None, None], w, padding=3) * layer.scale
                       + layer.wscale.b.reshape(1, -1, 1, 1), 0.2)
    got = layer(z[:, :, None, None])
    assert got.shape == (4, 32, 4, 4)
    assert _rel(got.numpy(), ref.numpy()) < 1e-6
    assert layer.scale == pytest.approx(math.sqrt(2.0) / 4 / math.sqrt(64))


@pytest.mark.parametrize("layer", ["layer2", "layer5", "output_16x16"])
def test_partial_forward_properties(layer):
    """The reference's ``partial_forward_test``: the partial run retains
    what the full run retains at the tap, the same input gives the same
    activations and another input others."""
    _, port = _pair("tiny")
    inst = InstrumentedModel(port)
    inst.retain_layer(layer)
    z = port.sample_latent(2, seed=4)
    port.forward(z)
    full = inst.retained_layer(layer, clear=True)
    assert port.partial_forward(z, layer) is None
    part = inst.retained_layer(layer, clear=True)
    port.partial_forward(z, layer)
    again = inst.retained_layer(layer, clear=True)
    port.partial_forward(port.sample_latent(2, seed=5), layer)
    other = inst.retained_layer(layer)
    assert torch.equal(part, full) and torch.equal(again, part)
    assert not torch.allclose(other, part)


def test_host_latents_bit_identical():
    """Seeded draws, and the seedless host stream after ``seed_host_rng(s)``
    (numpy's global stream in the JAX package), prefetched batches too."""
    jax_model, port = _pair("tiny")
    assert np.array_equal(port.sample_latent(4, seed=9).numpy(),
                          np.asarray(jax_model.sample_latent(4, seed=9)))
    np.random.seed(1)
    ref = [np.array(jax_model.sample_latent(4))] + [
        np.asarray(z) for z in jax_model.sample_latents_prefetched(3, 5)]
    port.seed_host_rng(1)
    got = [port.sample_latent(4)] + port.sample_latents_prefetched(3, 5, keep_on="cpu")
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("layer", ["layer2", "layer6"])
def test_pure_acts_matches_partial_forward_and_jax(layer):
    jax_model, port = _pair("pallas")
    z = port.sample_latent(3, seed=2)
    inst = InstrumentedModel(port)
    inst.retain_layer(layer)
    port.partial_forward(z, layer)
    want = inst.retained_layer(layer).reshape(3, -1)
    got = port.pure_acts_fn(layer)(z)
    assert torch.equal(got, want)
    fn, params = jax_model.pure_acts_fn_p(layer)
    assert _rel(got.numpy(), np.asarray(fn(params, jnp.asarray(z.numpy())))) < REL


# -- the decomposition and the CLI against the JAX package -------------------

def _jax_omega(d, l):
    return np.array(jax.random.normal(jax.random.PRNGKey(0xA5), (d, l), jnp.float32))


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


@pytest.mark.parametrize("layer,max_d,c", [("layer2", None, 8), ("layer4", "1024", 6)],
                         ids=["moments-tier", "sketch-tier"])
def test_decomposition_matches_jax(tmp_path, monkeypatch, layer, max_d, c):
    """``layer2`` (D = 32 * 4 * 4 here, 512 * 4 * 4 = 8192 at 256 px) on the
    moments tier; ``layer4`` (D = 32 * 8 * 8) on the sketch tier through a
    lowered ``GANSPACE_IPCA_MOMENTS_MAX_D``, the port with JAX's Omega.  On
    the host stream: the same file name, npz keys and ``_meta``."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    monkeypatch.delenv("GANSPACE_IPCA_REFINE", raising=False)
    if max_d is not None:
        monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", max_d)
        monkeypatch.setattr(ipca, "sketch_test_matrix", _jax_omega)
    kw = dict(model="ProGAN", output_class="bedroom", layer=layer, estimator="ipca",
              components=c, n=3000, batch_size=500)
    jax_model, port = _pair("tiny")
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    ref_path = jax_get_or_compute(JaxConfig(mesh_shape="1", **kw), JaxInstrumented(jax_model))
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    path = get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))

    assert path.name == ref_path.name == f"progan-bedroom_{layer}_ipca_c{c}_n3000.npz"
    ref, got = _load(ref_path), _load(path)
    assert set(got) == set(ref)
    meta, meta_ref = json.loads(got["_meta"].item()), json.loads(ref["_meta"].item())
    assert set(meta) == set(meta_ref)
    assert (meta["refine_skipped"] is None) == (max_d is None)    # the tier taken
    _expect_close_refine_stats(meta["refine_stats"], meta_ref["refine_stats"])
    assert {k: v for k, v in meta.items() if k != "refine_stats"} == \
        {k: v for k, v in meta_ref.items() if k != "refine_stats"}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert _min_cos(got["act_comp"], ref["act_comp"], c) > 0.99
    assert _min_cos(got["lat_comp"], ref["lat_comp"], c) > 0.99
    np.testing.assert_allclose(got["act_stdev"], ref["act_stdev"], rtol=1e-3)
    comp = got["act_comp"].reshape(c, -1)
    assert np.abs(comp @ comp.T - np.eye(c)).max() < 1e-4


def test_visualize_cli_matches_jax(tmp_path, monkeypatch):
    """``visualize --model TinyProGAN --class bedroom --layer layer2 --device
    cpu`` on a registered tiny ProGAN: the same cache name, the JAX
    package's grid tree (activation and latent grids) and components."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    jax_model, port = _pair("tiny")
    monkeypatch.setitem(jax_models._CUSTOM_MODELS, "TinyProGAN", lambda oc, **kw: jax_model)
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyProGAN", lambda oc, device, **kw: port)
    args = ["--model", "TinyProGAN", "--class", "bedroom", "--layer", "layer2",
            "--est", "ipca", "-c", "2", "-n", "2000", "-b", "500"]
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    jax_visualize.main(args + ["--mesh", "1"])
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    result = visualize.main(args + ["--device", "cpu"])

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in (root / "out").rglob("*.jpg"))
    names = tree(tmp_path / "torch")
    assert names == tree(tmp_path / "jax")
    summ = "out/ProGAN-bedroom/layer2/ipca/summ"
    assert len(names) == 24 and f"{summ}/components_ACT.jpg" in names
    assert f"{summ}/samp9_real_Z.jpg" in names
    assert result.images == 24 * 2 * 5
    got = visualize.load_components(result.cache)
    ref = visualize.load_components(tmp_path / "jax" / "cache" / "components" /
                                    result.cache.name)
    assert _min_cos(got.X_comp, ref.X_comp, 2) > 0.99
    assert _min_cos(got.Z_comp, ref.Z_comp, 2) > 0.99


def test_get_instrumented_model_annotates_like_jax(monkeypatch, tmp_path):
    """``get_instrumented_model("ProGAN", ...)`` with a config: the feature
    shape of each tap and the latent shape, as the JAX package annotates."""
    cfg = SIZES["tiny"]
    inst = get_instrumented_model("ProGAN", "kitchen", ["layer2", "layer5"], "cpu",
                                  cfg=torch_pg.ProGANConfig(cfg))
    ref = jax_models.get_instrumented_model("ProGAN", "kitchen", ["layer2", "layer5"],
                                            cfg=jax_pg.ProGANConfig(cfg))
    assert inst.feature_shape == {k: tuple(v) for k, v in ref.feature_shape.items()}
    assert inst.input_shape == tuple(ref.input_shape) == (1, 64)
