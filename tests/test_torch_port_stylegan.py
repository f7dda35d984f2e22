"""The port's StyleGAN (v1) against the JAX package's on identical weights.

Two small generators: 32 px (``tests/helpers.py``'s tiny config), where
every ``conv0_up`` is nearest 2x then kernel B's plain mode, and 128 px,
where the 128-px ``conv0_up`` is the fused upscale through kernel B's
stride-2 mode.  On the CPU each kernel wrapper takes its plain version, so
these tests hold the model around the kernels against the JAX package:
the image and every tap of ``tap_names()`` to < 1e-4 relative (the bar of
``tests/test_torch_parity.py``), in Z, in W and with 18 W+ latents, after
``set_noise_seed`` and with an activation edit; the pure tap function; and
the decomposition's caches under the host RNG stream
(``GANSPACE_DEVICE_RNG=0``)."""

import json

import numpy as np
import pytest
import torch

from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.models import stylegan as jax_sg1
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.models import get_instrumented_model, get_model
from ganspace_tpu_torch.models import stylegan as torch_sg1
from ganspace_tpu_torch.models.stylegan2 import StyleGAN2
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops.modconv import conv3x3, upsample_conv

CONFIGS = {"32px": dict(resolution=32, fmap_base=256),
           "128px": dict(resolution=128, fmap_base=512)}
REL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    """These small models gain nothing from many intra-op threads, and under
    several test workers per machine many threads per worker oversubscribe
    the cores; the previous count is restored after each test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(name, seed=3):
    params = jax_sg1.init_params(jax_sg1.SG1Config(**CONFIGS[name]), seed)
    jax_model = jax_sg1.StyleGAN(class_name="ffhq", cfg=jax_sg1.SG1Config(**CONFIGS[name]),
                                 params=params)
    port = torch_sg1.StyleGAN("ffhq", cfg=torch_sg1.SG1Config(**CONFIGS[name]),
                              params=params, device="cpu")
    return jax_model, port


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return _pair(request.param)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_bit_identical(name):
    ref = jax_sg1.init_params(jax_sg1.SG1Config(**CONFIGS[name]), 7)
    got = torch_sg1.init_params(torch_sg1.SG1Config(**CONFIGS[name]), 7)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_tap_names_and_default_config():
    cfg = torch_sg1.SG1Config()
    assert (cfg.resolution, cfg.w_dim, cfg.fmap_base, cfg.fmap_max) == (1024, 512, 8192, 512)
    assert cfg.block_channels() == (512, 512, 512, 512, 256, 128, 64, 32, 16)
    assert torch_sg1.CONFIGS == jax_sg1.CONFIGS
    _, port = _pair("32px")
    jax_model, _ = _pair("32px")
    assert port.tap_names() == jax_model.tap_names()
    assert port.get_max_latents() == 18
    assert set(port.state_dict()) == set(jax_model.params)


def _inputs(space):
    rs = np.random.RandomState({"z": 1, "w": 2, "wplus": 3}[space])
    base = rs.randn(2, 512).astype(np.float32)
    if space != "wplus":
        return [base]
    return [base + 0.3 * rs.randn(2, 512).astype(np.float32) for _ in range(18)]


def _run_both(models, inputs, taps, w_space, edit=None):
    jax_model, port = models
    for m in models:
        m.use_w() if w_space else m.use_z()
        m.set_noise_seed(4)
    jinst, tinst = JaxInstrumented(jax_model), InstrumentedModel(port)
    jinst.retain_layers(taps)
    tinst.retain_layers(taps)
    if edit is not None:
        jinst.edit_layer(edit[0], offset=edit[1])
        tinst.edit_layer(edit[0], offset=edit[1])
    ref_img = np.asarray(jax_model.forward(inputs if len(inputs) > 1 else inputs[0]))
    tin = [torch.from_numpy(a) for a in inputs]
    img = port.forward(tin if len(tin) > 1 else tin[0]).numpy()
    out = {"image": (img, ref_img)}
    for t in taps:
        r = jinst.retained_features()[t]
        out[t] = (tinst.retained_features()[t],
                  None if r is None else np.asarray(r))
    jinst.close()
    tinst.close()
    for m in models:
        m.set_noise_seed(0)
    return out


@pytest.mark.parametrize("space", ["z", "w", "wplus"])
def test_image_and_every_tap_match_jax(models, space):
    launches = (conv3x3.launches, upsample_conv.launches)
    taps = models[1].tap_names()
    out = _run_both(models, _inputs(space), taps, w_space=space != "z")
    assert (conv3x3.launches, upsample_conv.launches) == launches  # CPU: plain versions
    for name, (got, ref) in out.items():
        if space != "z" and name == "g_mapping":
            assert got is None and ref is None     # the mapping does not run in W
            continue
        got = got.numpy() if torch.is_tensor(got) else got
        assert got.shape == ref.shape, name
        assert np.isfinite(got).all(), name
        assert _rel(got, ref) < REL, (name, _rel(got, ref))


@pytest.mark.parametrize("layer", ["g_mapping", "g_synthesis.blocks.8x8.conv1"])
def test_activation_edit_matches_jax(models, layer):
    jax_model, port = models
    port.use_z()
    inst = InstrumentedModel(port)
    inst.retain_layer(layer)
    port.partial_forward(torch.zeros(1, 512), layer)
    shape = tuple(inst.retained_features()[layer].shape)
    inst.close()
    offset = 0.5 * np.random.RandomState(5).randn(*shape).astype(np.float32)
    taps = ("g_synthesis.blocks.32x32", "g_synthesis.torgb")
    out = _run_both(models, _inputs("z"), taps, w_space=False, edit=(layer, offset))
    for name, (got, ref) in out.items():
        got = got.numpy() if torch.is_tensor(got) else got
        assert _rel(got, ref) < REL, (name, _rel(got, ref))


def test_set_noise_seed_one_buffer_per_resolution():
    _, port = _pair("32px")
    port.set_noise_seed(9)
    for i, r in enumerate((4, 8, 16, 32)):
        ref = np.random.RandomState(9).randn(1, 1, r, r).astype(np.float32)
        assert np.array_equal(getattr(port, f"noise_{i}").numpy(), ref)


PURE_TAPS = ("g_mapping", "g_synthesis.blocks.8x8.conv0_up",
             "g_synthesis.blocks.16x16.epi2.style_mod.lin", "g_synthesis.torgb")


@pytest.fixture(scope="module")
def pair32():
    return _pair("32px")


@pytest.mark.parametrize("layer,w_space", [(t, w) for t in PURE_TAPS for w in (False, True)
                                           if not (w and t == "g_mapping")])
def test_pure_acts_matches_partial_forward_and_jax(pair32, layer, w_space):
    """(The mapping tap does not fire in W.)"""
    jax_model, port = pair32
    for m in (jax_model, port):
        m.use_w() if w_space else m.use_z()
    lat = np.random.RandomState(11).randn(5, 512).astype(np.float32)
    got = port.pure_acts_fn(layer)(torch.from_numpy(lat))
    inst = InstrumentedModel(port)
    inst.retain_layer(layer)
    port.partial_forward(torch.from_numpy(lat), layer)
    retained = inst.retained_features()[layer].reshape(5, -1)
    inst.close()
    ref = np.asarray(jax_model.pure_acts_fn(layer)(lat))
    assert got.shape == retained.shape == ref.shape
    assert torch.equal(got, retained)
    assert _rel(got, ref) < REL, _rel(got, ref)


def _load(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("layer,use_w,c", [("g_mapping", False, 8), ("g_mapping", True, 8),
                                           ("g_synthesis.blocks.4x4", False, 6)],
                         ids=["g_mapping-z", "g_mapping-w", "conv-tap"])
def test_decomposition_matches_jax(tmp_path, monkeypatch, layer, use_w, c):
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    kw = dict(model="StyleGAN", output_class="ffhq", layer=layer, estimator="ipca",
              components=c, n=4096, batch_size=512, use_w=use_w)
    jax_model, port = _pair("32px")
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    ref_path = jax_get_or_compute(JaxConfig(mesh_shape="1", **kw), JaxInstrumented(jax_model))
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    path = get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))

    assert path.name == ref_path.name
    ref, got = _load(ref_path), _load(path)
    assert set(got) == set(ref)
    assert json.loads(got["_meta"].item()) == json.loads(ref["_meta"].item())
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    for key in ("act_comp", "lat_comp"):
        a, b = got[key].reshape(c, -1), ref[key].reshape(c, -1)
        cos = np.abs(np.sum(a * b, axis=-1)
                     / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)))
        assert cos.min() > 0.99, (key, cos)
    np.testing.assert_allclose(got["act_stdev"], ref["act_stdev"], rtol=1e-3)
    comp = got["act_comp"].reshape(c, -1)
    assert np.abs(comp @ comp.T - np.eye(c)).max() < 1e-4


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device the entry points build on the card; with no card
    they refuse instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = torch_sg1.SG1Config(**CONFIGS["32px"])
    for build in (lambda: get_model("StyleGAN", "ffhq", cfg=tiny),
                  lambda: get_model("StyleGAN2", "ffhq"),
                  lambda: get_instrumented_model("StyleGAN", "ffhq", "g_mapping", cfg=tiny),
                  lambda: torch_sg1.StyleGAN("ffhq", cfg=tiny),
                  lambda: StyleGAN2("ffhq")):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    model = get_model("StyleGAN", "ffhq", device="cpu", cfg=tiny)
    assert model.device.type == "cpu"


def test_g_mapping_fused_stream_feeds_the_moments_tier(tmp_path, monkeypatch):
    """The default command's path at a small n: ``g_mapping`` in Z on the
    fused activation stream (device RNG), which feeds the moments tier
    (D = 512) with the regression and the random moments riding it, and no
    regression sweep.  (Its components are held to the host stream by the
    seed-control gate on the card, ``chip_smoke.py``.)"""
    import contextlib
    import io

    from ganspace_tpu_torch import decomposition

    def no_sweep(*args, **kwargs):
        raise AssertionError("the regression sweep ran on the fused stream")
    monkeypatch.setattr(decomposition, "regression", no_sweep)
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setenv("GANSPACE_FUSED_ACTS", "1")
    monkeypatch.delenv("GANSPACE_DEVICE_RNG", raising=False)
    _, port = _pair("32px")
    from ganspace_tpu_torch.estimators import ipca
    blocks = []
    moments_update = ipca.moments_update

    def recording(state, x):
        blocks.append(tuple(x.shape))
        return moments_update(state, x)
    monkeypatch.setattr(ipca, "moments_update", recording)
    cfg = Config(model="StyleGAN", output_class="ffhq", layer="g_mapping", estimator="ipca",
                 components=8, n=4096, batch_size=512, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        path = get_or_compute(cfg, InstrumentedModel(port))
    assert "Fitting fused activation stream: 8 blocks of 512" in out.getvalue()
    assert blocks == [(512, 512)] * 8                     # the moments tier, per block
    got = _load(path)
    meta = json.loads(got["_meta"].item())
    assert meta["device_rng"] is True and meta["fused_linreg"] is True
    comp = got["act_comp"].reshape(8, -1)
    assert np.abs(comp @ comp.T - np.eye(8)).max() < 1e-4
    lat = got["lat_comp"].reshape(8, -1)
    np.testing.assert_allclose(np.linalg.norm(lat, axis=-1), 1.0, atol=1e-5)
    assert (got["random_stdevs"] > 0).all()
