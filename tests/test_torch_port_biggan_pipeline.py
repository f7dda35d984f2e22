"""The BigGAN leg of the port's decomposition and visualize against the JAX
package's, on a small BigGAN (``tests/helpers.py``'s tiny config).

``generator.gen_z`` (D = 4 * 4 * 128 = 2048 here, 32768 at 512 px) takes
the Nystrom sketch tier, as at full width, with
``GANSPACE_IPCA_MOMENTS_MAX_D`` lowered to 1024.  On the host stream
(``GANSPACE_DEVICE_RNG=0``) both packages draw the same truncated latents
from the same seeds, and the port sketches against JAX's Omega, so the
caches differ only by float32 reassociation: identical names, keys and
``_meta``, min |cos| > 0.99.  The default environment's fused activation
stream draws the truncated latents on the device: orthonormal components,
every latent within +-2 truncation, the regression riding the stream."""

import contextlib
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ganspace_tpu import models as jax_models
from ganspace_tpu.apps import visualize as jax_visualize
from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.edit import create_strip_centered as jax_strip
from ganspace_tpu.models import biggan as jax_bg
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch import decomposition
from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.edit import create_strip_centered
from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.models import biggan as torch_bg
from ganspace_tpu_torch.models.base import InstrumentedModel

TINY = dict(output_dim=32, z_dim=16, channel_width=8,
            layers=((False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2)),
            attention_layer_position=2)
TAP, C, TRUNC = "generator.gen_z", 8, 0.7
STAT_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _models(truncation=TRUNC):
    params = jax_bg.init_params(jax_bg.BigGANConfig(**TINY), seed=3)
    jax_model = jax_bg.BigGAN(128, "husky", truncation=truncation,
                              cfg=jax_bg.BigGANConfig(**TINY), params=params)
    port = torch_bg.BigGAN(128, "husky", truncation=truncation,
                           cfg=torch_bg.BigGANConfig(**TINY), params=params, device="cpu")
    return jax_model, port


def _jax_omega(d, l):
    return np.array(jax.random.normal(jax.random.PRNGKey(0xA5), (d, l), jnp.float32))


@pytest.fixture
def sketch_env(monkeypatch):
    """Host RNG, the sketch tier at D = 2048, JAX's Omega in the port."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "1024")
    monkeypatch.delenv("GANSPACE_IPCA_REFINE", raising=False)
    monkeypatch.setattr(ipca, "sketch_test_matrix", _jax_omega)


def _load(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _min_cos(a, b, c=C):
    a, b = a.reshape(c, -1), b.reshape(c, -1)
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return float(np.abs(np.sum(a * b, axis=-1)).min())


def test_gen_z_cache_host_stream_matches_jax(tmp_path, monkeypatch, sketch_env):
    kw = dict(model="BigGAN-128", output_class="husky", layer=TAP, estimator="ipca",
              components=C, n=4000, batch_size=1000)
    jax_model, port = _models()
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    ref_path = jax_get_or_compute(JaxConfig(mesh_shape="1", **kw), JaxInstrumented(jax_model))
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    path = get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))

    assert path.name == ref_path.name == f"biggan-128-husky_{TAP}_ipca_c{C}_n4000.npz"
    ref, got = _load(ref_path), _load(path)
    assert set(got) == set(ref)
    meta, meta_ref = json.loads(got["_meta"].item()), json.loads(ref["_meta"].item())
    assert set(meta) == set(meta_ref)
    assert meta["device_rng"] is meta_ref["device_rng"] is False
    assert meta["refine_skipped"] is meta_ref["refine_skipped"]
    # gen_z is linear in its 32-wide cond, so the sketch's tail share is
    # rounding on either side (atol)
    for k, v in (meta_ref["refine_stats"] or {}).items():
        np.testing.assert_allclose(meta["refine_stats"][k], v, rtol=STAT_RTOL, atol=1e-6)
    assert {k: v for k, v in meta.items() if k != "refine_stats"} == \
        {k: v for k, v in meta_ref.items() if k != "refine_stats"}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert got["act_comp"].shape == (C, 1, 2048) and got["lat_comp"].shape == (C, 1, 16)
    assert _min_cos(got["act_comp"], ref["act_comp"]) > 0.99
    assert _min_cos(got["lat_comp"], ref["lat_comp"]) > 0.99
    for k in ("act_stdev", "var_ratio", "random_stdevs"):
        np.testing.assert_allclose(got[k], ref[k], rtol=STAT_RTOL, err_msg=k)
    np.testing.assert_array_equal(got["lat_stdev"], np.ones(C, np.float32))
    np.testing.assert_allclose(got["act_mean"], ref["act_mean"], atol=1e-5)
    # the host latents are JAX's bit for bit, so their means agree closely
    np.testing.assert_allclose(got["lat_mean"], ref["lat_mean"], atol=1e-6)


def test_fused_stream_draws_truncated_latents_on_the_device(tmp_path, monkeypatch):
    """The default environment at gen_z: the fused activation stream (its
    latents the device's truncated draw) into the sketch tier, with the
    regression riding it and no regression sweep."""
    def no_sweep(*args, **kwargs):
        raise AssertionError("the regression sweep ran on the fused stream")
    monkeypatch.setattr(decomposition, "regression", no_sweep)
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setenv("GANSPACE_FUSED_ACTS", "1")
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "1024")
    monkeypatch.delenv("GANSPACE_DEVICE_RNG", raising=False)
    drawn = []
    draw = torch_bg.device_truncated

    def recording(gen, n, dim, truncation):
        z = draw(gen, n, dim, truncation)
        drawn.append(z)
        return z
    monkeypatch.setattr(torch_bg, "device_truncated", recording)
    _, port = _models()
    cfg = Config(model="BigGAN-128", output_class="husky", layer=TAP, estimator="ipca",
                 components=C, n=4000, batch_size=500, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        path = get_or_compute(cfg, InstrumentedModel(port))
    assert "Fitting fused activation stream: 8 blocks of 500" in out.getvalue()
    z = torch.cat(drawn)
    assert len(drawn) >= 8 and z.shape[1] == 16
    assert float(z.abs().max()) <= 2 * TRUNC
    got = _load(path)
    meta = json.loads(got["_meta"].item())
    assert meta["device_rng"] is True and meta["fused_linreg"] is True
    comp = got["act_comp"].reshape(C, -1)
    assert np.abs(comp @ comp.T - np.eye(C)).max() < 1e-4
    lat = got["lat_comp"].reshape(C, -1)
    np.testing.assert_allclose(np.linalg.norm(lat, axis=-1), 1.0, atol=1e-5)
    assert (got["random_stdevs"] > 0).all() and np.isfinite(got["act_stdev"]).all()


@pytest.mark.parametrize("mode", ["latent", "activation"])
def test_layerwise_edit_strip_matches_jax(mode):
    """An edit strip over a window of latent slots (the latent mode) or at
    the tap (the activation mode), centered, against the JAX package's."""
    jax_model, port = _models()
    rs = np.random.RandomState(2)
    z = rs.randn(1, 16).astype(np.float32) * 0.5
    x_comp = rs.randn(1, 1, 2048).astype(np.float32)
    z_comp = rs.randn(1, 1, 16).astype(np.float32)
    z_comp /= np.linalg.norm(z_comp)
    args = (mode, TAP, [z], x_comp, z_comp, 1.5, 1.0, np.zeros((1, 2048), np.float32),
            np.zeros((1, 16), np.float32), 2.0, 1, 4)
    ref = jax_strip(JaxInstrumented(jax_model), *args, num_frames=3)[0]
    got = create_strip_centered(InstrumentedModel(port), *args, num_frames=3)[0]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4)
    assert np.abs(got[0] - got[-1]).max() > 1e-3


def test_visualize_cli_matches_jax(tmp_path, monkeypatch, sketch_env):
    """``visualize --layer generator.gen_z --device cpu`` on a registered tiny
    BigGAN: the same cache and the JAX package's grid tree, activation
    (``_ACT``) beside latent (``_Z``) grids, under the model's name."""
    jax_model, port = _models(truncation=1.0)
    monkeypatch.setitem(jax_models._CUSTOM_MODELS, "TinyBigGAN", lambda oc, **kw: jax_model)
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyBigGAN", lambda oc, device, **kw: port)
    args = ["--model", "TinyBigGAN", "--class", "husky", "--layer", TAP,
            "--est", "ipca", "-c", "2", "-n", "2000", "-b", "500"]
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    jax_visualize.main(args + ["--mesh", "1"])
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    result = visualize.main(args + ["--device", "cpu"])

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in (root / "out").rglob("*.jpg"))
    names = tree(tmp_path / "torch")
    assert names == tree(tmp_path / "jax")
    summ = f"out/BigGAN-128-husky-t1.0/{TAP}/ipca/summ"
    assert len(names) == 24 and f"{summ}/components_ACT.jpg" in names
    assert f"{summ}/samp9_real_Z.jpg" in names
    assert result.images == 24 * 2 * 5
    got = visualize.load_components(result.cache)
    ref = visualize.load_components(tmp_path / "jax" / "cache" / "components" /
                                    result.cache.name)
    assert _min_cos(got.X_comp, ref.X_comp, c=2) > 0.99
    assert _min_cos(got.Z_comp, ref.Z_comp, c=2) > 0.99
