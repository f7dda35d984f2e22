"""The port's conv-tap leg against the JAX package's, end to end.

Both packages run the same small StyleGAN2 weights up to a 4-D tap
(``convs.1``: 64 x 8 x 8, D = 4096) with ``GANSPACE_IPCA_MOMENTS_MAX_D``
lowered to 1024, so the stream takes the Nystrom sketch tier, its adaptive
refine sweep and the separate least-squares regression sweep.  The JAX
package runs its host-RNG path (``GANSPACE_DEVICE_RNG=0``, one device), so
both see bit-identical latents, and the port sketches against JAX's test
matrix Omega (its own draw is replaced), so the two differ only by float32
reassociation.  Bars: identical cache name, npz keys and ``_meta`` keys, the
same refine decision, min per-component |cos| > 0.99 (the ROADMAP bar) for
``act_comp`` and ``lat_comp``, and 1e-3 relative on the statistics.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ganspace_tpu import models as jax_models
from ganspace_tpu.apps import visualize as jax_visualize
from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.edit import create_strip_centered as jax_strip
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.edit import create_strip_centered
from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel

CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))
TAP, C = "convs.1", 8
STAT_RTOL = 1e-3


def _models():
    cfg = dict(resolution=32, channels=CHANNELS)
    params = jax_sg2.init_params(jax_sg2.SG2Config(**cfg), seed=3)
    jax_model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jax_sg2.SG2Config(**cfg),
                                  params=params)
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(**cfg),
                               params=params, device="cpu")
    return jax_model, port


def _jax_omega(d, l):
    return np.array(jax.random.normal(jax.random.PRNGKey(0xA5), (d, l),
                                        jnp.float32))


@pytest.fixture
def sketch_env(monkeypatch):
    """Host RNG for JAX, the sketch tier at D = 4096, a shared Omega."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "1024")
    monkeypatch.delenv("GANSPACE_IPCA_REFINE", raising=False)
    monkeypatch.setattr(ipca, "sketch_test_matrix", _jax_omega)


def _load(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _min_cos(a, b, c=C):
    a, b = a.reshape(c, -1), b.reshape(c, -1)
    return float(np.abs(np.sum(a * b, axis=-1)).min())


def _both(tmp_path, monkeypatch, **kw):
    jax_model, port = _models()
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    ref_path = jax_get_or_compute(JaxConfig(mesh_shape="1", **kw),
                                  JaxInstrumented(jax_model))
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    path = get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))
    return ref_path, path


@pytest.mark.parametrize("use_w", [False, True], ids=["z", "w"])
def test_convtap_decomposition_matches_jax(tmp_path, monkeypatch, sketch_env,
                                           use_w):
    kw = dict(model="StyleGAN2", output_class="ffhq", layer=TAP, estimator="ipca",
              components=C, n=4000, batch_size=1000, use_w=use_w)
    ref_path, path = _both(tmp_path, monkeypatch, **kw)
    assert path.name == ref_path.name == (
        f"stylegan2-ffhq_{TAP}_ipca_c{C}_n4000{'_w' if use_w else ''}.npz")
    ref, got = _load(ref_path), _load(path)
    assert set(got) == set(ref)
    meta, meta_ref = json.loads(got["_meta"].item()), json.loads(ref["_meta"].item())
    assert set(meta) == set(meta_ref)
    assert meta["refine_skipped"] is meta_ref["refine_skipped"] is False
    assert set(meta["refine_stats"]) == set(meta_ref["refine_stats"])
    for k, v in meta_ref["refine_stats"].items():
        np.testing.assert_allclose(meta["refine_stats"][k], v, rtol=STAT_RTOL)
    assert {k: v for k, v in meta.items() if k != "refine_stats"} == \
        {k: v for k, v in meta_ref.items() if k != "refine_stats"}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert got["act_comp"].shape == (C, 1, 64, 8, 8)
    act_cos = _min_cos(got["act_comp"], ref["act_comp"])
    lat_cos = _min_cos(got["lat_comp"], ref["lat_comp"])
    print(f"\nconv tap {TAP} ({'W' if use_w else 'Z'}): min |cos| act_comp "
          f"{act_cos:.6f}, lat_comp {lat_cos:.6f}")
    assert act_cos > 0.99 and lat_cos > 0.99, (act_cos, lat_cos)
    for k in ("act_stdev", "var_ratio", "random_stdevs", "lat_stdev"):
        np.testing.assert_allclose(got[k], ref[k], rtol=STAT_RTOL, err_msg=k)
    if not use_w:
        np.testing.assert_array_equal(got["lat_stdev"], np.ones(C, np.float32))
    np.testing.assert_allclose(got["act_mean"], ref["act_mean"], atol=1e-5)
    np.testing.assert_allclose(got["lat_mean"], ref["lat_mean"], atol=1e-5)
    comp = got["act_comp"].reshape(C, -1)
    assert np.abs(comp @ comp.T - np.eye(C)).max() < 1e-4


def test_refine_interrupt_saves_the_first_pass_under_partial(tmp_path, monkeypatch,
                                                             sketch_env):
    """An interrupt in the refine sweep falls back to the completed first
    pass and saves it under ``_partial``, never under the canonical name."""
    kw = dict(model="StyleGAN2", output_class="ffhq", layer=TAP, estimator="ipca",
              components=C, n=4000, batch_size=1000, device="cpu")
    fit_partial = ipca.IPCAEstimator.fit_partial

    def interrupted(self, x):
        if self._refined and self.n_samples_seen_ > 0:
            raise KeyboardInterrupt
        return fit_partial(self, x)

    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "cut"))
    monkeypatch.setattr(ipca.IPCAEstimator, "fit_partial", interrupted)
    with pytest.raises(SystemExit):
        get_or_compute(Config(**kw), InstrumentedModel(_models()[1]))
    monkeypatch.setattr(ipca.IPCAEstimator, "fit_partial", fit_partial)
    saved = sorted(p.name for p in (tmp_path / "cut" / "cache" / "components").iterdir())
    assert saved == [f"stylegan2-ffhq_{TAP}_ipca_c{C}_n4000_partial.npz"]
    cut = _load(tmp_path / "cut" / "cache" / "components" / saved[0])
    meta = json.loads(cut["_meta"].item())
    assert meta["refine_skipped"] is None and meta["refine_stats"] is not None

    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "single"))
    monkeypatch.setenv("GANSPACE_IPCA_REFINE", "never")
    single = _load(get_or_compute(Config(**kw), InstrumentedModel(_models()[1])))
    assert json.loads(single["_meta"].item())["refine_skipped"] is True
    for k in ("act_comp", "act_stdev", "var_ratio", "lat_comp"):
        np.testing.assert_array_equal(cut[k], single[k], err_msg=k)


def test_activation_strip_matches_jax():
    """A centered activation-mode strip at the 4-D tap: the same offset
    (projection onto the component, then sigma * stdev steps) and frames."""
    jax_model, port = _models()
    jax_inst, inst = JaxInstrumented(jax_model), InstrumentedModel(port)
    rs = np.random.RandomState(0)
    x_comp = rs.randn(1, 1, 64, 8, 8).astype(np.float32)
    x_comp /= np.linalg.norm(x_comp)
    act_mean = 0.1 * rs.randn(1, 64, 8, 8).astype(np.float32)
    z = port.sample_latent(1, seed=12).numpy()
    z_comp = np.zeros((1, 1, 512), np.float32)
    args = (TAP, [z], x_comp, z_comp, np.float32(3.0), np.float32(1.0),
            act_mean, np.zeros((1, 512), np.float32), 2.0, 0, -1, 5)
    ref = jax_strip(jax_inst, "activation", *args)[0]
    got = create_strip_centered(inst, "activation", *args)[0]
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (32, 32, 3)
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4)
    # the offset moves the image: the ends of the strip differ
    assert np.abs(got[0] - got[-1]).max() > 1e-2


def test_convtap_cli_matches_jax(tmp_path, monkeypatch, sketch_env):
    """``visualize --layer convs.1 --est ipca --device cpu``: the sketch
    tier with refine and the regression run, and the summary grids carry
    the JAX package's names, activation (``_ACT``) beside latent (``_Z``)."""
    jax_model, port = _models()
    monkeypatch.setitem(jax_models._CUSTOM_MODELS, "TinyStyleGAN2",
                        lambda oc, **kw: jax_model)
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyStyleGAN2", lambda oc, device, **kw: port)
    args = ["--model", "TinyStyleGAN2", "--class", "ffhq", "--layer", TAP,
            "--est", "ipca", "-c", "2", "-n", "2000", "-b", "500"]

    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    jax_visualize.main(args + ["--mesh", "1"])
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    result = visualize.main(args + ["--device", "cpu"])

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in (root / "out").rglob("*.jpg"))

    names = tree(tmp_path / "torch")
    assert names == tree(tmp_path / "jax")
    summ = f"out/StyleGAN2-ffhq/{TAP}/ipca/summ"
    assert len(names) == 24
    assert {f"{summ}/components_ACT.jpg", f"{summ}/components_Z.jpg"} <= set(names)
    assert result.images == 24 * 2 * 5                 # grids x rows x frames
    assert set(result.phases) == {"setup", "pass1", "refine", "finish",
                                  "regression", "baselines", "npz"}
    got = visualize.load_components(result.cache)
    ref = visualize.load_components(
        tmp_path / "jax" / "cache" / "components" / result.cache.name)
    assert got.meta["refine_skipped"] is ref.meta["refine_skipped"] is False
    assert _min_cos(got.X_comp, ref.X_comp, c=2) > 0.99
    assert _min_cos(got.Z_comp, ref.Z_comp, c=2) > 0.99
