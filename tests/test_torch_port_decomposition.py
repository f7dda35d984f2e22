"""The port's decomposition and visualize CLI against the JAX package's.

Both packages run ``--use_w --layer style --est ipca`` on the same small
StyleGAN2 weights, the JAX package on its host RNG stream
(``GANSPACE_DEVICE_RNG=0``) and on one device, so the two see bit-identical
latents."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ganspace_tpu import models as jax_models
from ganspace_tpu.apps import visualize as jax_visualize
from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops.moments import centered_gram


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))
FIXTURE = (Path(__file__).resolve().parent.parent / "notebooks" / "cache"
           / "components" / "stylegan2-None_style_ipca_c8_n256_w.npz")


def _models():
    jcfg = jax_sg2.SG2Config(resolution=32, channels=CHANNELS)
    params = jax_sg2.init_params(jcfg, seed=3)
    jax_model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jcfg, params=params)
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=32,
                                                              channels=CHANNELS),
                               params=params, device="cpu")
    return jax_model, port


def _load(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def test_decomposition_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    kw = dict(model="StyleGAN2", output_class="ffhq", layer="style",
              estimator="ipca", components=8, n=8192, use_w=True)
    jax_model, port = _models()

    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    ref_path = jax_get_or_compute(JaxConfig(mesh_shape="1", **kw),
                                  JaxInstrumented(jax_model))
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    launches = centered_gram.launches
    path = get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))
    assert centered_gram.launches == launches      # CPU: the plain version

    assert path.name == ref_path.name == "stylegan2-ffhq_style_ipca_c8_n8192_w.npz"
    ref, got = _load(ref_path), _load(path)
    assert set(got) == set(ref)
    assert json.loads(got["_meta"].item()) == json.loads(ref["_meta"].item())
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    cos = np.abs(np.sum(got["act_comp"].reshape(8, -1)
                        * ref["act_comp"].reshape(8, -1), axis=-1))
    assert cos.min() > 0.99, cos
    for k in ("act_stdev", "var_ratio", "lat_stdev", "random_stdevs"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["act_mean"], ref["act_mean"], atol=1e-5)
    comp = got["act_comp"].reshape(8, -1)
    assert np.abs(comp @ comp.T - np.eye(8)).max() < 1e-4


def test_committed_fixture_loads_and_renders():
    t = visualize.load_components(FIXTURE)
    assert t.X_comp.shape == t.Z_comp.shape == (8, 1, 512)
    assert t.meta is None and t.var_ratio.shape == (8,)
    _, port = _models()
    port.use_w()
    inst = InstrumentedModel(port)
    rows = visualize.make_grid(inst, "style", t.Z_global_mean, t.Z_global_mean,
                               t.Z_comp, t.Z_stdev, t.X_global_mean, t.X_comp,
                               t.X_stdev, scale=2.0, n_rows=2, n_cols=3)
    assert len(rows) == 2 and all(len(r) == 3 for r in rows)
    assert rows[0][0].shape == (32, 32, 3) and rows[0][0].dtype == np.uint8


def test_visualize_writes_the_jax_filenames(tmp_path, monkeypatch):
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    jax_model, port = _models()
    monkeypatch.setitem(jax_models._CUSTOM_MODELS, "TinyStyleGAN2",
                        lambda oc, **kw: jax_model)
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyStyleGAN2", lambda oc, device, **kw: port)
    args = ["--model", "TinyStyleGAN2", "--class", "ffhq", "--use_w", "--layer",
            "style", "--est", "ipca", "-c", "4", "-n", "2048", "-b", "1024"]

    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    jax_visualize.main(args + ["--mesh", "1"])
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    result = visualize.main(args + ["--device", "cpu"])

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in (root / "out").rglob("*.jpg"))

    names = tree(tmp_path / "torch")
    assert names == tree(tmp_path / "jax")
    assert len(names) == 12 and "out/StyleGAN2-ffhq/style/ipca/summ/components_W.jpg" in names
    assert result.images == 12 * 4 * 5                 # grids x rows x frames
    assert result.cache.name == "tinystylegan2-ffhq_style_ipca_c4_n2048_w.npz"


def test_cuda_request_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        visualize.main(["--model", "StyleGAN2", "--use_w", "--layer", "style",
                        "-n", "64", "-c", "2"])


def test_corrupt_cache_recomputes(tmp_path, monkeypatch):
    from ganspace_tpu_torch.decomposition import component_cache_name
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    cfg = Config(model="StyleGAN2", output_class="ffhq", layer="style",
                 estimator="ipca", components=4, n=2048, use_w=True, device="cpu")
    path = tmp_path / "cache" / "components" / component_cache_name(cfg)
    path.parent.mkdir(parents=True)
    path.write_bytes(b"PK\x03\x04 truncated")
    _, port = _models()
    assert get_or_compute(cfg, InstrumentedModel(port)) == path
    assert set(_load(path)) >= {"act_comp", "lat_comp", "_meta"}
    assert not list(path.parent.glob("*.tmp.npz"))
