"""``ganspace_tpu_torch/parallel``: ``--mesh`` on gloo, two CPU ranks.

Two launches (``--mesh 2`` and ``--mesh 1x2``) run every meshed check in
spawned ranks (``torch_port_mesh_jobs``: torch and the port only, one
thread each); the same calls run here on one process, and the JAX
package's meshed fit runs on the tests' virtual 8-device mesh.  Bars:
JAX's ``tests/test_mesh_pipeline.py`` and ``tests/test_sharding.py`` for
meshed against single (min |cos| > 0.999, ``act_mean`` within 1e-4,
``act_stdev`` rtol 1e-3, images within 1e-5, the sketch tier within
1e-4), ``tests/test_torch_parity_fullres.py``'s |cos| > 0.99 against JAX,
1e-6 for the helpers against one process."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_mesh_jobs as jobs
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import _warn_on_provenance_mismatch
from ganspace_tpu_torch.parallel import get_mesh, launch, pipeline_mesh
from ganspace_tpu_torch.parallel import mesh as meshlib

HELPER_TOL = 1e-6
COS, MEAN_TOL, STDEV_RTOL = 0.999, 1e-4, 1e-3
IMAGE_TOL, SKETCH_TOL, JAX_COS = 1e-5, 1e-4, 0.99


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both launches' results by rank: ``{"2": [r0, r1], "1x2": [r0, r1]}``."""
    out = tmp_path_factory.mktemp("mesh")
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        return {"2": launch(jobs.data_axis, (str(out),), shape="2", devices="cpu"),
                "1x2": launch(jobs.model_axis, (str(out),), shape="1x2", devices="cpu")}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The same fits and renders on one process, no mesh."""
    out = tmp_path_factory.mktemp("single")
    return {"w_host": jobs.fit(None, f"{out}/w_host", jobs.W_CFG, GANSPACE_DEVICE_RNG="0"),
            "w_device": jobs.fit(None, f"{out}/w_device", jobs.W_CFG, GANSPACE_DEVICE_RNG="1"),
            "tap": jobs.fit(None, f"{out}/tap", jobs.TAP_CFG, **jobs.TAP_ENV),
            "render": jobs.render(*jobs.render_inputs())}


def _meta(arrays):
    return json.loads(bytes(arrays["_meta"].item()).decode())


def _rows(a, c):
    return a.reshape(c, -1).astype(np.float64)


def test_mesh_shapes_and_axes():
    assert get_mesh("4", devices="cpu").shape == {"data": 4}
    mesh = get_mesh("2x2", devices="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 2, "model": 2}
    assert pipeline_mesh("1", "cpu") is None and pipeline_mesh(None, "cpu") is None
    with pytest.raises(ValueError, match="needs 3 devices"):
        get_mesh("3", devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="process each"):
        pipeline_mesh("2", "cpu")


def test_too_many_ranks_raise_before_any_process(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    started = []
    monkeypatch.setattr(meshlib, "_worker", lambda *a: started.append(a))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        get_mesh("2")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        launch(jobs.imported_modules, shape="2")
    assert not started


def test_helpers_against_one_process(ranks):
    h = [r["helpers"] for r in ranks["2"]]
    assert h[0]["odd"].tolist() == [0, 1, 2, 3, 4] and h[1]["odd"].tolist() == []
    assert h[0]["even"].tolist() == [0, 1, 2, 3] and h[1]["even"].tolist() == [4, 5, 6, 7]
    xs = [np.random.RandomState(r).randn(6, 8).astype(np.float32) for r in (0, 1)]
    x = np.concatenate(xs).astype(np.float64)
    # all_to_all: rank r holds every rank's rows of its half of the features
    for r in (0, 1):
        np.testing.assert_allclose(h[r]["resharded"], x[:, 4 * r:4 * r + 4], atol=HELPER_TOL)
    mean, xc = x.mean(0), x - x.mean(0)
    for r in (0, 1):
        assert h[r]["count"] == 12.0 and h[r]["vcount"] == 12.0
        np.testing.assert_allclose(h[r]["mean"], mean, atol=HELPER_TOL)
        np.testing.assert_allclose(h[r]["m2"], xc.T @ xc, atol=HELPER_TOL * 100, rtol=HELPER_TOL)
        np.testing.assert_allclose(h[r]["vm2"], (xc ** 2).sum(0),
                                   atol=HELPER_TOL * 100, rtol=HELPER_TOL)


@pytest.mark.parametrize("stream", ["w_host", "w_device"])
def test_w_fit_meshed_matches_single(ranks, single, stream):
    got, ref = ranks["2"][0][stream], single[stream]
    assert got["name"] == ref["name"] == "stylegan2-ffhq_style_ipca_c8_n8192_w.npz"
    assert _meta(got) == {**_meta(ref), "mesh": {"data": 2}}
    cos = np.abs(np.sum(_rows(got["act_comp"], 8) * _rows(ref["act_comp"], 8), -1))
    assert cos.min() > COS, cos
    assert np.abs(got["act_mean"] - ref["act_mean"]).max() < MEAN_TOL
    np.testing.assert_allclose(got["act_stdev"], ref["act_stdev"], rtol=STDEV_RTOL)


def test_w_fit_against_jax_meshed_run(ranks, tmp_path, monkeypatch):
    from ganspace_tpu.config import Config as JaxConfig
    from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
    from ganspace_tpu.models import stylegan2 as jax_sg2
    from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    jcfg = jax_sg2.SG2Config(resolution=32, channels=jobs.CHANNELS)
    model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jcfg,
                              params=jax_sg2.init_params(jcfg, seed=3))
    path = jax_get_or_compute(JaxConfig(model="StyleGAN2", output_class="ffhq", mesh_shape="2",
                                        **jobs.W_CFG), JaxInstrumented(model))
    with np.load(path, allow_pickle=False) as d:
        ref = {k: d[k] for k in d.files}
    got = ranks["2"][0]["w_host"]
    assert got["name"] == path.name
    assert set(got) - {"name"} == set(ref)
    assert _meta(got)["mesh"] == _meta(ref)["mesh"] == {"data": 2}
    cos = np.abs(np.sum(_rows(got["act_comp"], 8) * _rows(ref["act_comp"], 8), -1))
    assert cos.min() > JAX_COS, cos
    assert np.abs(got["act_mean"] - ref["act_mean"]).max() < MEAN_TOL


@pytest.mark.parametrize("shape", ["2", "1x2"])
def test_sketch_tier_meshed_matches_single(ranks, single, shape):
    got, ref = ranks[shape][0]["tap"], single["tap"]
    meta = _meta(got)
    assert meta["mesh"] == ({"data": 2} if shape == "2" else {"data": 1, "model": 2})
    assert meta["fused_linreg"] and meta["refine_skipped"] is False

    def same(m):
        return {k: v for k, v in m.items() if k not in ("mesh", "refine_stats")}
    assert same(meta) == same(_meta(ref))
    for key, c in (("act_comp", 8), ("lat_comp", 8)):
        cos = np.abs(np.sum(_rows(got[key], c) * _rows(ref[key], c), -1))
        assert np.abs(cos - 1).max() < SKETCH_TOL, (key, cos)
    np.testing.assert_allclose(got["act_stdev"], ref["act_stdev"], rtol=SKETCH_TOL)
    assert np.abs(got["act_mean"] - ref["act_mean"]).max() < SKETCH_TOL


def test_rendering_meshed_matches_single(ranks, single):
    got, ref = ranks["2"][0]["render"], single["render"]
    for key in ("z", "w_plus", "edited"):
        assert got[key].shape == ref[key].shape
        assert np.abs(got[key] - ref[key]).max() < IMAGE_TOL, key
    # an odd batch stays unsharded: rank 0 renders it, rank 1 holds zeros
    np.testing.assert_array_equal(got["odd"], ref["odd"])
    assert not ranks["2"][1]["render"]["odd"].any()
    np.testing.assert_array_equal(ranks["2"][1]["render"]["z"], got["z"])


def test_cli_on_the_mesh(ranks):
    cli = ranks["2"][0]["cli"]
    assert cli["cache"].endswith("tinystylegan2-ffhq_style_ipca_c4_n2048_w.npz")
    assert cli["images"] == 12 * 4 * 5
    with np.load(cli["cache"], allow_pickle=False) as d:
        assert _meta(d)["mesh"] == {"data": 2}
    assert "jax" not in ranks["2"][1]["modules"]
    assert "ganspace_tpu" not in ranks["2"][1]["modules"]


def test_mesh_warning_on_a_cache_from_another_mesh(ranks, monkeypatch, capsys):
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    path = Path(ranks["2"][0]["cli"]["cache"])
    cfg = Config(model="TinyStyleGAN2", output_class="ffhq", layer="style", components=4,
                 n=2048, use_w=True, device="cpu")
    _warn_on_provenance_mismatch(path, cfg)
    assert "computed on mesh {'data': 2} but this run would use single-device" in \
        capsys.readouterr().out
    _warn_on_provenance_mismatch(path, Config(mesh_shape="2", n=2048, device="cpu"))
    assert "mesh" not in capsys.readouterr().out
