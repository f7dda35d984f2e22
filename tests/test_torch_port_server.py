"""The port's dissection server (``ganspace_tpu_torch/dissection/server.py``)
against the JAX package's: the intervention wire format (``mask_to_numpy``,
``decode_intervention``, ``decode_intervention_array``) exactly, the
hardening (out-of-range ids, units and standard-z ids, a 65-id batch, a
bad bitstring: ``ValueError``, HTTP 400), and one HTTP session on port 0
on a tiny DCGAN with identical weights in both packages: the uint8 images
before the JPEG within one level of JAX's (the two float32 forwards may
round a pixel the other way), the HTTP JPEG the same bytes as the
session's grid encoded, features and feature maps against JAX's."""

import base64
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from ganspace_tpu.dissection import server as jserver
from ganspace_tpu.models import dcgan as jax_dc
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch.dissection import server
from ganspace_tpu_torch.models import dcgan as torch_dc
from ganspace_tpu_torch.models.base import InstrumentedModel

LAYER = "deconv1"
SHAPES = {"a": (1, 6, 5, 4), "b": (1, 3, 2, 2)}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _png(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _masks():
    rs = np.random.RandomState(0)
    rgba = rs.randint(0, 256, (6, 7, 4), np.uint8)
    rgba[..., 3] *= rs.rand(6, 7) > 0.5
    return [
        {"bitstring": "".join(rs.choice(["0", "1"], 12)), "bitbounds": [1, 2, 4, 6],
         "shape": [5, 7]},
        {"bitstring": "0110", "shape": [2, 2]},
        {"bitstring": _png(rgba), "shape": [8, 9], "bitbounds": [1, 1, 7, 8]},
        {"bitstring": _png(rs.randint(0, 256, (5, 5), np.uint8))},
        {"bitstring": _png(rs.randint(0, 256, (4, 6, 3), np.uint8)), "shape": [4, 6]},
    ]


def test_mask_to_numpy_exact():
    for rec in _masks():
        got, ref = server.mask_to_numpy(rec), jserver.mask_to_numpy(rec)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), rec["bitstring"][:24]


def _interventions():
    m = _masks()
    return [
        {"ablations": [{"layer": "a", "unit": 2, "alpha": 0.5, "value": 1.5},
                       {"layer": "b", "unit": 0}],
         "mask": m[0], "maskpooling": "mean"},
        {"ablations": [{"layer": "a", "unit": 2, "alpha": 0.25, "value": -2.0},
                       {"layer": "a", "unit": 5, "alpha": 1.0, "value": None},
                       {"layer": "b", "unit": 1, "alpha": 0.0, "value": 0.0}],
         "mask": m[2]},
        {"ablations": [{"layer": "b", "unit": 2, "alpha": 0.75, "value": 3.0}]},
        None,
    ]


def test_decode_intervention_exact():
    for iv in _interventions():
        got, ref = server.decode_intervention(iv, SHAPES), jserver.decode_intervention(iv, SHAPES)
        assert set(got) == set(ref)
        for k in ref:
            assert np.array_equal(got[k], ref[k]), k
    got = server.decode_intervention_array(_interventions(), SHAPES)
    ref = jserver.decode_intervention_array(_interventions(), SHAPES)
    assert set(got) == set(ref) == {"a", "b"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("bad", [
    {"ablations": [{"layer": "a", "unit": 6}]},
    {"ablations": [{"layer": "a", "unit": -1}]},
    {"ablations": [{"layer": "zz", "unit": 0}]},
    {"ablations": [{"layer": "a", "unit": 0}],
     "mask": {"bitstring": "0101", "bitbounds": [0, 0, 3, 3], "shape": [5, 4]}},
])
def test_decode_rejects_like_jax(bad):
    for mod in (server, jserver):
        with pytest.raises(ValueError):
            mod.decode_intervention(bad, SHAPES)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(JAX session, port session) on the same tiny DCGAN and report."""
    cfg = dict(resolution=16, base_channels=64)
    params = jax_dc.init_params(jax_dc.DCGANConfig(**cfg), 1)
    jinst = JaxInstrumented(jax_dc.GANZooModel(cfg=jax_dc.DCGANConfig(**cfg), params=params))
    tinst = InstrumentedModel(torch_dc.GANZooModel(cfg=torch_dc.DCGANConfig(**cfg),
                                                   params=params, device="cpu"))
    tinst.retain_layer(LAYER)
    tinst.model.partial_forward(tinst.model.sample_latent(1, seed=0), LAYER)
    shape = tuple(tinst.retained_layer(LAYER, clear=True).shape)
    jinst.feature_shape[LAYER] = tinst.feature_shape[LAYER] = shape
    units = [{"unit": u, "label": "-", "category": "-", "iou": 0.01 * (u % 7),
              "activation_level": 0.1 + 0.01 * u, "iqr": 0.5} for u in range(shape[1])]
    report = {"model": "TinyDCGAN", "layer": LAYER, "n_samples": 12, "batch": 4,
              "seed": 2, "level_quantile": 0.99, "labels": [], "units": units}
    out = tmp_path_factory.mktemp("session")
    return (jserver.DissectionSession(jinst, LAYER, report, outdir=out / "jax"),
            server.DissectionSession(tinst, LAYER, report, outdir=out / "port"))


def _close_u8(got: np.ndarray, ref: np.ndarray):
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_session_images_and_features_match_jax(sessions):
    js, ts = sessions
    assert ts.layers() == js.layers() and ts.rankings() == js.rankings()
    _close_u8(ts.generate(seed=3, n=2, units=[1, 4], strength=1.0),
              js.generate(seed=3, n=2, units=[1, 4], strength=1.0))
    _close_u8(ts.compare(seed=1, n=2), js.compare(seed=1, n=2))
    ivs = [{"ablations": [{"layer": LAYER, "unit": 3, "alpha": 1.0, "value": 2.0}]}]
    for rg, rr in zip(ts.generate_records(ids=[0, 7], interventions=ivs, want_b64=False),
                      js.generate_records(ids=[0, 7], interventions=ivs, want_b64=False)):
        assert rg["id"] == rr["id"]
        _close_u8(rg["d"], rr["d"])
    for fn in ("features", "featuremaps"):
        got = getattr(ts, fn)([1, 10], [0, 2, 5], ivs)[LAYER]
        ref = getattr(js, fn)([1, 10], [0, 2, 5], ivs)[LAYER]
        if fn == "features":
            for k in ("max", "mean"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6)
        else:
            assert np.abs(np.subtract(got, ref, dtype=np.int16)).max() <= 1
    assert np.array_equal(ts.standard_z(5), js.standard_z(5))


@pytest.mark.parametrize("call", [
    lambda s: s.generate_records(ids=list(range(65))),
    lambda s: s.generate_records(ids=[10_000]),
    lambda s: s.generate_records(ids=[-1]),
    lambda s: s.generate_records(zs=np.zeros((2, 3), np.float32)),
    lambda s: s.check_ids([12]),
    lambda s: s.check_units([10_000]),
    lambda s: s.generate(units=[-1]),
    lambda s: s.levels([0.5]),
    lambda s: s.save_recipe("bad name!", {}),
])
def test_session_rejects_like_jax(sessions, call):
    for s in sessions:
        with pytest.raises(ValueError):
            call(s)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_session(sessions):
    js, ts = sessions
    srv = server.serve(ts, port=0, block=False)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for path, key in (("/api/layers", "layers"), ("/api/units?n=5", "units"),
                          ("/api/rankings", "rankings")):
            code, ctype, body = _get(base + path)
            assert code == 200 and ctype == "application/json"
            assert json.loads(body)[key] == {"layers": js.layers(),
                                             "units": js.report["units"][:5],
                                             "rankings": js.rankings()}[key]
        code, ctype, body = _get(base + "/api/generate?seed=0&n=2&units=1,3&strength=1")
        assert code == 200 and ctype == "image/jpeg"
        grid = ts.generate(seed=0, n=2, units=[1, 3], strength=1.0)
        buf = io.BytesIO()
        Image.fromarray(grid).save(buf, format="JPEG", quality=92)
        assert body == buf.getvalue()
        _close_u8(grid, js.generate(seed=0, n=2, units=[1, 3], strength=1.0))
        ivs = [{"ablations": [{"layer": LAYER, "unit": 2, "alpha": 0.5, "value": 1.0}]}]
        assert _post(base + "/api/interventions", {"interventions": ivs}) == \
            (200, {"ok": True, "interventions": ivs})
        code, res = _post(base + "/api/features", {"ids": [0, 3], "units": [1, 2]})
        ref = js.features([0, 3], [1, 2])[LAYER]
        assert code == 200
        np.testing.assert_allclose(res["res"][LAYER]["max"], ref["max"], rtol=1e-5, atol=1e-6)
        code, res = _post(base + "/api/featuremaps", {"ids": [0], "units": [1]})
        assert code == 200 and np.asarray(res["res"][LAYER]).shape[:2] == (1, 1)
        code, res = _post(base + "/api/generate", {"ids": [0, 1]})
        assert code == 200 and [r["id"] for r in res["images"]] == [0, 1]
        for path, body in (("/api/generate", {"ids": list(range(65))}),
                           ("/api/features", {"ids": [99]}),
                           ("/api/interventions", {"interventions": [
                               {"ablations": [{"layer": LAYER, "unit": 10_000}]}]})):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, body)
            assert e.value.code == 400, path
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/api/generate?units=99999")
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
