"""The port's ``dissect`` command against the JAX package's CLI on a tiny
DCGAN (16 px) registered in both packages with identical weights, the port
on the JAX package's sketch flips and label noise: the same file set,
``dissect.json`` equal up to the bars of ``test_torch_port_dissection.py``,
the caches with identical keys and provenance (a cache the JAX CLI wrote is
reused by the port's), ``--features`` with the ported classifier against
``examples.custom_classifier``, ``--imagedir``, ``--no-labels``,
``--meta``/``--merge``, ``--done-dir``, the dispatcher, and the flags of
dissection part 2 (``--segmenter unified|ade`` on tiny nets, ``--serve``,
``--ace-class``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganspace_tpu import models as jax_models
from ganspace_tpu.dissection import __main__ as jax_cli
from ganspace_tpu.models import dcgan as jax_dc

from ganspace_tpu_torch import __main__ as dispatcher
from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.dissection import __main__ as cli
from ganspace_tpu_torch.examples import custom_classifier
from ganspace_tpu_torch.models import dcgan as torch_dc

from test_torch_port_jax_rng import use_jax_draws

TINY = dict(resolution=16, base_channels=64)
ARGS = ["--model", "TinyDCGAN", "--layer", "deconv1", "--samples", "8", "--batch", "4",
        "--seed", "2"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tiny(monkeypatch):
    """TinyDCGAN registered in both packages, the port on JAX's draws."""
    params = jax_dc.init_params(jax_dc.DCGANConfig(**TINY), 3)
    jax_model = jax_dc.GANZooModel(cfg=jax_dc.DCGANConfig(**TINY), params=params)
    port = torch_dc.GANZooModel(cfg=torch_dc.DCGANConfig(**TINY), params=params, device="cpu")
    monkeypatch.setitem(jax_models._CUSTOM_MODELS, "TinyDCGAN", lambda oc, **kw: jax_model)
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyDCGAN", lambda oc, device, **kw: port)
    use_jax_draws(monkeypatch)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _units(path: Path):
    rep = json.loads(path.read_text())
    return rep, {u["unit"]: u for u in rep["units"]}


def _assert_reports_agree(got: Path, ref: Path):
    rep, units = _units(got)
    ref_rep, ref_units = _units(ref)
    assert set(rep) == set(ref_rep)
    for k in rep:
        if k not in ("units", "label_rankings"):
            assert rep[k] == ref_rep[k], k
    assert set(units) == set(ref_units)
    span = max(max(abs(v) for u in ref_units.values() for v in u["top_values"]), 1e-30)
    for u, r in ref_units.items():
        g = units[u]
        assert set(g) == set(r)
        for k in r:
            if k in ("iou", "iqr", "iqr_score", "maxiou", "iqr_agreement"):
                assert abs(g[k] - r[k]) <= 1e-3, (u, k)
            elif k in ("activation_level", "iqr_level", "maxiou_level"):
                assert abs(g[k] - r[k]) <= 1e-4 * span, (u, k)
            elif k == "top_values":
                assert np.abs(np.subtract(g[k], r[k])).max() <= 1e-4 * span
            elif k == "top_samples":
                vals = np.asarray(r["top_values"])
                if np.all(np.abs(np.diff(vals)) > 1e-4 * span):
                    assert g[k] == r[k], u
    return rep, ref_rep


def test_cli_matches_jax_and_reads_its_caches(tiny, tmp_path, capsys):
    args = ARGS + ["--iqr", "--maxiou", "--cov", "--rank-all-labels", "--examples", "4"]
    assert jax_cli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for p in ("stats+conditional", "tally", "covariance", "report"):
        assert f"pass {p}: " in out
    jdir, tdir = tmp_path / "jax" / "deconv1", tmp_path / "port" / "deconv1"
    assert _files(tdir) == _files(jdir)
    assert len(list(tdir.glob("image/unit_*.png"))) == 4
    rep, ref = _assert_reports_agree(tdir / "dissect.json", jdir / "dissect.json")
    assert [r["label"] for r in rep["label_rankings"]] == [r["label"] for r in ref["label_rankings"]]
    for name in ("iqr.npz", "max_iou.npz", "stats_cache.npz", "tally_cache.npz"):
        with np.load(tdir / name) as a, np.load(jdir / name) as b:
            assert set(a.files) == set(b.files), name
            for k in b.files:
                if k.startswith("prov_"):
                    assert np.array_equal(a[k], b[k]), (name, k)
    np.testing.assert_allclose(np.load(tdir / "correlation.npy"),
                               np.load(jdir / "correlation.npy"), atol=1e-4)
    # the port reruns in the JAX CLI's directory: both caches reused
    assert cli.main(args + ["--outdir", str(tmp_path / "jax"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"reusing cached stats: {jdir / 'stats_cache.npz'}" in out
    assert f"reusing cached tally: {jdir / 'tally_cache.npz'}" in out
    assert "pass stats+conditional" not in out and "pass tally" not in out


def test_cli_per_unit_quantile_and_dispatcher(tiny, tmp_path):
    """``--quantile maxiou`` (per-unit levels from the IoU search) through
    ``python -m ganspace_tpu_torch dissect``, against the JAX CLI."""
    args = ARGS + ["--quantile", "maxiou", "--no-images", "--examples", "3"]
    assert jax_cli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert dispatcher.main(["dissect", *args, "--outdir", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    rep, _ = _assert_reports_agree(tmp_path / "port" / "deconv1" / "dissect.json",
                                   tmp_path / "jax" / "deconv1" / "dissect.json")
    assert rep["level_quantile"] == "per-unit"
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_cli_no_labels_meta_merge_and_done_dir(tiny, tmp_path, capsys):
    (tmp_path / "meta.json").write_text(json.dumps({"experiment": "e7"}))
    (tmp_path / "merge.json").write_text(json.dumps({"layers": [
        {"layer": "alias1", "units": [{"interp": False}, {"interp": True, "note": "e"}]}]}))
    args = ["--model", "TinyDCGAN", "--layer", "deconv1:alias1", "--samples", "8",
            "--batch", "4", "--no-labels", "--netname", "mynet", "--quiet",
            "--meta", str(tmp_path / "meta.json"), "--merge", str(tmp_path / "merge.json")]
    assert jax_cli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    capsys.readouterr()
    done = tmp_path / "job"
    assert cli.main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu",
                            "--done-dir", str(done)]) == 0
    assert capsys.readouterr().out == ""                       # --quiet
    rep, ref = _assert_reports_agree(tmp_path / "port" / "alias1" / "dissect.json",
                                     tmp_path / "jax" / "alias1" / "dissect.json")
    assert rep["meta"] == {"experiment": "e7"} and rep["labels"] == []
    by_unit = {u["unit"]: u for u in rep["units"]}
    assert by_unit[0]["interp"] is False and by_unit[1]["note"] == "e"
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert (done / "done.txt").is_file()
    with pytest.raises(SystemExit) as e:                       # a done job exits
        cli.main(args + ["--outdir", str(tmp_path / "again"), "--device", "cpu",
                         "--done-dir", str(done)])
    assert e.value.code == 0 and not (tmp_path / "again").exists()
    with pytest.raises(SystemExit):
        cli.main(["--model", "TinyDCGAN", "--layer", "deconv1", "--no-labels", "--iqr",
                  "--outdir", str(tmp_path), "--device", "cpu"])


def test_features_mode_matches_jax_classifier(tmp_path):
    """``--features`` with the ported classifier (the JAX example's weights
    and SAME padding) against the JAX CLI on a synthetic broden tree."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from examples import custom_classifier as jax_classifier

    from ganspace_tpu_torch.dissection.broden import write_synthetic_broden
    images = np.random.RandomState(0).rand(2, 3, 32, 30).astype(np.float32)
    for layer in custom_classifier.LAYERS:
        got = custom_classifier.features(layer)(torch.from_numpy(images)).numpy()
        ref = np.asarray(jax_classifier.features(layer)(jnp.asarray(images)))
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    broden = write_synthetic_broden(tmp_path / "broden", n_images=8, size=32)
    args = ["--broden", str(broden), "--layer", "conv2", "--samples", "8", "--batch", "4",
            "--rank-all-labels", "--examples", "4"]
    assert jax_cli.main(["--features", "examples.custom_classifier:features", *args,
                         "--outdir", str(tmp_path / "jax")]) == 0
    assert cli.main(["--features", "ganspace_tpu_torch.examples.custom_classifier:features",
                     *args, "--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    rep, ref = _units(tmp_path / "port" / "conv2" / "dissect.json")[0], \
        _units(tmp_path / "jax" / "conv2" / "dissect.json")[0]
    assert (rep["model"], rep["layer"], rep["n_samples"], rep["labels"]) == \
        (ref["model"], ref["layer"], ref["n_samples"], ref["labels"])
    got = {u["unit"]: u for u in rep["units"]}
    for u in ref["units"]:
        assert abs(got[u["unit"]]["iou"] - u["iou"]) <= 1e-3
        assert abs(got[u["unit"]]["activation_level"] - u["activation_level"]) <= 1e-4
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_imagedir_mode_matches_jax(tmp_path):
    from PIL import Image
    img = tmp_path / "img"
    img.mkdir()
    rs = np.random.RandomState(0)
    for i in range(5):
        Image.fromarray(rs.randint(0, 255, (16, 16, 3), np.uint8)).save(img / f"im{i}.png")
    args = ["--imagedir", str(img), "--samples", "4", "--batch", "2"]
    assert jax_cli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for name in ("labels.json", *(f"seg_im{i}.png" for i in range(4))):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _tiny_segmenters(monkeypatch):
    """Both CLIs' ``unified`` and ``ade`` segmenters on tiny nets (the JAX
    tests' TINY UPerNet; a tiny dilated PPM net behind ``build_segmodel``),
    built through the CLIs' own ``--seg-params`` / ``--segsizes`` wiring."""
    from functools import partial

    from ganspace_tpu import dissection as jax_dissection
    from ganspace_tpu.dissection import segmodel as jsm
    from ganspace_tpu_torch import dissection as port_dissection
    from ganspace_tpu_torch.dissection import segmenter as tseg
    from ganspace_tpu_torch.dissection import segmodel as tsm

    from test_torch_port_segmenter import tiny_resnet, tiny_upernet

    for pkg, m in ((jax_dissection, jsm), (port_dissection, tsm)):
        monkeypatch.setattr(pkg, "UnifiedParsingSegmenter",
                            partial(pkg.UnifiedParsingSegmenter, cfg=tiny_upernet(m)))

    def tiny_ppm(m):
        def build(arch_encoder, arch_decoder, num_class=150, seed=0):
            cfg = m.PPMBilinearConfig(resnet=tiny_resnet(m, 8), num_class=num_class,
                                      ppm_dim=16)
            net = partial(jsm.ppm_bilinear_forward, cfg=cfg) if m is jsm else tsm.PPMBilinear
            return m.init_ppm_params(cfg, seed), net, cfg
        return build
    monkeypatch.setattr(jsm, "build_segmodel", tiny_ppm(jsm))
    monkeypatch.setattr(tseg, "build_segmodel", tiny_ppm(tsm))


def _both(args, tmp_path):
    assert jax_cli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    jdir, tdir = tmp_path / "jax" / "deconv1", tmp_path / "port" / "deconv1"
    assert _files(tdir) == _files(jdir)
    return jdir, tdir


@pytest.mark.parametrize("segmenter", ["unified", "ade"])
def test_part2_segmenters_match_jax(segmenter, tiny, monkeypatch, tmp_path):
    """``--segmenter unified|ade`` on the CPU against the JAX CLI."""
    _tiny_segmenters(monkeypatch)
    args = ARGS + ["--segmenter", segmenter, "--segsizes", "16", "--iqr", "--examples", "3"]
    jdir, tdir = _both(args, tmp_path)
    rep, ref = _assert_reports_agree(tdir / "dissect.json", jdir / "dissect.json")
    assert rep["labels"] == ref["labels"] and len(rep["labels"]) == (
        14 if segmenter == "unified" else 151)


def test_part2_ace_class_matches_jax(tiny, monkeypatch, tmp_path, capsys):
    """``--segmenter unified --ace-class`` on the CPU against the JAX CLI:
    ``ace.json`` (losses and ablation within 1e-4, both effect curves) and
    the ACE page with its two plots."""
    _tiny_segmenters(monkeypatch)
    args = ARGS + ["--segmenter", "unified", "--segsizes", "16", "--ace-class", "3",
                   "--ace-steps", "4", "--examples", "2"]
    jdir, tdir = _both(args, tmp_path)
    assert "pass ace: " in capsys.readouterr().out
    for name in ("ace.json", "ace.html", "ace-loss.png", "ace-effect.png"):
        assert (tdir / name).is_file(), name
    got, ref = (json.loads((d / "ace.json").read_text()) for d in (tdir, jdir))
    assert set(got) == set(ref) and got["classnum"] == ref["classnum"] == 3
    for k in ("loss_history", "ablation"):
        assert np.abs(np.subtract(got[k], ref[k])).max() <= 1e-4, k
    assert abs(got["baseline"] - ref["baseline"]) <= 1e-4
    for k in ("ablation_effect", "iou_ablation_effect"):
        assert set(got[k]) == set(ref[k])
        assert max(abs(got[k][n] - ref[k][n]) for n in ref[k]) <= 1e-4, k


def test_part2_serve_matches_jax(tiny, monkeypatch, tmp_path):
    """``--serve``: each CLI serves the last layer's session after the
    report (here on an ephemeral port, not blocking); the two servers
    answer alike."""
    import urllib.request

    from ganspace_tpu.dissection import server as jax_server
    from ganspace_tpu_torch.dissection import server as port_server
    servers = {}
    for name, mod in (("jax", jax_server), ("port", port_server)):
        serve = mod.serve
        monkeypatch.setattr(mod, "serve", lambda session, port, _s=serve, _n=name:
                            servers.setdefault(_n, _s(session, port=0, block=False)))
    _both(ARGS + ["--serve", "8091", "--examples", "2", "--no-images"], tmp_path)
    try:
        answers = {}
        for name, srv in servers.items():
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            answers[name] = [json.loads(urllib.request.urlopen(base + path, timeout=60).read())
                             for path in ("/api/layers", "/api/rankings")]
        assert answers["port"][0] == answers["jax"][0]
        for g, r in zip(answers["port"][1]["rankings"], answers["jax"][1]["rankings"]):
            assert g["name"] == r["name"]
            np.testing.assert_allclose(g["scores"], r["scores"], atol=1e-3)
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
    with pytest.raises(SystemExit) as e:
        cli.main(["--imagedir", str(tmp_path), "--serve", "8091", "--device", "cpu"])
    assert e.value.code == 2


def test_cuda_is_required_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--model", "DCGAN", "--layer", "deconv1", "--outdir", str(tmp_path)])
