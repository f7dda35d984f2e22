"""The port's dissection passes against the JAX package's on identical
weights (tiny ProGAN and DCGAN, 16 px), with the JAX package's sketch flips
and label noise handed to the port's seams.

Bars: ``upsample_grid`` and the ``viz`` resizes to 1e-6 (nearest exact),
``ColorSegmenter`` exact; top-k values to 1e-4 relative (the activation
bar) and top-k samples where the values are distinct; sketch quantiles to
1e-4 of the activation range; ``iou_matrix`` to 1e-3, with the same best
label wherever a unit's top two IoUs differ by more than 1e-3; the scores
on identical sketches to 1e-6.  The sketches stay below their flush width
here (the JAX package compiles one program per flush width, ~100 s at 16
chunks): their flushes are held bit for bit in ``test_torch_port_stats.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganspace_tpu.dissection import viz as jax_viz
from ganspace_tpu.models import dcgan as jax_dc
from ganspace_tpu.models import proggan as jax_pg
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch.dissection import viz
from ganspace_tpu_torch.dissection.report import generate_report
from ganspace_tpu_torch.models import dcgan as torch_dc
from ganspace_tpu_torch.models import proggan as torch_pg
from ganspace_tpu_torch.models.base import InstrumentedModel

from test_torch_port_jax_rng import jax_dissect_module, port_dissect_module, use_jax_draws

jd, td = jax_dissect_module(), port_dissect_module()
N, BATCH, SEED = 8, 4, 3
REL = 1e-4
QS = np.array([0.0, 0.1, 0.5, 0.9, 0.995, 1.0])


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _models(name):
    if name == "ProGAN":
        sizes = (64, 32, 32, 16)
        params = jax_pg.init_params(jax_pg.ProGANConfig(sizes), 3)
        return (jax_pg.ProGAN("bedroom", cfg=jax_pg.ProGANConfig(sizes), params=params),
                torch_pg.ProGAN("bedroom", cfg=torch_pg.ProGANConfig(sizes), params=params,
                                device="cpu"), "layer2")
    cfg = dict(resolution=16, base_channels=64)
    params = jax_dc.init_params(jax_dc.DCGANConfig(**cfg), 3)
    return (jax_dc.GANZooModel(cfg=jax_dc.DCGANConfig(**cfg), params=params),
            torch_dc.GANZooModel(cfg=torch_dc.DCGANConfig(**cfg), params=params, device="cpu"),
            "deconv1")


@pytest.fixture(scope="module", params=["ProGAN", "DCGAN"])
def pair(request):
    jax_model, port, layer = _models(request.param)
    return JaxInstrumented(jax_model), InstrumentedModel(port), layer


@pytest.fixture(scope="module")
def fused(pair):
    """Both packages' fused stats + conditional pass, the port's on JAX's
    draws."""
    jinst, tinst, layer = pair
    with pytest.MonkeyPatch.context() as mp:
        use_jax_draws(mp)
        got = td.collect_stats_and_cond_quantiles(tinst, layer, td.ColorSegmenter(),
                                                  n_samples=N, batch=BATCH, seed=SEED)
    ref = jd.collect_stats_and_cond_quantiles(jinst, layer, jd.ColorSegmenter(),
                                              n_samples=N, batch=BATCH, seed=SEED)
    return got, ref


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _assert_close_quantiles(port_rq, jax_rq):
    got, ref = port_rq.quantiles(QS), jax_rq.quantiles(QS)
    span = float(ref.max() - ref.min()) or 1.0
    assert np.abs(got - ref).max() <= REL * span


def _assert_same_best(iou, ref_iou):
    """The same best label wherever a unit's top two IoUs differ by more
    than 1e-3."""
    top2 = np.sort(ref_iou, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    assert np.array_equal(np.argmax(iou, 1)[clear], np.argmax(ref_iou, 1)[clear])


@pytest.mark.parametrize("shape,size", [((2, 3, 8, 8), (32, 32)), ((1, 5, 4, 4), (20, 20)),
                                         ((2, 2, 8, 6), (64, 48))])
def test_upsample_grid_matches_jax(shape, size):
    act = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = td.upsample_grid(torch.from_numpy(act), size).numpy()
    ref = np.asarray(jd.upsample_grid(jnp.asarray(act), size))
    assert got.shape == ref.shape and _rel(got, ref) <= 1e-6


def test_viz_resizes_match_jax():
    rs = np.random.RandomState(1)
    act = rs.randn(7, 5).astype(np.float32)
    assert _rel(viz.activation_surface(act, (40, 30)),
                jax_viz.activation_surface(act, (40, 30))) <= 1e-6
    seg = rs.randint(0, 9, (12, 10))
    for size in ((30, 27), (7, 5)):                             # up and down
        got = viz.segment_visualization(seg, size)
        assert np.array_equal(got, jax_viz.segment_visualization(seg, size))
    img = rs.rand(3, 12, 10).astype(np.float32)
    np.testing.assert_allclose(viz.activation_overlay(img, act),
                               jax_viz.activation_overlay(img, act), atol=1e-6)
    data = rs.randn(3, 4, 16, 12).astype(np.float32)
    for shape in ((40, 30), (6, 5)):                            # linear, antialiased down
        ref = np.asarray(jax.image.resize(jnp.asarray(data.max(axis=1)),
                                          (3,) + shape, "linear"))
        assert _rel(viz.max_heatmaps(data, shape), ref) <= 1e-6


def test_color_segmenter_matches_jax():
    rs = np.random.RandomState(2)
    img = rs.rand(3, 3, 17, 19).astype(np.float32)
    img[0, :, :4] = jd.ColorSegmenter.ANCHORS[2][:, None, None]   # exact anchors
    seg = td.ColorSegmenter()
    assert seg.get_label_and_category_names() == jd.ColorSegmenter().get_label_and_category_names()
    got = seg.segment_batch(torch.from_numpy(img)).numpy()
    assert np.array_equal(got, np.asarray(jd.ColorSegmenter().segment_batch(jnp.asarray(img))))
    prob = seg.class_probability(torch.from_numpy(img), 4).numpy()
    ref = np.asarray(jd.ColorSegmenter().class_probability(jnp.asarray(img), 4))
    np.testing.assert_allclose(prob, ref, atol=1e-6)


def test_label_presence_is_the_max_of_one_hots():
    seg = np.random.RandomState(3).randint(-1, 7, (2, 3, 5, 4))
    got = td.label_presence(torch.from_numpy(seg), 6).numpy()
    ref = np.asarray(jnp.max(jax.nn.one_hot(jnp.asarray(seg), 6), axis=1))  # [B, H, W, L]
    assert np.array_equal(got, ref.reshape(2, 20, 6).transpose(0, 2, 1) > 0)


def test_tally_stats_matches_jax(pair, monkeypatch):
    jinst, tinst, layer = pair
    use_jax_draws(monkeypatch)
    got = td.tally_stats(tinst, layer, n_samples=N, batch=BATCH, seed=SEED, k_top=4)
    ref = jd.tally_stats(jinst, layer, n_samples=N, batch=BATCH, seed=SEED, k_top=4)
    assert (got["units"], got["seed"], got["batch"], got["n_samples"]) == \
        (ref["units"], ref["seed"], ref["batch"], ref["n_samples"])
    assert _rel(got["topk_values"], ref["topk_values"]) <= REL
    vals = ref["topk_values"]
    distinct = np.all(np.abs(np.diff(vals, axis=1)) > REL * np.abs(vals).max(), axis=1)
    assert distinct.any()
    assert np.array_equal(got["topk_samples"][distinct], ref["topk_samples"][distinct])
    assert got["quantiles"].count == ref["quantiles"].count
    _assert_close_quantiles(got["quantiles"], ref["quantiles"])


def test_fused_pass_matches_jax(fused):
    (stats, cond), (ref_stats, ref_cond) = fused
    assert _rel(stats["topk_values"], ref_stats["topk_values"]) <= REL
    _assert_close_quantiles(stats["quantiles"], ref_stats["quantiles"])
    assert cond["labels"] == ref_cond["labels"]
    assert np.array_equal(cond["label_fracs"], ref_cond["label_fracs"])
    assert set(cond["conditional"].keys()) == set(ref_cond["conditional"].keys())
    _assert_close_quantiles(cond["unconditional"], ref_cond["unconditional"])
    for label in ref_cond["conditional"].keys():
        c, r = cond["conditional"].conditional(label), ref_cond["conditional"].conditional(label)
        assert c.count == r.count
        _assert_close_quantiles(c, r)


def test_slabbed_passes_equal_whole_batches(pair, fused, monkeypatch):
    """One image per slab (as a full-width 1024-px batch runs on the card)
    gives the sketches and the tally of the whole batch, bit for bit."""
    jinst, tinst, layer = pair
    (stats, cond), _ = fused
    use_jax_draws(monkeypatch)
    monkeypatch.setattr(td, "image_slabs",
                        lambda n, per_image_bytes, device: ((i, i + 1) for i in range(n)))
    s2, c2 = td.collect_stats_and_cond_quantiles(tinst, layer, td.ColorSegmenter(),
                                                 n_samples=N, batch=BATCH, seed=SEED)
    assert np.array_equal(s2["topk_values"], stats["topk_values"])
    for a, b in [(c2["unconditional"], cond["unconditional"])] + [
            (c2["conditional"].conditional(l), cond["conditional"].conditional(l))
            for l in cond["conditional"].keys()]:
        assert all(np.array_equal(x, y) for x, y in
                   zip(a.state_dict().values(), b.state_dict().values()))
    r1 = td.dissect(tinst, layer, td.ColorSegmenter(), n_samples=N, batch=BATCH, seed=SEED,
                    stats=stats)
    monkeypatch.undo()
    r2 = td.dissect(tinst, layer, td.ColorSegmenter(), n_samples=N, batch=BATCH, seed=SEED,
                    stats=stats)
    assert np.array_equal(r1["iou_matrix"], r2["iou_matrix"])


def test_dissect_matches_jax(pair, fused, tmp_path):
    jinst, tinst, layer = pair
    (stats, _), (ref_stats, _) = fused
    got = td.dissect(tinst, layer, td.ColorSegmenter(), n_samples=N, batch=BATCH, seed=SEED,
                     stats=stats, cache_path=tmp_path / "tally.npz",
                     cache_provenance={"n": N})
    ref = jd.dissect(jinst, layer, jd.ColorSegmenter(), n_samples=N, batch=BATCH, seed=SEED,
                     stats=ref_stats)
    assert set(got) == set(ref)
    for k in ("layer", "model", "n_samples", "batch", "seed", "level_quantile", "labels"):
        assert got[k] == ref[k], k
    assert np.abs(got["iou_matrix"] - ref["iou_matrix"]).max() <= 1e-3
    assert np.abs(got["iqr_matrix"] - ref["iqr_matrix"]).max() <= 1e-3
    _assert_same_best(got["iou_matrix"], ref["iou_matrix"])
    by_unit = {r["unit"]: r for r in ref["units"]}
    span = float(np.ptp(ref_stats["topk_values"]))
    for r in got["units"]:
        assert abs(r["activation_level"] - by_unit[r["unit"]]["activation_level"]) <= REL * span
    # the tally cache: reused on the same levels, in the JAX package's keys
    again = td.dissect(tinst, layer, td.ColorSegmenter(), n_samples=N, batch=BATCH, seed=SEED,
                       stats=stats, cache_path=tmp_path / "tally.npz",
                       cache_provenance={"n": N})
    assert np.array_equal(again["iou_matrix"], got["iou_matrix"])
    levels = np.array([r["activation_level"] for r in sorted(got["units"],
                                                              key=lambda r: r["unit"])])
    cached = jd._load_tally_cache(tmp_path / "tally.npz", {"n": N}, levels)
    assert cached is not None and cached[3] == N * 16 * 16


def test_scores_on_identical_sketches_match_jax(fused):
    """``iqr_max_scores``, ``maxiou_scores`` and ``iqr_scores`` of the JAX
    pass's own sketches, loaded into the port."""
    _, (_, ref_cond) = fused
    cq = td.RunningConditionalQuantile().set_state_dict(ref_cond["conditional"].state_dict())
    cond = {"conditional": cq, "labels": ref_cond["labels"],
            "label_fracs": ref_cond["label_fracs"],
            "unconditional": td.RunningQuantile().set_state_dict(
                ref_cond["unconditional"].state_dict())}
    for fn in ("iqr_max_scores", "maxiou_scores"):
        got, ref = getattr(td, fn)(cond), getattr(jd, fn)(ref_cond)
        assert set(got) == set(ref)
        for k in ref:
            assert np.abs(got[k] - ref[k]).max() <= 1e-6 * max(np.abs(ref[k]).max(), 1.0), k
    assert np.abs(td.iqr_scores(cond) - jd.iqr_scores(ref_cond)).max() <= 1e-6


def test_collect_covariance_matches_jax(pair):
    jinst, tinst, layer = pair
    got = td.collect_covariance(tinst, layer, td.ColorSegmenter(), n_samples=N,
                                batch=BATCH, seed=SEED)
    ref = jd.collect_covariance(jinst, layer, jd.ColorSegmenter(), n_samples=N,
                                batch=BATCH, seed=SEED)
    assert got["labels"] == ref["labels"] and got["cross"].count == ref["cross"].count
    np.testing.assert_allclose(got["correlation"], ref["correlation"], atol=1e-4)


def test_regenerate_sample_is_the_host_stream(pair):
    jinst, tinst, _ = pair
    for s in (0, 5, 7):
        got = td.regenerate_sample(tinst.model, s, seed=SEED, batch=BATCH, n_samples=N)
        ref = jd.regenerate_sample(jinst.model, s, seed=SEED, batch=BATCH, n_samples=N)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_label_noise_is_a_seeded_gumbel_stream():
    a = td.label_noise(1, 0, (4, 20000), "cpu")
    assert torch.equal(a, td.label_noise(1, 0, (4, 20000), "cpu"))
    assert not torch.equal(a, td.label_noise(1, 1, (4, 20000), "cpu"))
    assert not torch.equal(a, td.label_noise(2, 0, (4, 20000), "cpu"))
    assert abs(float(a.mean()) - 0.5772) < 0.03 and torch.isfinite(a).all()


def test_stats_cache_crosses_packages(fused, tmp_path):
    """A cache the JAX package wrote loads in the port and back, with the
    same keys; a provenance mismatch recomputes."""
    (stats, cond), (ref_stats, ref_cond) = fused
    prov = {"model": "tiny", "n": N, "seed": SEED}
    jd.save_stats_cache(tmp_path / "jax.npz", ref_stats, ref_cond, prov)
    td.save_stats_cache(tmp_path / "port.npz", stats, cond, prov)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            if k.startswith("prov_") or k.endswith(("samplesize", "depth", "count", "fills")):
                assert np.array_equal(a[k], b[k]), k
    s2, c2 = td.load_stats_cache(tmp_path / "jax.npz", prov)
    assert np.array_equal(s2["topk_values"], ref_stats["topk_values"])
    assert np.array_equal(s2["quantiles"].quantiles(QS), ref_stats["quantiles"].quantiles(QS))
    assert np.array_equal(c2["unconditional"].quantiles(QS),
                          ref_cond["unconditional"].quantiles(QS))
    s3, c3 = jd.load_stats_cache(tmp_path / "port.npz", prov)
    assert np.array_equal(s3["quantiles"].quantiles(QS), stats["quantiles"].quantiles(QS))
    assert td.load_stats_cache(tmp_path / "jax.npz", {**prov, "n": 2 * N}) == (None, None)
    (tmp_path / "bad.npz").write_bytes(b"\x00not a zip")
    assert td.load_stats_cache(tmp_path / "bad.npz", prov) == (None, None)


def test_report_files_and_unit_images(pair, fused, tmp_path):
    """``generate_report`` writes the JAX package's files; a unit's image is
    its top samples regenerated side by side."""
    _, tinst, layer = pair
    (stats, _), _ = fused
    report = td.dissect(tinst, layer, td.ColorSegmenter(), n_samples=N, batch=BATCH,
                        seed=SEED, stats=stats)
    out = generate_report(report, tmp_path, inst=tinst, n_units=3)
    assert out == tmp_path / "dissect.html"
    data = json.loads((tmp_path / "dissect.json").read_text())
    assert "iou_matrix" not in data and data["units"][0] == report["units"][0]
    assert (tmp_path / "bargraph.svg").read_text().startswith("<svg")
    from PIL import Image
    top = report["units"][0]
    with Image.open(tmp_path / "image" / f"unit_{top['unit']}.png") as im:
        got = np.asarray(im)
    model = tinst.model
    z = torch.cat([td.regenerate_sample(model, s, seed=SEED, batch=BATCH, n_samples=N)
                   for s in top["top_samples"][:4]])
    want = np.concatenate(list(model.sample_np(z, uint8=True)), axis=1)
    assert np.array_equal(got, want)


def test_samplers_match_jax(pair):
    """``sampling.z_sample_for_model`` and the subset samplers of
    ``sampling.py`` and ``dissection/sampler.py`` give the JAX package's
    latents and index sequences."""
    from ganspace_tpu import sampling as jax_sampling
    from ganspace_tpu.dissection import sampler as jax_sampler

    from ganspace_tpu_torch import sampling
    from ganspace_tpu_torch.dissection import sampler
    jinst, tinst, _ = pair
    assert np.array_equal(sampling.z_sample_for_model(tinst.model, 5, seed=4),
                          jax_sampling.z_sample_for_model(jinst.model, 5, seed=4))
    got = sampling.FixedRandomSubsetSampler(50, start=5, end=30, seed=3)
    ref = jax_sampling.FixedRandomSubsetSampler(50, start=5, end=30, seed=3)
    assert list(got) == list(ref) and got.subset([1, 4]).samples == ref.subset([1, 4]).samples
    labels = np.arange(50) % 3
    assert list(got.class_subset(labels, 1)) == list(ref.class_subset(labels, 1))
    data = [(i, i % 4) for i in range(40)]
    got = sampler.FixedRandomSubsetSampler(data, end=25, seed=2, class_filter=1)
    ref = jax_sampler.FixedRandomSubsetSampler(data, end=25, seed=2, class_filter=1)
    assert got.samples == ref.samples and got.dereference([0, 2]) == ref.dereference([0, 2])
    assert np.array_equal(sampler.coordinate_sample((12, 9), 5, [1, 2], flat=True),
                          jax_sampler.coordinate_sample((12, 9), 5, [1, 2], flat=True))
