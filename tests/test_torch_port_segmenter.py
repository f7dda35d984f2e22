"""The port's segmentation nets and segmenters (``ganspace_tpu_torch/dissection/
segmodel.py`` and ``segmenter.py``) against the JAX package's on the same
numpy inputs and the same seeded weights (the JAX tests' ``TINY`` UPerNet:
ResNet blocks (1,1,1,1), width 16, fpn 32; tiny ADE decoders).

Bars: the nets' activations and logits to 1e-4 relative (the activations
bar of ROADMAP.md); probabilities to 1e-4 relative; label maps equal
except at near-ties (pixels whose two best probabilities in JAX's map lie
within 1e-4); ``component_masks`` and ``expand_segment_quad`` exactly; the
torch importers equal, key for key and bit for bit, on one synthetic
reference ``state_dict`` each.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganspace_tpu.dissection import segmenter as jseg
from ganspace_tpu.dissection import segmodel as jsm

from ganspace_tpu_torch.dissection import segmenter as tseg
from ganspace_tpu_torch.dissection import segmodel as tsm

REL = 1e-4
TIE = 1e-4


def tiny_upernet(m):
    return m.UPerNetConfig(resnet=m.ResNetConfig(blocks=(1, 1, 1, 1), width=16),
                           fpn_dim=32, ppm_scales=(1, 2), n_objects=7, n_parts=5,
                           n_materials=4, n_scenes=3)


def tiny_resnet(m, dilate=0):
    return m.ResNetConfig(blocks=(1, 1, 1, 1), width=16, dilate_scale=dilate)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def unified():
    """(JAX segmenter, port segmenter) on the TINY config, segsizes 32, 24
    and 48 on 32-px images: the same size, a fractional adaptive pool and a
    bilinear enlargement."""
    sizes = (32, 24, 48)
    return (jseg.UnifiedParsingSegmenter(cfg=tiny_upernet(jsm), segsizes=sizes, seed=0),
            tseg.UnifiedParsingSegmenter(cfg=tiny_upernet(tsm), segsizes=sizes, seed=0,
                                         device="cpu"))


def _images(n=2, size=32, seed=1):
    return np.random.RandomState(seed).rand(n, 3, size, size).astype(np.float32)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30)


def _clear(probs: np.ndarray) -> np.ndarray:
    """Pixels [B, H, W] whose two best probabilities (axis 1) differ by more
    than TIE."""
    top2 = np.sort(probs, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > TIE


@pytest.mark.parametrize("dilate", [0, 8, 16])
def test_resnet_features_match_jax(dilate):
    jcfg, tcfg = tiny_resnet(jsm, dilate), tiny_resnet(tsm, dilate)
    params = jsm.init_resnet_params(jcfg, seed=4)
    x = _images(2, 40)
    ref = jsm.resnet_features(params, jnp.asarray(x), jcfg)
    got = tsm.ResNet(tcfg).params_from_jax(params)(torch.from_numpy(x))
    assert set(got) == set(ref) == {"c2", "c3", "c4", "c5"}
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert _rel(got[k], ref[k]) <= REL, (dilate, k)


def test_upernet_forward_matches_jax():
    cfg = tiny_upernet(jsm)
    params = jsm.init_upernet_params(cfg, seed=2)
    x = _images(2, 48) * 255.0 - 120.0
    ref = jsm.upernet_forward(params, jnp.asarray(x), cfg)
    got = tsm.UPerNet(tiny_upernet(tsm)).params_from_jax(params)(torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert _rel(got[k], ref[k]) <= REL, k


@pytest.mark.parametrize("decoder", ["ppm_bilinear", "c1_bilinear"])
def test_ade_decoders_match_jax(decoder):
    if decoder == "ppm_bilinear":
        jcfg = jsm.PPMBilinearConfig(resnet=tiny_resnet(jsm, 8), num_class=6, ppm_dim=16)
        tcfg = tsm.PPMBilinearConfig(resnet=tiny_resnet(tsm, 8), num_class=6, ppm_dim=16)
        params, jfwd, net = (jsm.init_ppm_params(jcfg, 5), jsm.ppm_bilinear_forward,
                             tsm.PPMBilinear(tcfg))
    else:
        jcfg = jsm.C1BilinearConfig(resnet=tiny_resnet(jsm, 8), num_class=6)
        tcfg = tsm.C1BilinearConfig(resnet=tiny_resnet(tsm, 8), num_class=6)
        params, jfwd, net = (jsm.init_c1_params(jcfg, 5), jsm.c1_bilinear_forward,
                             tsm.C1Bilinear(tcfg))
    net.params_from_jax(params)
    x = _images(2, 40)
    for seg_size in (None, (40, 40), (3, 4)):          # (3, 4) shrinks: antialiased
        ref = jfwd(params, jnp.asarray(x), jcfg, seg_size=seg_size)
        got = net(torch.from_numpy(x), seg_size=seg_size)
        assert tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= REL, seg_size


def test_category_probabilities_match_jax(unified):
    js, ts = unified
    assert ts.get_label_and_category_names() == js.get_label_and_category_names()
    x = _images()
    ref = js.category_probabilities(jnp.asarray(x))
    got = ts.category_probabilities(torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= REL, k


def test_shrinking_probabilities_match_jax():
    """A 16-px image at segsize 96: the probabilities (24 px) shrink back
    to 16 px, antialiased as ``jax.image.resize`` does."""
    js = jseg.UnifiedParsingSegmenter(cfg=tiny_upernet(jsm), segsizes=(96,), seed=3)
    ts = tseg.UnifiedParsingSegmenter(cfg=tiny_upernet(tsm), segsizes=(96,), seed=3,
                                      device="cpu")
    x = _images(1, 16, seed=7)
    ref = js.category_probabilities(jnp.asarray(x))
    got = ts.category_probabilities(torch.from_numpy(x))
    for k in ref:
        assert _rel(got[k], ref[k]) <= REL, k


def _labels_agree(got, ref, probs_by_channel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    for c, probs in enumerate(probs_by_channel):
        clear = _clear(np.asarray(probs))
        assert np.array_equal(got[:, c][clear], ref[:, c][clear]), c
        assert clear.mean() > 0.9


def test_segment_batch_matches_jax(unified):
    js, ts = unified
    x = _images()
    probs = js.category_probabilities(jnp.asarray(x))
    ref = js.segment_batch(jnp.asarray(x))
    got = ts.segment_batch(torch.from_numpy(x))
    _labels_agree(got, ref, [probs[c] for c in jseg.CATEGORIES])
    ref2 = js.segment_batch(jnp.asarray(x), downsample=2)
    got2 = ts.segment_batch(torch.from_numpy(x), downsample=2)
    _labels_agree(got2, ref2, [probs[c][:, :, ::2, ::2] for c in jseg.CATEGORIES])


def test_segment_batch_quad_matches_jax(unified):
    js0, ts0 = unified
    js = jseg.UnifiedParsingSegmenter(cfg=tiny_upernet(jsm), segsizes=(32,), seed=0,
                                      segdiv="quad")
    ts = tseg.UnifiedParsingSegmenter(cfg=tiny_upernet(tsm), segsizes=(32,), seed=0,
                                      segdiv="quad", device="cpu")
    assert ts.get_label_and_category_names() == js.get_label_and_category_names()
    x = _images(2, 32, seed=5)
    ref = np.asarray(js.segment_batch(jnp.asarray(x)))
    got = ts.segment_batch(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and got.shape[1] == 5
    probs = js.category_probabilities(jnp.asarray(x))
    _labels_agree(got[:, :3], ref[:, :3], [probs[c] for c in jseg.CATEGORIES])
    for i in range(len(x)):
        if np.array_equal(got[i, 0], ref[i, 0]):      # the same object components
            assert np.array_equal(got[i, 3:], ref[i, 3:])
    with pytest.raises(ValueError):
        ts.class_probability(torch.from_numpy(x), ts._div_base)


def test_class_probability_and_predict_single_class(unified):
    js, ts = unified
    x = _images(2, 32, seed=3)
    for classnum in (2, 8, js._div_base - 1):          # an object, a part, a material
        ref = js.class_probability(jnp.asarray(x), classnum)
        got = ts.class_probability(torch.from_numpy(x), classnum)
        assert _rel(got, ref) <= REL, classnum
        rp, rm = js.predict_single_class(jnp.asarray(x), classnum, downsample=2)
        gp, gm = ts.predict_single_class(torch.from_numpy(x), classnum, downsample=2)
        assert _rel(gp, rp) <= REL
        cat = js.categories[classnum]
        clear = _clear(np.asarray(js.category_probabilities(jnp.asarray(x))[cat])[:, :, ::2, ::2])
        assert np.array_equal(gm.numpy()[clear], np.asarray(rm)[clear])
    for bad in (0, len(ts.labels)):
        with pytest.raises(ValueError):
            ts.class_probability(torch.from_numpy(x), bad)


def test_class_probability_is_differentiable(unified):
    _, ts = unified
    x = torch.from_numpy(_images(1, 32, seed=9)).requires_grad_(True)
    ts.class_probability(x, 3).mean().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


def test_component_masks_and_quad_exact():
    rs = np.random.RandomState(0)
    maps = rs.randint(0, 4, (3, 12, 10))
    maps[1, :6] = 0
    for m in maps:
        got = list(tseg.component_masks(m))
        ref = list(jseg.component_masks(m))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert np.array_equal(g, r)
    assert np.array_equal(tseg.expand_segment_quad(maps, 3),
                          jseg.expand_segment_quad(maps, 3))


def _bn(state, key, c, rs):
    state[f"{key}.weight"] = rs.rand(c).astype(np.float32) + 0.5
    state[f"{key}.bias"] = rs.randn(c).astype(np.float32)
    state[f"{key}.running_mean"] = rs.randn(c).astype(np.float32)
    state[f"{key}.running_var"] = rs.rand(c).astype(np.float32) + 0.5


def _resnet_state(cfg, rs):
    """A reference-named deep-stem ResNet ``state_dict`` (torch tensors)
    with random weights, from the JAX init's shapes."""
    state = {}
    for k, v in jsm.init_resnet_params(cfg).items():
        if not k.endswith(".weight"):
            continue
        base = k[:-len(".weight")]
        if base.startswith("stem.conv"):
            conv, bn = base[len("stem."):], "bn" + base[-1]
        elif base.endswith(".downsample"):
            conv, bn = base + ".0", base + ".1"
        else:
            conv, bn = base, base[:-len("convN")] + "bn" + base[-1]
        state[f"{conv}.weight"] = rs.randn(*v.shape).astype(np.float32)
        _bn(state, bn, v.shape[0], rs)
    return {k: torch.from_numpy(v) for k, v in state.items()}


def _assert_same_params(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_torch_importers_match_jax():
    rs = np.random.RandomState(11)
    # UPerNet: the encoder by name, the decoder through the position map
    jcfg, tcfg = tiny_upernet(jsm), tiny_upernet(tsm)
    enc = _resnet_state(jcfg.resnet, rs)
    init = jsm.init_upernet_params(jcfg)
    dec = {}
    for dst, (conv_key, bn_key) in jseg._decoder_name_map(jcfg).items():
        w = init[f"{dst}.weight"]
        dec[f"{conv_key}.weight"] = torch.from_numpy(rs.randn(*w.shape).astype(np.float32))
        if bn_key is not None:
            _bn(dec, bn_key, w.shape[0], rs)
        else:
            dec[f"{conv_key}.bias"] = rs.randn(w.shape[0]).astype(np.float32)
    del dec["fpn_out.1.0.0.weight"]                   # a missing tensor keeps its init
    ref = jseg.import_torch_upernet(enc, dec, jcfg)
    got = tseg.import_torch_upernet(enc, dec, tcfg)
    _assert_same_params(got, ref)
    tsm.UPerNet(tcfg).params_from_jax(got)
    # the ADE decoders
    for jc, tc, net in (
            (jsm.PPMBilinearConfig(resnet=tiny_resnet(jsm, 8), num_class=6, ppm_dim=16),
             tsm.PPMBilinearConfig(resnet=tiny_resnet(tsm, 8), num_class=6, ppm_dim=16),
             tsm.PPMBilinear),
            (jsm.C1BilinearConfig(resnet=tiny_resnet(jsm, 8), num_class=6),
             tsm.C1BilinearConfig(resnet=tiny_resnet(tsm, 8), num_class=6),
             tsm.C1Bilinear)):
        init = (jsm.init_ppm_params if net is tsm.PPMBilinear else jsm.init_c1_params)(jc)
        dec = {}
        if net is tsm.PPMBilinear:
            convs = {f"ppm.{i}": (f"ppm.{i}.1", f"ppm.{i}.2")
                     for i in range(len(jc.pool_scales))}
            convs["conv_last"] = ("conv_last.0", "conv_last.1")
            cls = "conv_last.4"
        else:
            convs, cls = {"cbr": ("cbr.0", "cbr.1")}, "conv_last"
        for dst, (conv_key, bn_key) in convs.items():
            w = init[f"decoder.{dst}.weight"]
            dec[f"{conv_key}.weight"] = rs.randn(*w.shape).astype(np.float32)
            _bn(dec, bn_key, w.shape[0], rs)
        w = init["decoder.classifier.weight"]
        dec[f"{cls}.weight"] = rs.randn(*w.shape).astype(np.float32)
        dec[f"{cls}.bias"] = rs.randn(w.shape[0]).astype(np.float32)
        enc = _resnet_state(jc.resnet, rs)
        ref = jsm.import_torch_segmodel(enc, dec, jc)
        got = tsm.import_torch_segmodel(enc, dec, tc)
        _assert_same_params(got, ref)
        net(tc).params_from_jax(got)


def test_semantic_segmenter_matches_jax(monkeypatch):
    """``SemanticSegmenter`` (the ADE segmenter) on a tiny PPM net built
    through ``build_segmodel``, undivided and quad."""
    def tiny(m):
        def build(arch_encoder, arch_decoder, num_class=150, seed=0):
            cfg = m.PPMBilinearConfig(resnet=tiny_resnet(m, 8), num_class=num_class,
                                      ppm_dim=16)
            net = m.ppm_bilinear_forward if m is jsm else tsm.PPMBilinear
            if m is jsm:
                from functools import partial
                net = partial(net, cfg=cfg)
            return m.init_ppm_params(cfg, seed), net, cfg
        return build
    monkeypatch.setattr(jsm, "build_segmodel", tiny(jsm))
    monkeypatch.setattr(tseg, "build_segmodel", tiny(tsm))
    x = _images(2, 32, seed=4)
    for segdiv in ("undivided", "quad"):
        js = jseg.SemanticSegmenter(num_class=5, segsizes=(32, 24), segdiv=segdiv)
        ts = tseg.SemanticSegmenter(num_class=5, segsizes=(32, 24), segdiv=segdiv,
                                    device="cpu")
        assert ts.get_label_and_category_names() == js.get_label_and_category_names()
        probs = np.asarray(js.class_probabilities(jnp.asarray(x)))
        assert _rel(ts.class_probabilities(torch.from_numpy(x)), probs) <= REL
        ref = np.asarray(js.segment_batch(jnp.asarray(x)))
        got = ts.segment_batch(torch.from_numpy(x)).numpy()
        _labels_agree(got[:, :1], ref[:, :1], [probs])
        if segdiv == "quad":
            for i in range(len(x)):
                if np.array_equal(got[i, 0], ref[i, 0]):
                    assert np.array_equal(got[i, 1:], ref[i, 1:])
        assert _rel(ts.class_probability(torch.from_numpy(x), 3),
                    js.class_probability(jnp.asarray(x), 3)) <= REL
        rp, rm = js.predict_single_class(jnp.asarray(x), 2)
        gp, gm = ts.predict_single_class(torch.from_numpy(x), 2)
        assert _rel(gp, rp) <= REL
        assert np.array_equal(gm.numpy()[_clear(probs)], np.asarray(rm)[_clear(probs)])
