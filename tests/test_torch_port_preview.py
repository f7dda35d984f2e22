"""The port's preview precision against the JAX package's, on the CPU.

The policy has two switches (``ops/precision.py`` in both packages): the
matmul precision (``highest`` / ``default``) and the activation storage
(float32 / bfloat16).  Held here:

* the plain versions of kernel B's bf16 datapath (modulated and plain
  mode) and of the stride-2 mode, with bf16 storage on both sides, against
  the JAX package's block-layout convs and its transposed conv: 1e-2
  relative (max|d| / max|ref|), a few bf16 roundings placed differently;
* a tiny StyleGAN2 (32 px) and a tiny StyleGAN (128 px, where the preview
  storage engages) under each of the four policies against JAX.  XLA's CPU
  backend runs a ``default``-precision contraction in float32, so under
  ``default`` the JAX package's contractions are patched to the one-pass
  bf16 datapath its TPU runs (``torch_port_jax_bf16.one_pass_bf16``): the
  two sides compute the same function.  The ``IMAGE_REL`` bars of the
  bf16 rows hold the measured distances with 1.6-2.1x room, and each
  ``default`` row also checks that a port which skipped the operand
  rounding (its ``highest`` image of the same storage) would miss its bar;
* the spectrum-derived bounds of ``--dtype bfloat16`` caches
  (``tests/test_bf16_bounds.py`` against the port), the ``_bf16`` cache and
  its ``_meta`` field for field against JAX's, the bf16 first pass driven
  by the registry of a prior run and its opt-outs, the ``_bf16`` name of a
  run cut before its float32 refine pass, and ``refine_stream``
  (``tests/test_bf16_pass1.py``).

BigGAN, ProGAN and DCGAN under the same policies:
``tests/test_torch_port_preview_families.py``.
"""

import contextlib
import importlib
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import BF16_EPS_REL as JAX_EPS_REL
from ganspace_tpu.decomposition import bf16_component_bounds as jax_bounds
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.models import stylegan as jax_sg1
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch import decomposition
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import (
    BF16_EPS_REL, bf16_component_bounds, component_cache_name, get_or_compute)
from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
from ganspace_tpu_torch.models import stylegan as torch_sg1
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops import modconv, precision
from ganspace_tpu_torch.ops.upfirdn import make_fir_kernel

from torch_port_jax_bf16 import one_pass_bf16

jax_precision = importlib.import_module("ganspace_tpu.ops.precision")
jax_s2d = importlib.import_module("ganspace_tpu.ops.s2d")
jax_modconv = importlib.import_module("ganspace_tpu.ops.modconv")

OP_REL = 1e-2
SG2_CH = ((4, 64), (8, 64), (16, 32), (32, 32))
SG1_CFG = dict(resolution=128, fmap_base=512)       # 8 channels at 128 px: bf16 there
POLICIES = [("highest", None), ("highest", "bfloat16"), ("default", None),
            ("default", "bfloat16")]
# max|port - JAX| / max|JAX| of the image, by (model, precision, storage).
# The float32 row keeps the 1e-4 bar of tests/test_torch_parity.py; the
# others are the measured distances (sg2: 0.0142, 0.0048, 0.0094; sg1:
# 0.0242, 0.0280, 0.0337) with room, the default rows under the distance
# of a port that skips the operand rounding (sg2: 0.0162, 0.0212; sg1:
# 0.0871, 0.0989), which the test checks
IMAGE_REL = {
    ("sg2", "highest", None): 1e-4, ("sg1", "highest", None): 1e-4,
    ("sg2", "highest", "bfloat16"): 0.03, ("sg1", "highest", "bfloat16"): 0.05,
    ("sg2", "default", None): 0.01, ("sg1", "default", None): 0.05,
    ("sg2", "default", "bfloat16"): 0.015, ("sg1", "default", "bfloat16"): 0.06,
}


@pytest.fixture(autouse=True)
def _few_threads():
    """Small models gain nothing from many intra-op threads, and under
    several test workers many threads per worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def policy(prec, storage):
    """One policy in both packages; the JAX traces are cleared on entry and
    exit, since the JAX package reads the precision when it traces.  Under
    ``default`` the JAX package's contractions take the one-pass bf16
    datapath its TPU runs (``torch_port_jax_bf16``)."""
    jax.clear_caches()
    with jax_precision.precision(prec), jax_precision.synth_dtype(storage), \
            precision.precision(prec), precision.synth_dtype(storage), \
            (one_pass_bf16() if prec == "default" else contextlib.nullcontext()):
        yield
    jax.clear_caches()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# -- the kernels' plain versions ----------------------------------------------

def _op_inputs(seed=0, b=2, c=16, co=12, h=8):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, c, h, h).astype(np.float32)
    w = rs.randn(co, c, 3, 3).astype(np.float32)
    s = (1.0 + 0.5 * rs.randn(b, c)).astype(np.float32)
    return x, w, s


@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("op", ["modulated", "plain", "upsample"])
def test_bf16_datapath_plain_versions_match_jax(op, prec):
    """bf16 storage on both sides: the port's plain version of each bf16
    datapath against the JAX package's conv at the same policy."""
    x, w, s = _op_inputs()
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    with policy(prec, "bfloat16"):
        if op == "modulated":
            ref = jax_s2d.blocks_to_nchw(jax_s2d.modulated_conv3x3_blocks(
                jax_s2d.nchw_to_blocks(xj), jnp.asarray(w), jnp.asarray(s)))
            got = modconv.modulated_conv2d(xt, torch.from_numpy(w), torch.from_numpy(s))
        elif op == "plain":
            ws = w / np.sqrt(16 * 9)
            ref = jax_s2d.blocks_to_nchw(jax_s2d.conv3x3_blocks(
                jax_s2d.nchw_to_blocks(xj), jnp.asarray(ws)))
            got = modconv.conv3x3(xt, torch.from_numpy(ws))
        else:
            blur = np.array([1.0, 3.0, 3.0, 1.0], np.float32)
            ref = jax_modconv.modulated_conv2d(
                xj, jnp.asarray(w), jnp.asarray(s), upsample=True,
                blur_kernel=jnp.asarray(np.outer(blur, blur) / 64.0))
            got = modconv.modulated_conv2d(xt, torch.from_numpy(w), torch.from_numpy(s),
                                           upsample=True, blur_kernel=make_fir_kernel(blur))
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert tuple(got.shape) == tuple(ref.shape)
    rel = _rel(got.float().numpy(), np.asarray(ref, np.float32))
    assert rel < OP_REL, rel


def test_bf16_plain_version_is_the_rounded_float32_conv():
    """The plain version of the bf16 datapath is exactly: operands rounded
    to bf16, the conv in float32, d in float32, the output in x's dtype."""
    x, w, s = _op_inputs(1)
    x, w, s = (torch.from_numpy(a) for a in (x, w, s))
    d = modconv.demodulation(precision.round_bf16(w), s)
    with precision.precision("default"):
        got = modconv.modconv3x3(x, w, s, d)
    r = precision.round_bf16
    ref = torch.nn.functional.conv2d(r(x * s[:, :, None, None]), r(w), padding=1)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref * d[:, :, None, None])
    got16 = modconv.modconv3x3(x.to(torch.bfloat16), w, s.to(torch.bfloat16), d)
    xs = r(x.to(torch.bfloat16).float() * r(s)[:, :, None, None])
    ref16 = torch.nn.functional.conv2d(xs, r(w), padding=1) * d[:, :, None, None]
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, ref16.to(torch.bfloat16))


def test_float32_policy_keeps_its_datapath():
    x, w, s = (torch.from_numpy(a) for a in _op_inputs(2))
    assert modconv.datapath_mode(x) == modconv.MODE_F32
    assert modconv.datapath_mode(x.to(torch.bfloat16)) == modconv.MODE_BF16
    with precision.precision("default"):
        assert modconv.datapath_mode(x) == modconv.MODE_BF16_OPS
    ref = torch.nn.functional.conv2d(x * s[:, :, None, None], w, padding=1)
    assert torch.equal(modconv.modconv3x3(x, w, s, None), ref)
    with pytest.raises(ValueError):
        precision.set_precision("high")
    with pytest.raises(ValueError):
        precision.set_synth_dtype("float16")


# -- images under the four policies -----------------------------------------

@pytest.fixture(scope="module")
def models():
    p2 = jax_sg2.init_params(jax_sg2.SG2Config(resolution=32, channels=SG2_CH), seed=5)
    p1 = jax_sg1.init_params(jax_sg1.SG1Config(**SG1_CFG), seed=3)
    return {
        "sg2": (jax_sg2.StyleGAN2(class_name="ffhq", params=p2,
                                  cfg=jax_sg2.SG2Config(resolution=32, channels=SG2_CH)),
                torch_sg2.StyleGAN2("ffhq", params=p2, device="cpu",
                                    cfg=torch_sg2.SG2Config(resolution=32, channels=SG2_CH))),
        "sg1": (jax_sg1.StyleGAN(class_name="ffhq", cfg=jax_sg1.SG1Config(**SG1_CFG),
                                 params=p1),
                torch_sg1.StyleGAN("ffhq", cfg=torch_sg1.SG1Config(**SG1_CFG), params=p1,
                                   device="cpu")),
    }


@pytest.mark.parametrize("prec,storage", POLICIES)
@pytest.mark.parametrize("name", ["sg2", "sg1"])
def test_image_under_each_policy(models, name, prec, storage):
    jax_model, port = models[name]
    z = np.random.RandomState(17).randn(2, 512).astype(np.float32)
    bar = IMAGE_REL[name, prec, storage]
    with policy(prec, storage):
        ref = np.asarray(jax_model.forward(z))
        got = port.forward(torch.from_numpy(z))
        if prec == "default":
            # the bar tells the rounding apart: without it the port misses
            with precision.precision("highest"):
                unrounded = port.forward(torch.from_numpy(z)).numpy()
            assert _rel(unrounded, ref) > bar
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    rel = _rel(got.numpy(), ref)
    assert rel < bar, rel


def test_preview_storage_reaches_the_kernels(models):
    """Under bf16 storage the StyleGAN2 taps hold bf16 activations and the
    kernel wrappers see bf16 inputs; the StyleGAN taps switch to bf16 only
    at the 128-px block of at most 64 channels."""
    _, port = models["sg2"]
    seen = []
    orig = modconv._bf16_plain

    def spy(conv, x, *a):
        seen.append(x.dtype)
        return orig(conv, x, *a)
    inst = InstrumentedModel(port)
    inst.retain_layers(["convs.1", "to_rgbs.0"])
    modconv._bf16_plain = spy
    try:
        with precision.synth_dtype("bfloat16"):
            port.forward(torch.zeros(1, 512))
    finally:
        modconv._bf16_plain = orig
    feats = inst.retained_features()
    assert feats["convs.1"].dtype == torch.bfloat16 == feats["to_rgbs.0"].dtype
    assert seen and set(seen) == {torch.bfloat16}
    _, sg1 = models["sg1"]
    inst = InstrumentedModel(sg1)
    inst.retain_layers(["g_synthesis.blocks.64x64", "g_synthesis.blocks.128x128"])
    with precision.synth_dtype("bfloat16"):
        sg1.forward(torch.zeros(1, 512))
    feats = inst.retained_features()
    assert feats["g_synthesis.blocks.64x64"].dtype == torch.float32
    assert feats["g_synthesis.blocks.128x128"].dtype == torch.bfloat16


# -- bounds (tests/test_bf16_bounds.py) ---------------------------------------

def test_bounds_formula_flat_vs_decaying():
    decaying = 0.8 ** np.arange(32)          # 36% relative gaps
    assert (bf16_component_bounds(decaying, 8) >= 0.99).all()
    flat = 1.0 - 1e-4 * np.arange(32)        # ~1e-4 relative gaps
    assert (bf16_component_bounds(flat, 8) < 0.99).all()
    # the spectrum stops at c: the gap at the cut is unknown, no bound
    b = bf16_component_bounds(decaying[:8], 8)
    assert b[7] == 0.0 and (b[:7] >= 0.99).all()
    rs = np.random.RandomState(3)
    for spec in (np.sort(rs.rand(40))[::-1], 0.9 ** np.arange(12), decaying[:5]):
        np.testing.assert_array_equal(bf16_component_bounds(spec, 8), jax_bounds(spec, 8))


@pytest.mark.parametrize("seed", [0, 1])
def test_bounds_are_conservative_vs_measured_rotation(seed):
    """The measured per-component cosine between PCA of X and PCA of bf16(X)
    sits above the spectrum-derived bound."""
    d, n, c = 128, 8192, 8
    rs = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rs.randn(d, d))
    for spec in (0.9 ** np.arange(d), (1.0 + np.arange(d)) ** -1.0):
        x = ((rs.randn(n, d) * np.sqrt(spec)) @ q.T).astype(np.float32)
        xb = precision.round_bf16(torch.from_numpy(x)).numpy()

        def pca(a):
            a = a.astype(np.float64) - a.mean(0)
            w, v = np.linalg.eigh(a.T @ a / (len(a) - 1))
            o = np.argsort(w)[::-1]
            return w[o], v[:, o[:c]]
        w1, v1 = pca(x)
        _, v2 = pca(xb)
        cos = np.abs(np.sum(v1 * v2, axis=0))
        assert (cos + 1e-9 >= bf16_component_bounds(w1, c)).all()


@pytest.mark.parametrize("mode", ["moments", "nystrom"])
def test_component_spectrum_tiers(mode):
    d, nb, c = 64, 256, 4
    spec = torch.from_numpy((0.9 ** np.arange(d)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    blocks = [torch.randn(nb, d, generator=gen) * spec for _ in range(8)]
    est = IPCAEstimator(c, mode=mode)
    assert est.fit_stream(lambda i: blocks[i], 8)
    ev = est.component_spectrum()
    assert ev is not None and len(ev) >= c + 1
    assert (np.diff(ev) <= 1e-9).all()      # descending
    assert (bf16_component_bounds(ev, c) >= 0.99).all()


def test_eps_rel_constant_pinned():
    assert BF16_EPS_REL == JAX_EPS_REL == 2e-3


# -- the _bf16 cache ------------------------------------------------------------

def _meta(path):
    with np.load(path) as d:
        return json.loads(d["_meta"].item().decode()), d["act_comp"].copy()


def _tiny_pair(seed=3):
    cfg = dict(resolution=32, channels=SG2_CH)
    params = jax_sg2.init_params(jax_sg2.SG2Config(**cfg), seed=seed)
    return (jax_sg2.StyleGAN2(class_name="ffhq", cfg=jax_sg2.SG2Config(**cfg), params=params),
            torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(**cfg), params=params,
                                device="cpu"))


def test_bf16_cache_meta_matches_jax(tmp_path, monkeypatch, capsys):
    """``--dtype bfloat16`` at a conv tap: the _bf16 name, the _meta fields
    and their values against the JAX package's cache of the same model and
    latents (the host stream), the grade consistent with the bounds, and
    the verdict on stderr."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    jax_model, port = _tiny_pair()
    kw = dict(model="StyleGAN2", output_class="ffhq", layer="conv1", estimator="ipca",
              components=3, n=1024, batch_size=128, dtype="bfloat16")
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    jax_model.use_z()
    ref_path = jax_get_or_compute(JaxConfig(**kw), JaxInstrumented(jax_model))
    capsys.readouterr()
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "port"))
    with contextlib.redirect_stdout(io.StringIO()):
        path = get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))
    err = capsys.readouterr().err
    assert path.name == ref_path.name == component_cache_name(Config(**kw))
    assert path.name.endswith("_bf16.npz")
    (meta, comp), (ref, ref_comp) = _meta(path), _meta(ref_path)
    assert set(meta) == set(ref)
    # (mesh: the JAX tests run on an 8-device CPU mesh, the port on one device)
    for k in ("dtype", "device_rng", "fused_linreg", "refine_skipped",
              "bf16_pass1", "bf16_pass1_aborted", "bf16_analysis_grade"):
        assert meta[k] == ref[k], k
    assert meta["mesh"] is None
    assert meta["dtype"] == "bfloat16"
    bounds = meta["bf16_cos_bounds"]
    assert len(bounds) == 3 and all(0.0 <= b <= 1.0 for b in bounds)
    assert meta["bf16_analysis_grade"] == (min(bounds) >= 0.99)
    np.testing.assert_allclose(bounds, ref["bf16_cos_bounds"], atol=0.02)
    assert ("NOT analysis-grade" in err) == (not meta["bf16_analysis_grade"])
    assert "bf16_cos_bounds" in err
    cos = np.abs(np.sum(comp.reshape(3, -1) * ref_comp.reshape(3, -1), axis=1))
    assert cos.min() > 0.99, cos


def test_compute_pins_float32_storage_and_checks_dtype(tmp_path, monkeypatch):
    """A process under the preview policy fits in float32 storage (no
    _bf16 tag), and an unknown --dtype is refused."""
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    _, port = _tiny_pair()
    cfg = Config(model="StyleGAN2", output_class="ffhq", layer="style", use_w=True,
                 estimator="ipca", components=3, n=2048, batch_size=512, device="cpu")
    seen = []
    inst = InstrumentedModel(port)
    with precision.precision("default"), precision.synth_dtype("bfloat16"), \
            contextlib.redirect_stdout(io.StringIO()):
        orig = decomposition._compute

        def spy(*a):
            seen.append((precision.get_precision(), precision.synth_dtype_name()))
            return orig(*a)
        monkeypatch.setattr(decomposition, "_compute", spy)
        path = get_or_compute(cfg, inst)
    assert seen == [("highest", None)] and "_bf16" not in path.name
    assert _meta(path)[0]["dtype"] == "float32"
    with pytest.raises(ValueError, match="float32"):
        decomposition.compute(Config(dtype="bf16"), tmp_path / "x.npz", inst)


# -- the bf16 first pass (tests/test_bf16_pass1.py) ---------------------------

@pytest.fixture
def pass1_env(tmp_path, monkeypatch):
    monkeypatch.setenv("GANSPACE_FUSED_ACTS", "1")
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "0")     # the sketch tier
    monkeypatch.setenv("GANSPACE_COMPILE_CACHE", str(tmp_path / "registry"))
    monkeypatch.delenv("GANSPACE_DEVICE_RNG", raising=False)
    monkeypatch.delenv("GANSPACE_BF16_PASS1", raising=False)
    _, port = _tiny_pair()
    cfg = Config(model="StyleGAN2", output_class="ffhq", layer="conv1", estimator="ipca",
                 components=3, n=1024, batch_size=128, device="cpu")

    def run(out):
        monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / out))
        with contextlib.redirect_stdout(io.StringIO()):
            return _meta(get_or_compute(cfg, InstrumentedModel(port)))
    return run


def test_registry_drives_the_bf16_first_pass(pass1_env, monkeypatch, tmp_path):
    """Run 1 is all float32 and records policy_refines; run 2 of the same
    workload streams bf16 first, its float32 refine pass determining the
    estimate; GANSPACE_BF16_PASS1=0 and an empty or unset
    GANSPACE_COMPILE_CACHE (no registry, the default) restore the float32
    first pass."""
    meta1, comp1 = pass1_env("run1")
    assert meta1["bf16_pass1"] is False and meta1["refine_skipped"] is False
    registry = json.loads((tmp_path / "registry" / "ganspace_fused_acts.json").read_text())
    assert list(registry.values()) == [{"policy_refines": True}]
    assert "|conv1|b128|D1024|ipca_c3|float32|reg2|rand2" in next(iter(registry))
    meta2, comp2 = pass1_env("run2")
    assert meta2["bf16_pass1"] is True and meta2["refine_skipped"] is False
    assert meta2["bf16_pass1_aborted"] is False and meta2["dtype"] == "float32"
    cos = np.abs(np.sum(comp1.reshape(3, -1) * comp2.reshape(3, -1), axis=1))
    assert cos.min() >= 0.99, cos
    monkeypatch.setenv("GANSPACE_BF16_PASS1", "0")
    assert pass1_env("optout")[0]["bf16_pass1"] is False
    monkeypatch.delenv("GANSPACE_BF16_PASS1")
    monkeypatch.setenv("GANSPACE_COMPILE_CACHE", "")
    assert decomposition._fused_acts_registry() is None
    assert pass1_env("noregistry")[0]["bf16_pass1"] is False
    monkeypatch.delenv("GANSPACE_COMPILE_CACHE")
    assert decomposition._fused_acts_registry() is None
    assert pass1_env("default")[0]["bf16_pass1"] is False


def test_cut_refine_after_bf16_pass1_saves_under_bf16(pass1_env, monkeypatch, tmp_path):
    """An interrupt in the float32 refine pass after a bf16 first pass: the
    save derives from the bf16 pass, so it takes the _bf16 tag and records
    bf16_pass1_aborted."""
    pass1_env("run1")
    update = ipca.nystrom_update
    refining = []
    begin = IPCAEstimator.begin_refine

    def armed(self, force=False):
        refining.append(begin(self, force))
        return refining[-1]

    def cut(state, x, omega):
        if refining and state.count > 0:
            raise KeyboardInterrupt
        return update(state, x, omega)
    monkeypatch.setattr(IPCAEstimator, "begin_refine", armed)
    monkeypatch.setattr(ipca, "nystrom_update", cut)
    with pytest.raises(SystemExit):
        pass1_env("cut")
    saved = sorted(p.name for p in (tmp_path / "cut" / "cache" / "components").iterdir())
    assert saved == ["stylegan2-ffhq_conv1_ipca_c3_n1024_bf16.npz"]
    meta, _ = _meta(tmp_path / "cut" / "cache" / "components" / saved[0])
    assert meta["bf16_pass1"] is True and meta["bf16_pass1_aborted"] is True


def _streams(d=256, nb=128):
    """(float32 block_fn, bf16-rounded block_fn) over the same samples."""
    w = torch.from_numpy(np.random.RandomState(0).randn(32, d).astype(np.float32))

    def f32_fn(i):
        z = torch.randn(nb, 32, generator=torch.Generator().manual_seed(1000 + i))
        return torch.tanh(z @ w)
    return f32_fn, lambda i: f32_fn(i).to(torch.bfloat16)


def test_refine_stream_matches_full_precision_two_pass(monkeypatch):
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "16")
    f32_fn, bf_fn = _streams()
    ref = IPCAEstimator(6, refine="always")
    assert ref.fit_stream(f32_fn, 8) and ref._refined
    mix = IPCAEstimator(6)
    assert mix.fit_stream(bf_fn, 8, refine_stream=f32_fn)
    assert mix._refined and mix.refine_skipped is False
    assert mix.policy_would_skip in (True, False)
    assert mix.n_samples_seen_ == ref.n_samples_seen_ == 8 * 128
    ca, cb = ref.get_components()[0], mix.get_components()[0]
    assert np.abs(np.sum(ca * cb, axis=-1)).min() >= 0.999


def test_refine_stream_forces_refine_even_when_policy_would_skip(monkeypatch):
    """A decaying spectrum: the policy would skip the refine pass, but with
    a reduced-precision first pass the float32 refine pass must run, and
    the would-skip verdict is still recorded."""
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "16")
    spec = torch.from_numpy((0.85 ** np.arange(256)).astype(np.float32))

    def f32_fn(i):
        return torch.randn(128, 256, generator=torch.Generator().manual_seed(i)) * spec
    calls = []

    def refine_fn(i):
        calls.append(i)
        return f32_fn(i)
    est = IPCAEstimator(6)
    assert est.fit_stream(lambda i: f32_fn(i).to(torch.bfloat16), 8, refine_stream=refine_fn)
    assert est._refined and est.refine_skipped is False
    assert est.policy_would_skip is True and calls == list(range(8))
    assert est.n_samples_seen_ == 8 * 128          # the refine pass restarts the count
    plain = IPCAEstimator(6)
    assert plain.fit_stream(f32_fn, 8) and plain.refine_skipped is True
