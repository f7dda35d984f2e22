"""BigGAN, ProGAN and DCGAN under the preview policy, against the JAX package.

The policy of ``ops/precision.py`` in both packages: the matmul precision
(``highest`` / ``default``) and the activation storage (float32 /
bfloat16).  The three generators follow the JAX package's rules, rounding
order included (``ganspace_tpu/models/biggan.py:400-473``,
``proggan.py:89-147``, ``dcgan.py:60-78``): BigGAN and ProGAN store bf16
from the latent on, DCGAN keeps float32 storage and takes the precision in
its convs alone.  Under ``default`` the JAX package's contractions take
the one-pass bf16 datapath its TPU runs (``torch_port_jax_bf16``), so the
two sides compute the same function.  Held here, on the tiny configs:

* the image under the three non-float32 policies, max|port - JAX| /
  max|JAX| below ``IMAGE_REL`` (the float32 policy is
  ``tests/test_torch_port_{biggan,progan,dcgan}.py``'s).  The bars hold
  the measured distances with room; a ``default`` row also checks that a
  port which skipped the operand rounding (its ``highest`` image of the
  same storage) would miss the bar, except ProGAN under bf16 storage,
  where every operand is bf16 already and the two precisions give the
  same image bit for bit, in the port as in JAX;
* one tap per family under bf16 storage: its dtype (bf16 for BigGAN and
  ProGAN, float32 for DCGAN) and values;
* a ``--dtype bfloat16`` cache of ProGAN: the ``_bf16`` filename, the npz
  keys and the ``_meta`` fields against the JAX package's;
* the viewer's preview error (the preview frame against the float32 frame,
  mean uint8 levels) of both packages on a model of each family's full
  depth and resolution and reduced width (DCGAN at full width): the port's
  within ``PREVIEW_ERR_BAND`` of JAX's, and JAX's the figure that
  ``chip_smoke.py``'s viewer gate scales (``PREVIEW_JAX_MEAN_LEVELS``).
  The tiny configs above are shallower and narrower than the models the
  gate holds, and their preview error is smaller.

The XLA CPU backend fuses some bf16 elementwise chains and rounds them
once, where the port rounds each op as JAX's eager ops do: that, and the
order of float32 sums, is the distance the bf16 bars hold.
"""

import contextlib
import importlib
import io
import json

import numpy as np
import pytest
import torch

import jax

from ganspace_tpu.apps import interactive as jax_interactive
from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.models import biggan as jax_bg
from ganspace_tpu.models import dcgan as jax_dc
from ganspace_tpu.models import proggan as jax_pg
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

import chip_smoke
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.imaging import frame_u8
from ganspace_tpu_torch.models import biggan as torch_bg
from ganspace_tpu_torch.models import dcgan as torch_dc
from ganspace_tpu_torch.models import proggan as torch_pg
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops import precision

from torch_port_jax_bf16 import one_pass_bf16

jax_precision = importlib.import_module("ganspace_tpu.ops.precision")

BG = dict(output_dim=32, z_dim=16, channel_width=8, attention_layer_position=2,
          layers=((False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2)))
PG = (64, 32, 32, 16)
DC = dict(resolution=16, base_channels=64)
POLICIES = [("highest", "bfloat16"), ("default", None), ("default", "bfloat16")]
# max|port - JAX| / max|JAX| of the image, by (family, precision, storage):
# the measured distances (z of seed 17) with room, the default rows under
# the distance of a port that skips the operand rounding (bg 0.00495 and
# 0.00672, pg 0.00637, dc 0.00010 and 0.00010).
# bg: 0.00411, 0.00036, 0.00349; pg: 0.01446, 0.00004, 0.01446;
# dc: 0 (float32 storage: the float32 image), 0, 0
IMAGE_REL = {
    ("bg", "highest", "bfloat16"): 0.008, ("bg", "default", None): 0.002,
    ("bg", "default", "bfloat16"): 0.005,
    ("pg", "highest", "bfloat16"): 0.03, ("pg", "default", None): 0.002,
    ("pg", "default", "bfloat16"): 0.03,
    ("dc", "highest", "bfloat16"): 1e-6, ("dc", "default", None): 5e-5,
    ("dc", "default", "bfloat16"): 5e-5,
}
# one tap per family under bf16 storage: (tap, its storage, bar), the bars
# about twice the measured distances (z of seed 5): 0.0039 (bg, the first
# up-conv of JAX's space-to-depth tail), 0.0065 (pg, its first up layer),
# 2.8e-7 (dc, float32 storage: the sum order alone)
# the viewer gate's models: BigGAN-512 at width 4, ProGAN-256 at half
# width, DCGAN-64 at full width
VIEWER_MODELS = {"BigGAN": ("bg", dict(resolution=512, channel_width=4)),
                 "ProGAN": ("pg", (256, 256, 256, 256, 128, 64, 32, 16)),
                 "DCGAN": ("dc", {})}
# the port's preview error over the JAX package's, on the same model (the
# band of tests/test_torch_port_interactive.py)
PREVIEW_ERR_BAND = (0.8, 1.25)
TAPS = {"bg": ("generator.layers.3.conv_1", torch.bfloat16, 0.008),
        "pg": ("layer3", torch.bfloat16, 0.013),
        "dc": ("deconv1", torch.float32, 1e-6)}


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
    exit, since the JAX package reads the policy when it traces.  Under
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


def _pair(family, seed=3, cfg=None):
    if family == "bg":
        kw = cfg or BG
        if "resolution" in kw:
            kw = dict(kw)
            jcfg = jax_bg.BigGANConfig.for_resolution(kw.pop("resolution"), **kw)
        else:
            jcfg = jax_bg.BigGANConfig(**kw)
        params = jax_bg.init_params(jcfg, seed)
        tcfg = torch_bg.BigGANConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
        return (jax_bg.BigGAN(128, "husky", cfg=jcfg, params=params),
                torch_bg.BigGAN(128, "husky", cfg=tcfg, params=params, device="cpu"))
    if family == "pg":
        sizes = cfg or PG
        params = jax_pg.init_params(jax_pg.ProGANConfig(sizes), seed)
        return (jax_pg.ProGAN("bedroom", cfg=jax_pg.ProGANConfig(sizes), params=params),
                torch_pg.ProGAN("bedroom", cfg=torch_pg.ProGANConfig(sizes), params=params,
                                device="cpu"))
    kw = DC if cfg is None else cfg
    params = jax_dc.init_params(jax_dc.DCGANConfig(**kw), seed)
    return (jax_dc.GANZooModel(cfg=jax_dc.DCGANConfig(**kw), params=params),
            torch_dc.GANZooModel(cfg=torch_dc.DCGANConfig(**kw), params=params, device="cpu"))


@pytest.fixture(scope="module")
def models():
    return {family: _pair(family) for family in ("bg", "pg", "dc")}


@pytest.mark.parametrize("prec,storage", POLICIES)
@pytest.mark.parametrize("family", ["bg", "pg", "dc"])
def test_image_under_each_preview_policy(models, family, prec, storage):
    jax_model, port = models[family]
    z = port.sample_latent(2, seed=17)
    bar = IMAGE_REL[family, prec, storage]
    with policy(prec, storage):
        ref = np.asarray(jax_model.forward(z.numpy()))
        got = port.forward(z)
        if prec == "default":
            with precision.precision("highest"):
                unrounded = port.forward(z)
            if family == "pg" and storage == "bfloat16":
                # bf16 storage rounds every operand already: the precision
                # changes nothing, in the port as in JAX
                assert torch.equal(unrounded, got)
                with jax_precision.precision("highest"):
                    jax.clear_caches()
                    assert np.array_equal(np.asarray(jax_model.forward(z.numpy())), ref)
            else:
                assert _rel(unrounded.numpy(), ref) > bar
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert tuple(got.shape) == ref.shape
    rel = _rel(got.numpy(), ref)
    assert rel < bar, rel


@pytest.mark.parametrize("family", ["bg", "pg", "dc"])
def test_tap_under_bf16_storage(models, family):
    """One tap's activation under bf16 storage: the JAX package's dtype (the
    storage for BigGAN and ProGAN, float32 for DCGAN) and values."""
    jax_model, port = models[family]
    tap, dtype, bar = TAPS[family]
    z = port.sample_latent(2, seed=5)
    jax_inst, inst = JaxInstrumented(jax_model), InstrumentedModel(port)
    jax_inst.retain_layer(tap)
    inst.retain_layer(tap)
    try:
        with policy("highest", "bfloat16"):
            jax_model.partial_forward(z.numpy(), tap)
            port.partial_forward(z, tap)
        ref, got = jax_inst.retained_layer(tap), inst.retained_layer(tap)
    finally:
        jax_model.inst = port.inst = None
    assert got.dtype == dtype and str(ref.dtype) == str(dtype).split(".")[1]
    assert tuple(got.shape) == tuple(ref.shape)
    rel = _rel(got.float().numpy(), np.asarray(ref, np.float32))
    assert rel < bar, rel


def _meta(path):
    with np.load(path) as d:
        return json.loads(d["_meta"].item().decode()), set(d.files), d["act_comp"].copy()


def test_progan_bf16_cache_matches_jax(tmp_path, monkeypatch, capsys):
    """``--dtype bfloat16`` at ProGAN's ``layer2`` (the moments tier): the
    _bf16 name, the npz keys and the _meta fields against the JAX package's
    cache of the same model and latents (the host stream)."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    jax_model, port = _pair("pg", seed=4)
    kw = dict(model="ProGAN", output_class="bedroom", layer="layer2", estimator="ipca",
              components=3, n=1024, batch_size=128, dtype="bfloat16")
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    ref_path = jax_get_or_compute(JaxConfig(**kw), JaxInstrumented(jax_model))
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "port"))
    with contextlib.redirect_stdout(io.StringIO()):
        path = get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))
    capsys.readouterr()
    assert path.name == ref_path.name and path.name.endswith("_bf16.npz")
    (meta, keys, comp), (ref, ref_keys, ref_comp) = _meta(path), _meta(ref_path)
    assert keys == ref_keys and set(meta) == set(ref)
    # (mesh: the JAX tests run on an 8-device CPU mesh, the port on one device)
    for k in ("dtype", "device_rng", "fused_linreg", "refine_skipped", "bf16_pass1",
              "bf16_pass1_aborted", "bf16_analysis_grade"):
        assert meta[k] == ref[k], k
    assert meta["dtype"] == "bfloat16" and meta["mesh"] is None
    np.testing.assert_allclose(meta["bf16_cos_bounds"], ref["bf16_cos_bounds"], atol=0.02)
    cos = np.abs(np.sum(comp.reshape(3, -1) * ref_comp.reshape(3, -1), axis=1))
    assert cos.min() > 0.99, cos


@pytest.mark.parametrize("name", sorted(VIEWER_MODELS))
def test_preview_error_matches_jax(name):
    """The preview frame against the float32 frame of the same latents, mean
    uint8 levels, in both packages: the port's within PREVIEW_ERR_BAND of
    JAX's, JAX's the figure chip_smoke.py's viewer gate scales."""
    family, cfg = VIEWER_MODELS[name]
    jax_model, port = _pair(family, seed=0, cfg=cfg)
    z = port.sample_latent(1, seed=17)
    jax.clear_caches()
    jax_f32 = np.asarray(jax_interactive._frame_u8(jax_model.forward(z.numpy()))).astype(np.int16)
    port_f32 = frame_u8(port.forward(z)).astype(np.int16)
    with policy("default", "bfloat16"):
        jax_pre = np.asarray(jax_interactive._frame_u8(jax_model.forward(z.numpy())))
        port_pre = frame_u8(port.forward(z))
    assert np.abs(port_f32 - jax_f32).max() <= 1
    d_jax = np.abs(jax_pre.astype(np.int16) - jax_f32)
    d_port = np.abs(port_pre.astype(np.int16) - port_f32)
    print(f"\n{name} {jax_f32.shape[1]} px, preview error in uint8 levels: JAX mean "
          f"{d_jax.mean():.4f} max {d_jax.max()}, port mean {d_port.mean():.4f} max "
          f"{d_port.max()}")
    lo, hi = PREVIEW_ERR_BAND
    assert lo * d_jax.mean() <= d_port.mean() <= hi * d_jax.mean()
    np.testing.assert_allclose(d_jax.mean(), chip_smoke.PREVIEW_JAX_MEAN_LEVELS[name],
                               rtol=0.05)
