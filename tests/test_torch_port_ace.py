"""The port's ACE (``ganspace_tpu_torch/dissection/ace.py``) against the
JAX package's on identical weights and latents.

``ace_optimize`` on the tiny DCGAN of ``tests/test_ace.py`` with the JAX
tests' ``TINY`` unified segmenter, as that file runs it (12 Adam steps):
the loss history and the ablation within 1e-4, the ranking equal wherever
the ablation values differ by more than 1e-4, ``ablation_effect`` within
1e-4; ``_edit_override`` cleared after an error; and the gradient of the
class presence with respect to the ablation (autograd through the plain
versions of the kernels, the chain the card's adjoints are held to) against
``jax.grad`` on a tiny StyleGAN2 (modulated 3x3 and stride-2 convs after
the tap) and a tiny ProGAN (plain 3x3 and nearest-up convs), to 2e-3 of
its largest element."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganspace_tpu.dissection import ace as jace
from ganspace_tpu.dissection import segmenter as jseg
from ganspace_tpu.dissection import segmodel as jsm
from ganspace_tpu.models import dcgan as jax_dc
from ganspace_tpu.models import proggan as jax_pg
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch.dissection import ace
from ganspace_tpu_torch.dissection import segmenter as tseg
from ganspace_tpu_torch.dissection import segmodel as tsm
from ganspace_tpu_torch.models import dcgan as torch_dc
from ganspace_tpu_torch.models import proggan as torch_pg
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel

from test_torch_port_segmenter import tiny_upernet

TOL = 1e-4
CLASSNUM = 3
#: the gradient's bar, relative to its largest element: the random
#: segmenter's input gradient is ill-conditioned in float32 (on 32-px
#: images JAX's jitted and eager gradients of one class probability differ
#: by 6.7e-4 relative, the port's lies between them)
GRAD_REL = 2e-3


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _segs(size):
    return (jseg.UnifiedParsingSegmenter(cfg=tiny_upernet(jsm), segsizes=(size,), seed=0),
            tseg.UnifiedParsingSegmenter(cfg=tiny_upernet(tsm), segsizes=(size,), seed=0,
                                         device="cpu"))


@pytest.fixture(scope="module")
def dcgan():
    cfg = dict(resolution=16, base_channels=64)
    params = jax_dc.init_params(jax_dc.DCGANConfig(**cfg), 0)
    return (JaxInstrumented(jax_dc.GANZooModel(cfg=jax_dc.DCGANConfig(**cfg), params=params)),
            InstrumentedModel(torch_dc.GANZooModel(cfg=torch_dc.DCGANConfig(**cfg),
                                                   params=params, device="cpu")))


@pytest.fixture(scope="module")
def optimized(dcgan):
    """Both packages' ``ace_optimize`` and ``ablation_effect`` on the same
    model, segmenter and latents (``tests/test_ace.py``'s arguments)."""
    jinst, tinst = dcgan
    jsegm, tsegm = _segs(16)
    kw = dict(n_batches=2, batch=4, steps=12, lr=0.1, l1=1e-4, seed=2)
    ref = jace.ace_optimize(jinst, "deconv1", jsegm, CLASSNUM, **kw)
    got = ace.ace_optimize(tinst, "deconv1", tsegm, CLASSNUM, **kw)
    ekw = dict(ks=(0, 4), n_batches=1, batch=4)
    ref_eff = jace.ablation_effect(jinst, "deconv1", jsegm, CLASSNUM, ref["ranking"], **ekw)
    got_eff = ace.ablation_effect(tinst, "deconv1", tsegm, CLASSNUM, ref["ranking"], **ekw)
    return got, ref, got_eff, ref_eff


def test_ace_optimize_matches_jax(optimized):
    got, ref, _, _ = optimized
    assert set(got) == set(ref)
    assert (got["units"], got["classnum"], got["layer"]) == \
        (ref["units"], ref["classnum"], ref["layer"])
    assert abs(got["baseline"] - ref["baseline"]) <= TOL
    assert len(got["loss_history"]) == 12
    assert np.abs(np.subtract(got["loss_history"], ref["loss_history"])).max() <= TOL
    assert got["loss_history"][-1] <= got["loss_history"][0] + 1e-6
    a, b = got["ablation"], np.asarray(ref["ablation"])
    assert a.shape == b.shape and np.all((a >= 0) & (a <= 1))
    assert np.abs(a - b).max() <= TOL
    # the ranking: the same order wherever the values are apart
    order = np.asarray(ref["ranking"])
    apart = np.abs(np.diff(b[order])) > TOL
    pos = {u: i for i, u in enumerate(got["ranking"])}
    for i in np.flatnonzero(apart):
        assert pos[order[i]] < pos[order[i + 1]]


def test_ablation_effect_matches_jax(optimized):
    _, _, got_eff, ref_eff = optimized
    assert set(got_eff) == set(ref_eff) == {0, 4}
    for k in ref_eff:
        assert abs(got_eff[k] - ref_eff[k]) <= TOL, k


def test_edit_override_cleared_after_error(dcgan):
    _, tinst = dcgan
    with pytest.raises(Exception):
        ace._forward_with_ablation(tinst, "deconv0", "not-a-latent", torch.ones(()))
    assert tinst._edit_override is None
    # and no graph outside ACE: a plain forward keeps none
    img = tinst.model.forward(tinst.model.sample_latent(1, seed=0))
    assert not img.requires_grad


def _present_class(jinst, jsegm, z) -> int:
    """The flat object label with the largest mean probability on the
    model's images (random weights leave no better choice)."""
    probs = np.asarray(jsegm.category_probabilities(jinst.model.forward(jnp.asarray(z)))["object"])
    return int(np.argmax(probs.mean(axis=(0, 2, 3))[1:])) + 1


def _presence_grad(jinst, tinst, layer, jsegm, tsegm, z, units, rank):
    """d mean p_class / d alpha at alpha = 0.3 (a uniform partial
    ablation), in both packages, for the most present object class."""
    classnum = _present_class(jinst, jsegm, z)
    shape = (1, units) + (1,) * (rank - 2)
    alpha0 = np.full((units,), 0.3, np.float32)
    jtap, ttap = jinst.model.resolve_tap(layer), tinst.model.resolve_tap(layer)

    def jloss(alpha):
        img = jace._forward_with_ablation(jinst, jtap, jnp.asarray(z), alpha.reshape(shape))
        return jace._class_presence(jsegm, img, classnum)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(alpha0)))
    alpha = torch.from_numpy(alpha0).requires_grad_(True)
    img = ace._forward_with_ablation(tinst, ttap, torch.from_numpy(np.asarray(z)),
                                     alpha.reshape(shape))
    ace._class_presence(tsegm, img, classnum).backward()
    return alpha.grad.numpy(), ref


@pytest.mark.parametrize("family", ["StyleGAN2", "ProGAN"])
def test_gradient_wrt_ablation_matches_jax(family):
    if family == "StyleGAN2":
        channels = ((4, 32), (8, 32), (16, 16), (32, 16))
        jcfg = jax_sg2.SG2Config(resolution=32, channels=channels)
        params = jax_sg2.init_params(jcfg, seed=5)
        jm = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jcfg, params=params)
        tm = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=32,
                                                                channels=channels),
                                 init_seed=11, device="cpu")
        tm.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()})
        layer, units = "conv1", 32            # then modulated up and 3x3 convs
    else:
        sizes = (64, 32, 32, 16)
        params = jax_pg.init_params(jax_pg.ProGANConfig(sizes), 3)
        jm = jax_pg.ProGAN("bedroom", cfg=jax_pg.ProGANConfig(sizes), params=params)
        tm = torch_pg.ProGAN("bedroom", cfg=torch_pg.ProGANConfig(sizes), params=params,
                             device="cpu")
        layer, units = "layer2", 32           # then nearest-up and plain 3x3 convs
    jinst, tinst = JaxInstrumented(jm), InstrumentedModel(tm)
    jsegm, tsegm = _segs(32)
    z = np.asarray(tm.sample_latent(2, seed=4))
    assert np.array_equal(z, np.asarray(jm.sample_latent(2, seed=4)))
    got, ref = _presence_grad(jinst, tinst, layer, jsegm, tsegm, z, units, 4)
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= GRAD_REL * np.abs(ref).max()
    assert tinst._edit_override is None


@pytest.mark.parametrize("mode", ["modulated", "modulated_no_d", "plain", "up_sd", "up"])
def test_adjoint_formulas_match_autograd_of_the_plain_versions(mode):
    """The x-adjoints the card's backward computes (kernel B on W~, the
    stride-2 mode's stock conv), in their plain form on the CPU, against
    autograd through the plain forwards."""
    from ganspace_tpu_torch.ops import modconv as mc
    rs = np.random.RandomState(1)
    b, c, co, h, w = 2, 6, 5, 7, 9
    x = torch.from_numpy(rs.randn(b, c, h, w).astype(np.float32)).requires_grad_(True)
    wt = torch.from_numpy(rs.randn(co, c, 3, 3).astype(np.float32))
    s = torch.from_numpy(1 + 0.3 * rs.randn(b, c).astype(np.float32))
    d = mc.demodulation(wt, s)
    if mode.startswith("up"):
        pad = 1 if mode == "up" else 0
        sd = (s, d) if mode == "up_sd" else (None, None)
        y = mc.upsample_conv_plain(x, wt, *sd, pad=pad)
        gy = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
        got = mc.upsample_conv_adjoint(gy, wt, *sd, pad=pad)
    else:
        sd = {"modulated": (s, d), "modulated_no_d": (s, None), "plain": (None, None)}[mode]
        y = (mc.conv3x3_plain(x, wt) if mode == "plain"
             else mc.modconv3x3_plain(x, wt, *sd))
        gy = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
        got = mc.conv3x3_adjoint_plain(gy, wt, *sd)
    ref = torch.autograd.grad(y, x, gy)[0]
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_ace_report_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is not installed the ACE page holds its table
    alone, and the report says that the plots were not written."""
    import importlib.util

    from ganspace_tpu_torch.dissection.report import generate_ace_report
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    run = {"ablation": np.array([0.0, 1.0, 0.5]), "ranking": np.array([1, 2, 0]),
           "loss_history": [0.3, 0.2], "baseline": 0.25}
    page = generate_ace_report(tmp_path, "tree", {"ace": run}, {"Units by ACE": {0: 0.2, 1: 0.1}})
    assert "matplotlib is not installed" in capsys.readouterr().out
    html = page.read_text()
    assert "<img" not in html and "saturated units" in html and "1/3" in html
    assert not list(tmp_path.glob("*.png"))
