"""The port's block stream (``IPCAEstimator.fit_stream``), its accumulators,
the fused regression and the per-block generators, against the JAX package.

The JAX blocks are drawn with ``fold_in(PRNGKey(7), i)`` and handed to the
port's ``block_fn(i)`` as the same numpy arrays (as
``tests/test_fused_linreg.py:47-53`` materialises them), so both estimators
see the same samples.  The sketch tier is reached by lowering
``GANSPACE_IPCA_MOMENTS_MAX_D`` (both packages read it), and the port
sketches against JAX's Omega.  Bars: components min |cos| > 0.9999; the
moments, the regression and the finish bundle to 1e-5 relative.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganspace_tpu.decomposition import regression_from_moments as jax_regression
from ganspace_tpu.estimators.ipca import IPCAEstimator as JaxIPCA

from ganspace_tpu_torch import sampling
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import (
    acts_stream_block, get_or_compute, regression_from_moments)
from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


D, NB, ZDIM, C, N_BLOCKS = 96, 256, 32, 5, 12
REL = 1e-5
CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))


def _jax_omega(d, l):
    return np.array(jax.random.normal(jax.random.PRNGKey(0xA5), (d, l), jnp.float32))


@pytest.fixture(params=["moments", "sketch"])
def tier(request, monkeypatch):
    monkeypatch.setattr(ipca, "sketch_test_matrix", _jax_omega)
    monkeypatch.delenv("GANSPACE_IPCA_REFINE", raising=False)
    if request.param == "sketch":
        monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "64")
    else:
        monkeypatch.delenv("GANSPACE_IPCA_MOMENTS_MAX_D", raising=False)
    return request.param


def _stream():
    """A synthetic tap: x = tanh(z W) * i^-0.7 + 0.25 with its latents z; the
    sketch tier's adaptive policy keeps the refine pass on it."""
    rs = np.random.RandomState(0)
    w = jnp.asarray(rs.randn(ZDIM, D).astype(np.float32))
    scale = jnp.asarray((np.arange(1, D + 1) ** -0.7).astype(np.float32))

    def block_fn(key):
        z = jax.random.normal(key, (NB, ZDIM), jnp.float32)
        return jnp.tanh(z @ w) * scale + 0.25, z

    key = jax.random.PRNGKey(7)
    blocks = [tuple(np.array(a) for a in block_fn(jax.random.fold_in(key, i)))
              for i in range(N_BLOCKS)]
    return block_fn, key, blocks


def _rand_dirs():
    r = np.random.RandomState(1).randn(C, D).astype(np.float32)
    return r / np.linalg.norm(r, axis=1, keepdims=True)


def _fit_both():
    block_fn, key, blocks = _stream()
    ref = JaxIPCA(C)
    assert ref.fit_stream(block_fn, N_BLOCKS, key, chunk=4, with_reg=True,
                          rand_dirs=jnp.asarray(_rand_dirs()))
    got, seen = IPCAEstimator(C), []

    def port_block(i):
        seen.append(i)
        return tuple(torch.from_numpy(a) for a in blocks[i])
    assert got.fit_stream(port_block, N_BLOCKS, with_reg=True,
                          rand_dirs=torch.from_numpy(_rand_dirs()))
    return ref, got, blocks, seen


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _unit_rows(m):
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def test_fit_stream_matches_jax(tier):
    ref, got, _, seen = _fit_both()
    assert (got._moments is not None) == (tier == "moments")
    assert (got._nystrom is not None) == (tier == "sketch")
    assert got.refine_skipped is ref.refine_skipped is (None if tier == "moments" else False)
    # pass 1 asks for every block once (block 0 is the shape probe, kept),
    # the refine pass for every block again
    assert seen == list(range(N_BLOCKS)) * (1 if tier == "moments" else 2)
    assert got.n_samples_seen_ == ref.n_samples_seen_ == N_BLOCKS * NB
    assert _rel(got.mean_, ref.mean_) <= REL
    (gxz, gzs, gn), (rxz, rzs, rn) = got.reg_moments(), ref.reg_moments()
    assert gn == rn == N_BLOCKS * NB          # the last pass only, never doubled
    assert _rel(gxz, rxz) <= REL and _rel(gzs, rzs) <= REL
    (gpm, gpm2, gpn), (rpm, rpm2, rpn) = got.rand_moments(), ref.rand_moments()
    assert gpn == rpn == N_BLOCKS * NB
    assert _rel(gpm, rpm) <= REL and _rel(gpm2, rpm2) <= REL
    gc, _, _ = got.get_components()
    rc, _, _ = ref.get_components()
    cos = np.abs(np.sum(gc * np.asarray(rc), axis=1))
    assert cos.min() > 0.9999, cos


def test_regression_from_moments_matches_jax_and_the_exact_solve(tier):
    _, got, blocks, _ = _fit_both()
    comp, stdev, _ = got.get_components()
    mean = got.mean_.reshape(1, -1)
    reg = got.reg_moments()
    z_comp, z_mean = regression_from_moments(comp, mean, stdev, reg)
    ref_comp, ref_mean = jax_regression(
        comp, mean, stdev, tuple(jnp.asarray(a.numpy()) for a in reg[:2]) + (reg[2],))
    assert _rel(z_comp, ref_comp) <= REL and _rel(z_mean, ref_mean) <= REL
    # the explicit least-squares solve over the same samples
    x_all = np.concatenate([b[0] for b in blocks]).astype(np.float64)
    z_all = np.concatenate([b[1] for b in blocks]).astype(np.float64)
    np.testing.assert_allclose(z_mean[0], z_all.mean(axis=0), atol=1e-5)
    coords = (x_all - mean) @ comp.T / stdev
    exact, *_ = np.linalg.lstsq(coords, z_all, rcond=None)
    cos = np.abs(np.sum(_unit_rows(z_comp) * _unit_rows(exact), axis=-1))
    assert cos.min() > (0.9999 if tier == "moments" else 0.99), cos


def test_finish_latent_bundle_carries_the_rand_moments(monkeypatch):
    monkeypatch.delenv("GANSPACE_IPCA_MOMENTS_MAX_D", raising=False)
    ref, got, _, _ = _fit_both()
    _, rstats = ref.finish_latent_bundle(rand_moments=ref.rand_moments())
    _, gstats = got.finish_latent_bundle(rand_moments=got.rand_moments())
    assert gstats.shape == rstats.shape == (4, C)
    np.testing.assert_allclose(gstats, rstats, rtol=REL)
    assert (gstats[3] > 0).all()
    # without them the fourth row is zeros, as in JAX
    assert not got.finish_latent_bundle()[1][3].any()


# -- the per-block generators -----------------------------------------------

def _draw(seed, stream, i, n=64, d=8):
    return sampling.device_gaussian(sampling.block_generator(seed, stream, i, "cpu"), n, d)


def test_block_depends_on_its_index_alone():
    seq = [_draw(1, sampling.STREAM_MAIN, i) for i in range(6)]
    assert torch.equal(_draw(1, sampling.STREAM_MAIN, 4), seq[4])
    # the pre-sampled device stream and the fused stream draw the same
    # latents for block i, whatever the number of blocks asked for
    cfg = torch_sg2.SG2Config(resolution=32, channels=CHANNELS)
    model = torch_sg2.StyleGAN2("ffhq", cfg=cfg, params=torch_sg2.init_params(cfg, seed=3),
                                device="cpu")
    long, short = (model.sample_latents_device(k, 16, seed=1) for k in (5, 3))
    assert all(torch.equal(a, b) for a, b in zip(long, short))
    _, lat = acts_stream_block(model, "convs.1", 16, seed=1)(4)
    assert torch.equal(lat, long[4])


def test_refine_pass_sees_the_first_pass_samples(monkeypatch):
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "16")
    scale = (torch.arange(1, 33, dtype=torch.float32) ** -0.5)
    seen = []

    def block_fn(i):
        x = _draw(5, sampling.STREAM_MAIN, i, n=64, d=32) * scale
        seen.append((i, x))
        return x
    est = IPCAEstimator(4, refine="always")
    assert est.fit_stream(block_fn, 5, rand_dirs=torch.eye(4, 32))
    assert est._refined and len(seen) == 10
    for (i, x), (j, y) in zip(seen[:5], seen[5:]):
        assert i == j and torch.equal(x, y)


def test_streams_never_share_a_seed():
    streams = (sampling.STREAM_MAIN, sampling.STREAM_W_TAIL, sampling.STREAM_LINREG,
               sampling.STREAM_RAND_DIRS, sampling.STREAM_LABELS)
    seeds = [sampling.block_seed(s, t, i) for s in (0, 1, 2, 3, 7, 2**31 - 1)
             for t in streams for i in range(300)]
    assert len(set(seeds)) == len(seeds)
    cpu = {(s ^ (s >> 32)) & 0xFFFFFFFF for s in seeds}
    assert len(cpu) == len(seeds)
    # the regression stream under SEED_LINREG is not the main stream under
    # a user seed of 3 (in JAX both are PRNGKey(3))
    assert not torch.equal(_draw(sampling.SEED_LINREG, sampling.STREAM_LINREG, 0),
                           _draw(3, sampling.STREAM_MAIN, 0))
    for bad in ((-1, 0, 0), (0, 5, 0), (0, 0, 2**31)):
        with pytest.raises(ValueError):
            sampling.block_seed(bad[0], bad[1], bad[2])


def test_random_directions_device_are_unit_and_deterministic():
    dirs = sampling.random_directions_device(6, 300, "cpu")
    assert dirs.shape == (6, 300) and dirs.dtype == torch.float32
    np.testing.assert_allclose(dirs.norm(dim=1).numpy(), 1.0, atol=1e-6)
    assert torch.equal(dirs, sampling.random_directions_device(6, 300, "cpu"))
    host = sampling.random_directions(6, 300)
    assert np.abs(dirs.numpy() - host).max() > 0.1      # another stream


# -- an interrupt in the fused refine pass ----------------------------------

def test_abort_refine_restores_the_in_place_sums(monkeypatch):
    """The cross-moments update in place.  Two refine blocks land before the
    interrupt; ``abort_refine`` must bring back the first pass's sums bit
    for bit, as a never-refine fit over the same blocks has them
    (``tests/test_fused_linreg.py:230-257``)."""
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "16")
    scale = torch.arange(1, 33, dtype=torch.float32) ** -0.5
    calls = []

    def block_fn(i):
        calls.append(i)
        if len(calls) == 8:                         # the third refine block
            raise KeyboardInterrupt
        z = _draw(5, sampling.STREAM_LINREG, i, n=64, d=8)
        return _draw(5, sampling.STREAM_MAIN, i, n=64, d=32) * scale, z
    dirs = torch.eye(4, 32)
    cut, single = IPCAEstimator(4, refine="always"), IPCAEstimator(4, refine="never")
    with pytest.raises(KeyboardInterrupt):
        cut.fit_stream(block_fn, 5, with_reg=True, rand_dirs=dirs)
    assert cut._refined and cut._reg[2] == 2 * 64     # the refine pass's own sums
    cut.abort_refine()
    calls.clear()
    assert single.fit_stream(block_fn, 5, with_reg=True, rand_dirs=dirs)
    assert cut.n_samples_seen_ == single.n_samples_seen_ == 5 * 64
    for got, ref in ((cut.reg_moments(), single.reg_moments()),
                     (cut.rand_moments(), single.rand_moments())):
        assert got[2] == ref[2] == 5 * 64
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_fused_refine_interrupt_saves_the_first_pass_under_partial(tmp_path, monkeypatch):
    """The refine pass of the fused activation stream is cut after one
    block: the first-pass sketch, cross-moments and random moments come
    back, and the save under ``_partial`` equals a never-refine run's."""
    monkeypatch.setenv("GANSPACE_FUSED_ACTS", "1")
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "1024")
    monkeypatch.delenv("GANSPACE_DEVICE_RNG", raising=False)
    cfg = torch_sg2.SG2Config(resolution=32, channels=CHANNELS)
    params = torch_sg2.init_params(cfg, seed=3)
    kw = dict(model="StyleGAN2", output_class="ffhq", layer="convs.1", estimator="ipca",
              components=4, n=2000, batch_size=500, device="cpu")

    def run(out, refine):
        monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / out))
        monkeypatch.setenv("GANSPACE_IPCA_REFINE", refine)
        model = torch_sg2.StyleGAN2("ffhq", cfg=cfg, params=params, device="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            return get_or_compute(Config(**kw), InstrumentedModel(model))

    refining = []
    begin, update = ipca.IPCAEstimator.begin_refine, ipca.nystrom_update

    def armed(self, force=False):
        refining.append(begin(self, force))
        return refining[-1]

    def cut(state, x, omega):
        if refining and state.count > 0:
            raise KeyboardInterrupt
        return update(state, x, omega)
    monkeypatch.setattr(ipca.IPCAEstimator, "begin_refine", armed)
    monkeypatch.setattr(ipca, "nystrom_update", cut)
    with pytest.raises(SystemExit):
        run("cut", "always")
    monkeypatch.setattr(ipca.IPCAEstimator, "begin_refine", begin)
    monkeypatch.setattr(ipca, "nystrom_update", update)
    assert refining == [True]
    folder = tmp_path / "cut" / "cache" / "components"
    saved = sorted(p.name for p in folder.iterdir())
    assert saved == ["stylegan2-ffhq_convs.1_ipca_c4_n2000_partial.npz"]
    single_path = run("single", "never")
    with np.load(folder / saved[0]) as c, np.load(single_path) as s:
        meta = json.loads(c["_meta"].item())
        assert meta["refine_skipped"] is None and meta["fused_linreg"] is True
        assert json.loads(s["_meta"].item())["refine_skipped"] is True
        for k in ("act_comp", "act_stdev", "var_ratio", "lat_comp", "lat_mean",
                  "random_stdevs"):
            np.testing.assert_array_equal(c[k], s[k], err_msg=k)
