"""The port's device-RNG paths end to end, on a small StyleGAN2.

The synthesis is narrow (32 px) but the mapping is the full 8 x 512 one, so
the W-space spectrum is the real network's kind.  Device streams differ
between the packages (threefry in JAX, the CPU generator here), so the
streams are held to JAX's device-RNG runs statistically: by the gate of
``chip_smoke.py`` (``stream_gate``), against the control of the host
stream under seed 1 and seed 7 on the same weights, for the fused W stream
and for the fused activation stream at a conv tap.  The gate must also
reject a stream that repeats one block: the planted fault.  Run with
``-s`` to print each gate's ratios.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from chip_smoke import GATE_RATIOS, stream_gate
from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch import decomposition, models as torch_models, sampling
from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import (
    _warn_on_provenance_mismatch, acts_stream_block, get_or_compute)
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))
W_KW = dict(model="StyleGAN2", output_class="ffhq", layer="style", estimator="ipca",
            components=80, n=40960, use_w=True)
# A conv tap on the moments tier (conv1: 64 x 4 x 4 = 1024 dims) with enough
# components and samples that the control resolves 16 cuts.
CONV_KW = dict(model="StyleGAN2", output_class="ffhq", layer="conv1", estimator="ipca",
               components=32, n=16384, batch_size=512)


@pytest.fixture(scope="module")
def params():
    return jax_sg2.init_params(jax_sg2.SG2Config(resolution=32, channels=CHANNELS), seed=3)


def _port(params):
    return torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=32,
                                                               channels=CHANNELS),
                               params=params, device="cpu")


def _load(path):
    with np.load(path, allow_pickle=False) as d:
        out = {k: d[k] for k in d.files}
    out["_meta"] = json.loads(out["_meta"].item())
    return out


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


class _Runs:
    """Fits of one configuration, each into its own output folder, under
    an environment set for the call only."""

    def __init__(self, params, kw, folder):
        self.params, self.kw, self.folder = params, kw, folder

    def port(self, tag, env, **kw):
        with pytest.MonkeyPatch.context() as mp:
            self._env(mp, tag, env)
            return _load(_quiet(get_or_compute, Config(device="cpu", **self.kw, **kw),
                                InstrumentedModel(_port(self.params))))

    def jax(self, env):
        with pytest.MonkeyPatch.context() as mp:
            self._env(mp, "jax", env)
            model = jax_sg2.StyleGAN2(class_name="ffhq", params=self.params,
                                      cfg=jax_sg2.SG2Config(resolution=32, channels=CHANNELS))
            return _load(_quiet(jax_get_or_compute, JaxConfig(mesh_shape="1", **self.kw),
                                JaxInstrumented(model)))

    def _env(self, mp, tag, env):
        mp.setenv("GANSPACE_OUTPUT_DIR", str(self.folder / tag))
        for k, v in env.items():
            if v is None:
                mp.delenv(k, raising=False)
            else:
                mp.setenv(k, v)


def _controlled(runs, env):
    """(JAX's device-RNG run, the port's host runs under seeds 1 and 7)."""
    ref = runs.jax(dict(env, GANSPACE_DEVICE_RNG=None))
    host = runs.port("host", dict(env, GANSPACE_DEVICE_RNG="0"))
    ctrl = runs.port("host7", dict(env, GANSPACE_DEVICE_RNG="0"), seed=7)
    assert ref["_meta"]["device_rng"] is True
    assert host["_meta"]["device_rng"] is ctrl["_meta"]["device_rng"] is False
    return ref, host, ctrl


@pytest.fixture(scope="module")
def w_runs(params, tmp_path_factory):
    runs = _Runs(params, W_KW, tmp_path_factory.mktemp("w"))
    return runs, _controlled(runs, {})


@pytest.fixture(scope="module")
def conv_runs(params, tmp_path_factory):
    runs = _Runs(params, CONV_KW, tmp_path_factory.mktemp("conv"))
    return runs, _controlled(runs, {"GANSPACE_FUSED_ACTS": "1"})


def _gate(what, ref, dev, host, ctrl):
    cuts, err, ctrl_err, ratios = stream_gate((ref, dev), (host, ctrl), host["act_stdev"])
    print(f"\n{what}: {len(cuts)} cuts {cuts}\n  device (port vs JAX) {err}\n"
          f"  control {ctrl_err}\n  ratios {ratios}")
    return ratios


def _passes(ratios):
    return all(ratios[k] <= GATE_RATIOS[k] for k in ratios)


def test_w_path_device_stream_meets_the_seed_control(w_runs):
    """The default environment takes the fused W stream and records it;
    its components against JAX's device-RNG run meet the bar that the host
    seed-1-vs-seed-7 control sets."""
    runs, (ref, host, ctrl) = w_runs
    dev = runs.port("device", {"GANSPACE_DEVICE_RNG": None})
    assert dev["_meta"]["device_rng"] is ref["_meta"]["device_rng"] is True
    assert dev["_meta"]["fused_linreg"] is False
    assert set(dev["_meta"]) == set(ref["_meta"])
    ratios = _gate("W, device seed 1", ref, dev, host, ctrl)
    assert _passes(ratios), ratios
    for k in ("act_stdev", "var_ratio", "lat_stdev", "random_stdevs"):
        assert dev[k].shape == (80,) and (dev[k] > 0).all(), k


@pytest.mark.parametrize("seed", [2, 3, 4, 5])
def test_w_gate_under_other_device_seeds(w_runs, seed):
    """The readings the bars leave room over: the device stream under other
    seeds against the same JAX run and control."""
    runs, (ref, host, ctrl) = w_runs
    dev = runs.port(f"device{seed}", {"GANSPACE_DEVICE_RNG": None}, seed=seed)
    ratios = _gate(f"W, device seed {seed}", ref, dev, host, ctrl)
    assert _passes(ratios), ratios


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_conv_tap_fused_stream_meets_the_seed_control(conv_runs, seed):
    """The fused activation stream at a conv tap (the regression and the
    random moments riding it), against JAX's fused device-RNG run, by the
    same gate and bars."""
    runs, (ref, host, ctrl) = conv_runs
    dev = runs.port(f"device{seed}", {"GANSPACE_DEVICE_RNG": None,
                                      "GANSPACE_FUSED_ACTS": "1"}, seed=seed)
    assert dev["_meta"]["fused_linreg"] is ref["_meta"]["fused_linreg"] is True
    assert dev["_meta"]["device_rng"] is True
    assert host["_meta"]["fused_linreg"] is False
    ratios = _gate(f"conv1, device seed {seed}", ref, dev, host, ctrl)
    assert _passes(ratios), ratios
    assert (dev["random_stdevs"] > 0).all()


@pytest.mark.parametrize("path", ["w", "conv"])
def test_gate_rejects_a_repeated_block(w_runs, conv_runs, path, monkeypatch):
    """A planted fault: every block of the device stream is block 0 (a
    generator keyed without the block index).  The components still look
    plausible; the gate must miss its bars."""
    runs, (ref, host, ctrl) = w_runs if path == "w" else conv_runs
    block_generator = decomposition.block_generator
    monkeypatch.setattr(decomposition, "block_generator",
                        lambda seed, stream, i, device: block_generator(seed, stream, 0,
                                                                        device))
    env = {"GANSPACE_DEVICE_RNG": None}
    if path == "conv":
        env["GANSPACE_FUSED_ACTS"] = "1"
    dev = runs.port("repeated", env)
    assert dev["_meta"]["device_rng"] is True
    ratios = _gate(f"{path}, one block repeated", ref, dev, host, ctrl)
    assert not _passes(ratios), ratios


def test_fused_acts_never_runs_the_regression_sweep(tmp_path, monkeypatch, params):
    """``GANSPACE_FUSED_ACTS=1`` on a small tap: the regression rides the
    stream (``tests/test_fused_linreg.py:80-106``)."""
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setenv("GANSPACE_FUSED_ACTS", "1")
    monkeypatch.delenv("GANSPACE_DEVICE_RNG", raising=False)

    def no_sweep(*args, **kwargs):
        raise AssertionError("the separate regression sweep must not run")
    monkeypatch.setattr(decomposition, "regression", no_sweep)
    cfg = Config(model="StyleGAN2", output_class="ffhq", layer="conv1", estimator="ipca",
                 components=3, n=1024, batch_size=128, device="cpu")
    got = _load(_quiet(get_or_compute, cfg, InstrumentedModel(_port(params))))
    assert got["_meta"]["fused_linreg"] is True and got["_meta"]["device_rng"] is True
    lat = got["lat_comp"].reshape(3, -1)
    assert np.isfinite(lat).all()
    np.testing.assert_allclose(np.linalg.norm(lat, axis=-1), 1.0, atol=1e-5)
    assert (got["random_stdevs"] > 0).all()


def test_regression_sweep_on_the_device_stream(tmp_path, monkeypatch, params):
    """``GANSPACE_FUSED_LINREG=0`` on the fused activation stream: the
    separate sweep runs on the regression's device stream
    (``linreg_lstsq``'s device branch), and its ``lat_comp`` agrees with
    an exact least-squares solve over the same blocks regenerated."""
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setenv("GANSPACE_FUSED_ACTS", "1")
    monkeypatch.setenv("GANSPACE_FUSED_LINREG", "0")
    monkeypatch.delenv("GANSPACE_DEVICE_RNG", raising=False)
    model = _port(params)
    cfg = Config(model="StyleGAN2", output_class="ffhq", layer="conv1", estimator="ipca",
                 components=3, n=1024, batch_size=128, device="cpu")
    got = _load(_quiet(get_or_compute, cfg, InstrumentedModel(model)))
    assert got["_meta"]["fused_linreg"] is False and got["_meta"]["device_rng"] is True

    # linreg_lstsq's sample count: max(10000, n) in whole batches
    block = acts_stream_block(model, "conv1", 128, sampling.SEED_LINREG,
                              sampling.STREAM_LINREG)
    acts, z = (torch.cat(t).double().numpy()
               for t in zip(*(block(i) for i in range(10_000 // 128))))
    comp = got["act_comp"].reshape(3, -1).astype(np.float64)
    coords = (acts - got["act_mean"].reshape(1, -1)) @ comp.T / got["act_stdev"]
    exact, *_ = np.linalg.lstsq(coords, z, rcond=None)
    exact /= np.linalg.norm(exact, axis=-1, keepdims=True)
    cos = np.abs(np.sum(exact * got["lat_comp"].reshape(3, -1), axis=-1))
    assert cos.min() > 0.9999, cos
    np.testing.assert_allclose(got["lat_mean"].reshape(-1), z.mean(axis=0), atol=1e-5)


def test_latents_over_the_budget_wait_on_the_host(tmp_path, monkeypatch, params):
    """Above ``GANSPACE_LATENT_HBM_BUDGET`` the pre-sampled stream draws on
    the host, keeps the mapped batches off the device and says so in
    ``_meta``; its cache equals the ``GANSPACE_DEVICE_RNG=0`` run's."""
    kept = []
    prefetched = torch_sg2.StyleGAN2.sample_latents_prefetched

    def recording(self, n_batches, batch_size, keep_on=None):
        kept.append(keep_on)
        return prefetched(self, n_batches, batch_size, keep_on=keep_on)
    monkeypatch.setattr(torch_sg2.StyleGAN2, "sample_latents_prefetched", recording)
    cfg = Config(model="StyleGAN2", output_class="ffhq", layer="conv1", estimator="ipca",
                 components=3, n=1024, batch_size=128, device="cpu")
    caches = []
    for tag, env in (("budget", {"GANSPACE_LATENT_HBM_BUDGET": "0"}),
                     ("host", {"GANSPACE_DEVICE_RNG": "0"})):
        with monkeypatch.context() as mp:
            mp.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / tag))
            for k, v in env.items():
                mp.setenv(k, v)
            caches.append(_load(_quiet(get_or_compute, cfg, InstrumentedModel(_port(params)))))
    assert kept == ["cpu", None]
    budget, host = caches
    assert budget["_meta"] == host["_meta"] and budget["_meta"]["device_rng"] is False
    for k in ("act_comp", "act_mean", "act_stdev", "lat_comp", "var_ratio"):
        np.testing.assert_array_equal(budget[k], host[k], err_msg=k)


def test_provenance_warning_on_the_other_stream(tmp_path, monkeypatch, params):
    """A device-RNG cache read under ``GANSPACE_DEVICE_RNG=0`` warns
    (``tests/test_decomposition.py:141-162``); under the default it does not."""
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.delenv("GANSPACE_DEVICE_RNG", raising=False)
    cfg = Config(device="cpu", **dict(W_KW, components=4, n=512))
    path = _quiet(get_or_compute, cfg, InstrumentedModel(_port(params)))
    assert _load(path)["_meta"]["device_rng"] is True
    for env, warns in (("1", False), ("0", True)):
        monkeypatch.setenv("GANSPACE_DEVICE_RNG", env)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _warn_on_provenance_mismatch(path)
        assert ("WARNING" in buf.getvalue()) is warns


def test_visualize_draws_the_cache_streams_directions(tmp_path, monkeypatch, params):
    """The baseline grid's random directions come from the stream the cache
    records (``ganspace_tpu/apps/visualize.py:202-217``)."""
    assert visualize.baseline_directions({"device_rng": False}, "cpu") \
        is sampling.random_directions
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    assert visualize.baseline_directions(None, "cpu") is sampling.random_directions
    torch.testing.assert_close(visualize.baseline_directions({"device_rng": True}, "cpu")(3, 7),
                               sampling.random_directions_device(3, 7, "cpu"))

    monkeypatch.delenv("GANSPACE_DEVICE_RNG")
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyStyleGAN2", lambda oc, device, **kw: _port(params))
    drawn = []

    def recording(c, d, device):
        drawn.append((c, d))
        return sampling.random_directions_device(c, d, device)
    monkeypatch.setattr(visualize, "random_directions_device", recording)
    result = _quiet(visualize.main, ["--model", "TinyStyleGAN2", "--class", "ffhq",
                                     "--use_w", "--layer", "style", "--est", "ipca",
                                     "-c", "2", "-n", "1024", "--device", "cpu"])
    assert visualize.load_components(result.cache).meta["device_rng"] is True
    assert drawn == [(2, 512), (2, 512)]          # the activation and latent grids
