"""The port's ``examples/custom_model.py`` and W-fit profiler against the
JAX package's, on the CPU and the host RNG stream (``GANSPACE_DEVICE_RNG=0``),
so both see the same latents (the quickstart's tests are in
``test_torch_port_quickstart.py``).

Bars: the ROADMAP's (activations < 1e-4 relative; components min
per-component |cos| > 0.99; cache names, npz keys and ``_meta`` identical).
"""

import functools
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganspace_tpu import config as jax_config

from ganspace_tpu_torch.examples import custom_model
from ganspace_tpu_torch.models.base import InstrumentedModel, TapState
from ganspace_tpu_torch.ops.precision import ieee_f32
from ganspace_tpu_torch.sampling import gaussian_latents
from ganspace_tpu_torch.tools import profile_wpca

REPO = Path(__file__).resolve().parent.parent
REL = 1e-4
TAPS = ("fc1", "fc2", "output")


def _jax_example(name):
    """``examples/<name>.py`` of the JAX package, loaded by path (its
    dataclasses resolve through ``sys.modules``)."""
    modname = f"jax_example_{name}"
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(modname, REPO / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    return sys.modules[modname]


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the tests run in several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _host_rng_one_device(monkeypatch):
    """The host RNG stream, and the JAX scripts' configs on one device
    (``--mesh 1``): the tests' JAX runs see 8 host devices, the port one."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")

    class OneDevice(jax_config.Config):
        def __init__(self, **kwargs):
            kwargs.setdefault("mesh_shape", "1")
            super().__init__(**kwargs)
    monkeypatch.setattr(jax_config, "Config", OneDevice)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _load(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _assert_same_cache(port_path: Path, jax_path: Path, c: int):
    """Same name, keys and ``_meta``; components within |cos| 0.99."""
    assert port_path.name == jax_path.name
    got, ref = _load(port_path), _load(jax_path)
    assert set(got) == set(ref)
    meta, meta_ref = (json.loads(d["_meta"].item()) for d in (got, ref))
    assert meta.keys() == meta_ref.keys()
    assert {k: v for k, v in meta.items() if k != "refine_stats"} == \
        {k: v for k, v in meta_ref.items() if k != "refine_stats"}
    # the sketch's convergence statistics to the bars of
    # test_torch_port_dcgan.py (the tail share 1e-3 relative, the smallest
    # relative eigengap 2e-3 absolute)
    stats, stats_ref = meta["refine_stats"], meta_ref["refine_stats"]
    assert (stats is None) == (stats_ref is None)
    if stats_ref is not None:
        assert stats.keys() == stats_ref.keys()
        np.testing.assert_allclose(stats["sketch_tail_frac"], stats_ref["sketch_tail_frac"],
                                   rtol=1e-3)
        np.testing.assert_allclose(stats["min_rel_gap_topc"], stats_ref["min_rel_gap_topc"],
                                   atol=2e-3)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    cos = np.abs(np.sum(got["act_comp"].reshape(c, -1) * ref["act_comp"].reshape(c, -1), -1))
    assert cos.min() > 0.99, cos


# -- custom_model -----------------------------------------------------------

@pytest.mark.parametrize("cfg,seed", [({}, 0), ({}, 3), ({"z_dim": 16, "width": 32,
                                                          "resolution": 8}, 1)])
def test_custom_model_init_params_match_jax(cfg, seed):
    jax_cm = _jax_example("custom_model")
    got = custom_model.init_params(custom_model.ToyConfig(**cfg), seed)
    ref = jax_cm.init_params(jax_cm.ToyConfig(**cfg), seed)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_custom_model_forward_and_taps_match_jax():
    jax_cm = _jax_example("custom_model")
    cfg = jax_cm.ToyConfig()
    params = {k: jnp.asarray(v) for k, v in jax_cm.init_params(cfg, 0).items()}
    z = gaussian_latents(6, cfg.z_dim, 7)
    ref_img, ref_taps = jax_cm.synthesize(params, jnp.asarray(z), {}, cfg=cfg, retain=TAPS,
                                          stop_at=None)
    port = custom_model.ToyGenerator(device="cpu")
    ts = TapState(TAPS, None, None)
    with ieee_f32():
        img = port.synthesize(torch.from_numpy(z), ts)
    assert _rel(img, ref_img) < REL
    for tap in TAPS:
        assert ts.retained[tap].shape == ref_taps[tap].shape
        assert _rel(ts.retained[tap], ref_taps[tap]) < REL, tap
    assert _rel(port.forward(torch.from_numpy(z)), 0.5 * (np.asarray(ref_img) + 1)) < REL
    # partial_forward stops at the tap and retains it
    inst = InstrumentedModel(port)
    inst.retain_layer("fc2")
    assert port.partial_forward(torch.from_numpy(z), "fc2") is None
    assert _rel(inst.retained_layer("fc2"), ref_taps["fc2"]) < REL


def test_custom_model_main_matches_jax(tmp_path, monkeypatch):
    """Both scripts' ``main`` on a narrower ToyGAN (width 64, 16 px: fc2 is
    D = 1024; the default's D = 4096 runs on the card)."""
    jax_cm = _jax_example("custom_model")
    for mod in (jax_cm, custom_model):
        monkeypatch.setattr(mod, "ToyConfig", functools.partial(
            mod.ToyConfig, width=64, resolution=16))
    args = ["--n", "256", "-c", "3"]
    out = {}
    for name, main, extra in (("jax", jax_cm.main, []),
                              ("port", custom_model.main, ["--device", "cpu"])):
        out[name] = tmp_path / name
        monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(out[name]))
        assert main([*args, "--outdir", str(out[name]), *extra]) == 0
        assert (out[name] / "toygan_component0_strip.png").is_file()
    (got,) = (out["port"] / "cache" / "components").glob("*.npz")
    (ref,) = (out["jax"] / "cache" / "components").glob("*.npz")
    assert got.name == "toygan-None_fc2_ipca_c3_n256.npz"
    _assert_same_cache(got, ref, 3)


# -- profilers ------------------------------------------------------------------

def test_profile_wpca_prints_stamps_and_phase_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "1")      # the fused W stream
    monkeypatch.setenv("REPS", "1")
    monkeypatch.setenv("TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.delenv("GANSPACE_PHASE_TRACE", raising=False)
    assert profile_wpca.main(["4096", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "warm run:" in out and "=== rep 0: total" in out
    for label in ("fit_stream:enter[1blk]", "fit_stream:dispatched", "fit:device_drained",
                  "finish_bundle:done", "end", "npz size:"):
        assert f"  {label}" in out, label
    assert "traced rep: wall" in out and "top 12 host ops by self CPU time:" in out
    assert err.count("post-fit phase trace:") == 2       # the warm run and the rep
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert "GANSPACE_PHASE_TRACE" not in os.environ      # restored
