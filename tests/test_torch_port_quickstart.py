"""The port's ``examples/quickstart.py`` against the JAX package's, on the
CPU and the host RNG stream (``GANSPACE_DEVICE_RNG=0``), with the fixtures
and helpers of ``test_torch_port_examples.py``.

Bars: strip frames within one uint8 level; the direction's fields equal on
one cache (else its vectors at |cos| > 0.99 and its stdevs to 1e-3); the
dissection's IoUs within 1e-3 and its threshold levels within 1e-4
relative; on separate fits the ROADMAP's cache bars.
"""

import functools
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image
import torch

import jax
import jax.numpy as jnp

from ganspace_tpu import decomposition as jax_decomposition
from ganspace_tpu.models import dcgan as jax_dcgan

from ganspace_tpu_torch import decomposition as port_decomposition
from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.examples import quickstart
from ganspace_tpu_torch.models import dcgan as port_dcgan

from test_torch_port_examples import (  # noqa: F401 (autouse fixtures)
    REL, _assert_same_cache, _few_threads, _host_rng_one_device, _jax_example)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_same_outputs(port_dir: Path, jax_dir: Path, same_npz: bool = True):
    """Steps 3-5 of the quickstart: the strip frames, the direction's
    fields, the dissection's top units, IoUs and levels.  The direction's
    vectors and stdevs are equal when both ran on one cache, else held to
    the components' bars (|cos| > 0.99, the stdevs to 1e-3 relative)."""
    strips = sorted(p.relative_to(jax_dir) for p in (jax_dir / "strips").rglob("*.png"))
    assert strips and strips == sorted(p.relative_to(port_dir)
                                       for p in (port_dir / "strips").rglob("*.png"))
    for rel in strips:
        a = np.asarray(Image.open(port_dir / rel), np.int16)
        b = np.asarray(Image.open(jax_dir / rel), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel

    (pkl,) = (jax_dir / "directions").glob("*.pkl")
    got = pickle.loads((port_dir / "directions" / pkl.name).read_bytes())
    ref = pickle.loads(pkl.read_bytes())
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if same_npz and isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        elif isinstance(v, np.ndarray):
            a, b = got[k].ravel(), v.ravel()
            assert abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99, k
        elif k in ("act_stdev", "lat_stdev") and not same_npz:
            np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)
        else:
            assert got[k] == v, k

    got = json.loads((port_dir / "dissect" / "dissect.json").read_text())
    ref = json.loads((jax_dir / "dissect" / "dissect.json").read_text())
    assert {k: got[k] for k in ref if k != "units"} == {k: ref[k] for k in ref if k != "units"}
    by_unit = {u["unit"]: u for u in got["units"]}
    assert by_unit.keys() == {u["unit"] for u in ref["units"]}
    for u in ref["units"]:
        g = by_unit[u["unit"]]
        assert abs(g["iou"] - u["iou"]) <= 1e-3
        assert abs(g["activation_level"] - u["activation_level"]) <= REL * max(
            abs(u["activation_level"]), 1.0)
    ious = [u["iou"] for u in ref["units"][:9]]
    clear = [i for i in range(8) if ious[i] - ious[i + 1] > 1e-3 and (
        i == 0 or ious[i - 1] - ious[i] > 1e-3)]
    assert [got["units"][i]["unit"] for i in clear] == [ref["units"][i]["unit"] for i in clear]
    for d in (port_dir, jax_dir):
        assert (d / "dissect" / "dissect.html").is_file()
        assert len(list((d / "dissect" / "image").glob("unit_*.png"))) == 8


def test_quickstart_tiny_matches_jax_steps(tmp_path, monkeypatch):
    """The port's ``--tiny`` run end to end, then steps 3-5 of both scripts
    on its cache (a cache hit: the JAX fit is skipped), on a 16-px DCGAN
    of 64 base channels in both packages (the full-width one runs in the
    ``slow`` test and on the card)."""
    for mod in (jax_dcgan, port_dcgan):
        monkeypatch.setattr(mod, "DCGANConfig", functools.partial(
            mod.DCGANConfig, resolution=16, base_channels=64))
    first = tmp_path / "port_fit"
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(first))
    assert quickstart.main(["--tiny", "--device", "cpu", "--outdir", str(first)]) == 0
    (npz,) = (first / "cache" / "components").glob("*.npz")
    assert npz.name == "dcgan-None_deconv1_ipca_c4_n128.npz"
    data = npz.read_bytes()
    jax_qs = _jax_example("quickstart")
    for name, main, extra in (("port", quickstart.main, ["--device", "cpu"]),
                              ("jax", jax_qs.main, [])):
        out = tmp_path / name
        (out / "cache" / "components").mkdir(parents=True)
        shutil.copy(npz, out / "cache" / "components" / npz.name)
        monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(out))
        assert main(["--tiny", "--outdir", str(out), *extra]) == 0
        assert (out / "cache" / "components" / npz.name).read_bytes() == data
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")


@pytest.mark.slow
def test_quickstart_whole_script_matches_jax(tmp_path, monkeypatch):
    """Both scripts end to end at ``--tiny``, the JAX fit included.  The
    sketch tier's test matrix is JAX's in both, and the regression sweep's
    batch is the same: the port sizes it from the tap (1024 at DCGAN's
    ``deconv1``), the JAX package on the CPU from XLA's memory analysis."""
    monkeypatch.setattr(ipca, "sketch_test_matrix", lambda d, l: np.array(
        jax.random.normal(jax.random.PRNGKey(0xA5), (d, l), jnp.float32)))
    for mod in (jax_decomposition, port_decomposition):
        monkeypatch.setattr(mod, "get_max_batch_size", lambda inst, layer_name=None: 1024)
    jax_qs = _jax_example("quickstart")
    for name, main, extra in (("port", quickstart.main, ["--device", "cpu"]),
                              ("jax", jax_qs.main, [])):
        monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / name))
        assert main(["--tiny", "--outdir", str(tmp_path / name), *extra]) == 0
    (got,) = (tmp_path / "port" / "cache" / "components").glob("*.npz")
    (ref,) = (tmp_path / "jax" / "cache" / "components").glob("*.npz")
    _assert_same_cache(got, ref, 4)
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax", same_npz=False)


