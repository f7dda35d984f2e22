"""The port's six StyleGAN2 figure scripts against the JAX package's.

Both packages build the same reduced StyleGAN2 (``--tiny``: the same
config, bit-identical seeded weights).  The JAX scripts run once for the
module, fitting one component cache (host RNG, one device, ``-n 128 -c 6``); the port's
scripts then render on that same cache (a cache hit in the same
``GANSPACE_OUTPUT_DIR``), so any difference in a PNG is the two forwards'
float32 rounding: each PNG must have JAX's shape and differ from it by at
most ``MAX_LEVELS`` uint8 levels anywhere and ``MEAN_LEVELS`` on average.
The port's own fit of the figures' cache is held to JAX's at min |cos| >
0.99 (the ROADMAP's bar), with identical npz keys.
"""

import contextlib
import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

NB = Path(__file__).resolve().parent.parent / "notebooks"
ARGS = ["--tiny", "--n", "128", "-c", "6"]
#: figure module -> the PNGs its main writes
FIGURES = {
    "figure_teaser": ["teaser.png"],
    "figure_pca_cleanup": ["pca_cleanup_global.png", "pca_cleanup_tuned.png"],
    "figure_style_content_sep": ["style_content_sep.png", "random_baseline.png"],
    "figure_supervised_comp": ["supervised_comp.png"],
    "figure_first_20_pcs": ["first_20_pcs.png"],
    "figure_edit_zoo": ["edit_zoo.png"],
}
#: uint8 levels: the two float32 forwards may round a pixel to neighbouring
#: levels, and nothing more
MAX_LEVELS, MEAN_LEVELS = 1, 0.01
COS_BAR = 0.99


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def jax_scripts():
    """The JAX figure scripts importable by name (``notebooks/`` on the
    path), their fits on one device (``mesh_shape="1"``, as the other
    parity tests pin it, not the tests' 8-device CPU mesh); on exit the
    path and the modules imported here are dropped, so a later importer
    (``tests/test_notebooks.py``) gets its own ``notebook_init.OUTDIR``."""
    before = set(sys.modules)
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(NB))
        import notebook_init

        from ganspace_tpu.config import Config
        mp.setattr(notebook_init, "Config", functools.partial(Config, mesh_shape="1"))
        try:
            yield mp
        finally:
            for name in set(sys.modules) - before:
                if name == "notebook_init" or name.startswith("figure_"):
                    del sys.modules[name]


@pytest.fixture(scope="module")
def jax_figures(tmp_path_factory):
    """The JAX figures of every script in one output directory (one fit),
    which stays the module's ``GANSPACE_OUTPUT_DIR``; host RNG throughout."""
    root = tmp_path_factory.mktemp("figures")
    with jax_scripts() as mp:
        mp.setenv("GANSPACE_OUTPUT_DIR", str(root))
        mp.setenv("GANSPACE_DEVICE_RNG", "0")
        for name in FIGURES:
            importlib.import_module(name).main(ARGS + ["--outdir", str(root / "jax")])
        yield root


def levels(a: Path, b: Path):
    """(shape equal, mean |d|, max |d|) of two PNGs in uint8 levels."""
    x = np.asarray(Image.open(a), dtype=np.int16)
    y = np.asarray(Image.open(b), dtype=np.int16)
    if x.shape != y.shape:
        return False, np.inf, np.inf
    d = np.abs(x - y)
    return True, float(d.mean()), int(d.max())


@pytest.mark.parametrize("name", list(FIGURES))
def test_figure_matches_jax(jax_figures, name):
    mod = importlib.import_module(f"ganspace_tpu_torch.notebooks.{name}")
    out = mod.main(ARGS + ["--device", "cpu", "--outdir", str(jax_figures / "port")])
    assert Path(out) == jax_figures / "port" / FIGURES[name][-1]
    for png in FIGURES[name]:
        same_shape, mean, worst = levels(jax_figures / "port" / png,
                                         jax_figures / "jax" / png)
        assert same_shape, png
        assert worst <= MAX_LEVELS and mean <= MEAN_LEVELS, (png, mean, worst)


def test_port_fit_matches_jax(jax_figures, tmp_path, monkeypatch):
    """The port fits the figures' cache itself: the same file name and
    keys as JAX's, its components within the ROADMAP's |cos| bar."""
    from ganspace_tpu_torch.notebooks.notebook_init import parse_args, setup
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    ns = setup(parse_args(ARGS + ["--device", "cpu", "--outdir", str(tmp_path)],
                          components=8))
    (ref_path,) = (jax_figures / "cache" / "components").glob("*.npz")
    (got_path,) = (tmp_path / "cache" / "components").glob("*.npz")
    assert got_path.name == ref_path.name
    with np.load(ref_path) as ref, np.load(got_path) as got:
        assert sorted(got.files) == sorted(ref.files)
        for key in ("lat_comp", "act_comp"):
            a, b = got[key].reshape(6, -1), ref[key].reshape(6, -1)
            cos = np.abs(np.sum(a * b, axis=1)) / (
                np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
            assert cos.min() > COS_BAR, (key, cos)
        np.testing.assert_allclose(got["lat_stdev"], ref["lat_stdev"], rtol=1e-4)
    assert ns.comps.lat_comp.dtype == np.float32
    assert isinstance(ns.comps.lat_comp, np.ndarray)


@pytest.mark.parametrize("model", ["StyleGAN2", "StyleGAN", "BigGAN-128", "ProGAN", "DCGAN"])
def test_tiny_overrides_match_jax(model):
    """``--tiny`` builds the JAX package's reduced configs, field for field."""
    import dataclasses

    from ganspace_tpu_torch.notebooks.notebook_init import tiny_overrides
    with jax_scripts():
        import notebook_init
        got, ref = tiny_overrides(model)["cfg"], notebook_init.tiny_overrides(model)["cfg"]
    assert type(got).__name__ == type(ref).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
