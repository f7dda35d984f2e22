"""The port's three BigGAN figure scripts and its PCA illustration against
the JAX package's.

The BigGAN scripts run as ``tests/test_torch_port_figures.py`` runs the
StyleGAN2 ones: the JAX scripts once for the module on the reduced
BigGAN (``--tiny``, one gen_z fit, host RNG, one device), then the port's on the same
component cache, each PNG held to JAX's shape and to ``MAX_LEVELS`` /
``MEAN_LEVELS`` uint8 levels.  The PCA illustration runs no generator: its
principal axes from the port's PCA estimator are held to the JAX
estimator's on the same point cloud (|cos| of each axis to 1e-6, the
standard deviations to 1e-5 relative), and its PNG to JAX's.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_figures import ARGS, jax_scripts, levels

FIGURES = {
    "figure_biggan_style_resampling": "biggan_style_resampling.png",
    "figure_biggan_style_mixing": "biggan_style_mixing.png",
    "figure_biggan_edit_transferability": "biggan_edit_transferability.png",
}
#: uint8 levels: neighbouring levels from the two float32 forwards only
MAX_LEVELS, MEAN_LEVELS = 1, 0.01


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_figures(tmp_path_factory):
    root = tmp_path_factory.mktemp("figures_biggan")
    with jax_scripts() as mp:
        mp.setenv("GANSPACE_OUTPUT_DIR", str(root))
        mp.setenv("GANSPACE_DEVICE_RNG", "0")
        for name in FIGURES:
            importlib.import_module(name).main(ARGS + ["--outdir", str(root / "jax")])
        yield root


@pytest.mark.parametrize("name", list(FIGURES))
def test_biggan_figure_matches_jax(jax_figures, name):
    mod = importlib.import_module(f"ganspace_tpu_torch.notebooks.{name}")
    out = mod.main(ARGS + ["--device", "cpu", "--outdir", str(jax_figures / "port")])
    assert Path(out) == jax_figures / "port" / FIGURES[name]
    same_shape, mean, worst = levels(out, jax_figures / "jax" / FIGURES[name])
    assert same_shape
    assert worst <= MAX_LEVELS and mean <= MEAN_LEVELS, (mean, worst)


def test_pca_illustration_matches_jax(tmp_path):
    from ganspace_tpu.estimators import get_estimator

    from ganspace_tpu_torch.notebooks import figure_pca_illustration as fig

    pts = fig.point_cloud(0)
    comp, stdev = fig.principal_axes(pts, "cpu")
    est = get_estimator("pca", 2)
    est.fit(pts.astype(np.float32))
    ref_comp, ref_stdev, _ = (np.asarray(a) for a in est.get_components())
    cos = np.abs(np.sum(comp * ref_comp, axis=1))
    np.testing.assert_allclose(cos, 1.0, atol=1e-6)
    np.testing.assert_allclose(stdev, ref_stdev, rtol=1e-5)

    with jax_scripts():
        ref = importlib.import_module("figure_pca_illustration").main(
            ["--outdir", str(tmp_path / "jax")])
    got = fig.main(["--device", "cpu", "--outdir", str(tmp_path / "port")])
    same_shape, mean, worst = levels(got, ref)
    assert same_shape and worst <= MAX_LEVELS and mean <= MEAN_LEVELS, (mean, worst)
