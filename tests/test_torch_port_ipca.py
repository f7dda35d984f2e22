"""The port's IPCA exact-moments tier against the JAX package's, on one stream."""

import numpy as np
import pytest
import torch

from ganspace_tpu.estimators.ipca import IPCAEstimator as JaxIPCA

from ganspace_tpu_torch.estimators import get_estimator
from ganspace_tpu_torch.estimators.ipca import IPCAEstimator, proj_variance
from ganspace_tpu_torch.estimators.utils import svd_flip_vt


def _stream(n_blocks=4, n=600, d=48, seed=0):
    """Anisotropic blocks with a nonzero mean, so centering and the Chan
    merge both matter."""
    rs = np.random.RandomState(seed)
    scales = np.linspace(3.0, 0.1, d).astype(np.float32)
    return [(rs.randn(n, d).astype(np.float32) * scales + 2.0) for _ in range(n_blocks)]


@pytest.mark.parametrize("c", [5, 12])
def test_moments_tier_matches_jax(c):
    blocks = _stream()
    ref, got = JaxIPCA(c, mode="moments"), IPCAEstimator(c)
    for b in blocks:
        assert ref.fit_partial(b) and got.fit_partial(torch.from_numpy(b))
    assert got.n_samples_seen_ == ref.n_samples_seen_ == 2400
    np.testing.assert_allclose(got.mean_, ref.mean_, rtol=1e-5, atol=1e-5)
    rc, rs, rv = ref.get_components()
    gc, gs, gv = got.get_components()
    assert np.abs(np.sum(rc * gc, axis=1)).min() > 0.999
    assert np.allclose(gc, rc, atol=1e-3)            # same signs (svd_flip_vt)
    np.testing.assert_allclose(gs, rs, rtol=1e-4)
    np.testing.assert_allclose(gv, rv, rtol=1e-4)

    rcomp, rstats = ref.finish_latent_bundle()
    gcomp, gstats = got.finish_latent_bundle()
    assert gstats.shape == rstats.shape == (4, c)     # no rand moments: zeros
    np.testing.assert_allclose(gstats, rstats, rtol=1e-4)
    dirs = np.random.RandomState(1).randn(3, 48).astype(np.float32)
    np.testing.assert_allclose(proj_variance(got._moments, torch.from_numpy(dirs)),
                               ref.projected_variance(dirs), rtol=1e-4)
    assert got.get_param_str() == ref.get_param_str() == f"ipca_c{c}"


def test_moments_tier_equals_one_shot_covariance():
    x = np.concatenate(_stream(seed=2)).astype(np.float64)
    est = IPCAEstimator(4)
    for b in np.split(x.astype(np.float32), 4):
        est.fit_partial(b)
    cov = np.cov(x, rowvar=False)
    evals, evecs = np.linalg.eigh(cov)
    comp, stdev, _ = est.get_components()
    np.testing.assert_allclose(stdev, np.sqrt(evals[::-1][:4]), rtol=1e-4)
    assert np.abs(np.sum(comp * evecs[:, ::-1][:, :4].T, axis=1)).min() > 0.9999


def test_refusals():
    est = IPCAEstimator(4)
    assert est.fit_partial(np.zeros((3, 8), np.float32)) is False   # n < c
    with pytest.raises(RuntimeError):
        est.get_components()
    bad = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    bad[3, 2] = np.nan
    est.fit_partial(bad)
    with pytest.raises(FloatingPointError):
        est.finish_latent_bundle()
    # past MOMENTS_MAX_D the sketch tier takes the stream (no refusal)
    big = IPCAEstimator(4)
    assert big.fit_partial(np.zeros((8, 8193), np.float32))
    assert big._moments is None and big._nystrom is not None
    with pytest.raises(NotImplementedError):
        get_estimator("pca", 4)


def test_svd_flip_makes_largest_coordinate_positive():
    vt = torch.tensor([[0.1, -0.9, 0.2], [0.5, 0.1, -0.3]])
    out = svd_flip_vt(vt)
    assert torch.equal(out, torch.tensor([[-0.1, 0.9, -0.2], [0.5, 0.1, -0.3]]))
