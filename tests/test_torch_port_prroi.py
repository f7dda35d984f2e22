"""The port's PrRoI pooling (``ganspace_tpu_torch/ops/prroi.py``) against the
JAX package's on the same numpy inputs: values, and gradients with respect
to the features and the RoI coordinates (autograd against ``jax.grad``),
including degenerate RoIs, to 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganspace_tpu.ops.prroi import prroi_pool2d as jax_prroi

from ganspace_tpu_torch.ops.prroi import prroi_pool2d


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


REL = 1e-5

ROIS = np.array([[0, 1.3, 0.7, 6.2, 5.9],      # interior
                 [1, 0.0, 0.0, 16.0, 16.0],    # the whole map at scale 0.5
                 [0, 2.0, 2.0, 2.0, 3.0],      # zero width: pools to 0
                 [1, -1.5, 3.2, 9.5, 8.8],     # past the edges
                 [0, 5.0, 5.0, 5.0, 5.0]],     # a point
                np.float32)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(2, 3, 8, 8).astype(np.float32), ROIS.copy()


def _rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("pooled,scale", [((3, 3), 1.0), ((2, 4), 0.5), ((6, 6), 1.0)])
def test_values_match_jax(pooled, scale):
    feat, rois = _inputs()
    got = prroi_pool2d(torch.from_numpy(feat), torch.from_numpy(rois), *pooled,
                       spatial_scale=scale).numpy()
    ref = np.asarray(jax_prroi(jnp.asarray(feat), jnp.asarray(rois), *pooled,
                               spatial_scale=scale))
    assert got.shape == ref.shape == (len(rois), 3, *pooled)
    assert _rel(got, ref) <= REL
    assert np.all(got[2] == 0) and np.all(ref[2] == 0)


def test_gradients_match_jax():
    """d/d features and d/d RoI coordinates of a weighted sum of the pooled
    values, every RoI at once (the degenerate ones have zero gradients)."""
    feat, rois = _inputs(1)
    wts = np.random.RandomState(2).randn(len(rois), 3, 3, 3).astype(np.float32)

    def jloss(f, r):
        return jnp.sum(jax_prroi(f, r, 3, 3) * wts)

    gf_ref, gr_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(rois))
    f = torch.from_numpy(feat).requires_grad_(True)
    r = torch.from_numpy(rois).requires_grad_(True)
    torch.sum(prroi_pool2d(f, r, 3, 3) * torch.from_numpy(wts)).backward()
    assert _rel(f.grad.numpy(), np.asarray(gf_ref)) <= REL
    gr, gr_ref = r.grad.numpy(), np.asarray(gr_ref)
    assert _rel(gr[:, 1:], gr_ref[:, 1:]) <= REL
    assert np.all(gr[2:5:2, 1:] == gr_ref[2:5:2, 1:])


def test_whole_image_pool_matches_jax_at_ppm_scales():
    """The UPerNet PPM's call: the whole-image RoI of each sample at the
    pyramid scales, on a feature map wider than tall."""
    feat = np.random.RandomState(3).randn(2, 4, 5, 7).astype(np.float32)
    rois = np.array([[0, 0, 0, 7, 5], [1, 0, 0, 7, 5]], np.float32)
    for s in (1, 2, 3, 6):
        got = prroi_pool2d(torch.from_numpy(feat), torch.from_numpy(rois), s, s).numpy()
        ref = np.asarray(jax_prroi(jnp.asarray(feat), jnp.asarray(rois), s, s))
        assert _rel(got, ref) <= REL, s
