"""The port's running statistics against the JAX package's on the same
numpy streams.

With the JAX sketch's coin flips handed to the port (``flip_source``), the
quantile sketch's ``levels`` and ``fills`` are equal bit for bit across
flushes, partial chunks and the top level's decay, and so are ``quantiles``
and ``normalize``; feeding a batch in column slabs changes nothing.  The
top-k, the conditional sketches, the cross-covariance (1e-5 relative) and
the variance match; state dicts carry the same keys and load across
packages.  The port's own flips come from a CPU generator and are
reproducible."""

import numpy as np
import pytest
import torch

from ganspace_tpu.stats import running as jax_running

from ganspace_tpu_torch.stats import running
from ganspace_tpu_torch.stats import (
    RunningConditionalQuantile, RunningCrossCovariance, RunningQuantile,
    RunningTopK, RunningVariance,
)

from test_torch_port_jax_rng import jax_flip_source

QS = np.linspace(0.0, 1.0, 21)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_flips(monkeypatch):
    monkeypatch.setattr(running, "flip_source", jax_flip_source)


def _stream(seed, n_batches, units, rows):
    """Batches of ``rows`` rows in turn (few distinct flush widths, so the
    JAX package compiles its insert a few times only)."""
    rs = np.random.RandomState(seed)
    return [(rs.randn(rows[i % len(rows)], units) * (1 + np.arange(units))
             ).astype(np.float32) for i in range(n_batches)]


def _assert_same_sketch(port, ref):
    got, want = port.state_dict(), ref.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    levels = ref.quantiles(QS)
    assert np.array_equal(port.quantiles(QS), levels)
    assert np.array_equal(port.normalize(levels), ref.normalize(levels))


# (samplesize, depth, flush_blocks, seed, batches, rows in turn): several
# flushes with partial chunks; the last three overflow the top level (its
# capacity samplesize * (2^depth - 1)), which then compacts in place
SKETCHES = [(16, 4, 2, 0, 12, (13, 29)), (32, 6, 1, 3, 24, (100,)),
            (8, 3, 4, 7, 30, (21, 40)), (16, 5, 2, 1, 12, (150,))]


@pytest.mark.parametrize("samplesize,depth,flush_blocks,seed,batches,rows", SKETCHES)
def test_quantile_sketch_bit_identical_with_jax_flips(jax_flips, samplesize, depth,
                                                      flush_blocks, seed, batches, rows):
    ref = jax_running.RunningQuantile(samplesize, depth, seed=seed, flush_blocks=flush_blocks)
    port = RunningQuantile(samplesize, depth, seed=seed, flush_blocks=flush_blocks)
    for x in _stream(seed, batches, 3, rows):
        ref.add(x)
        port.add(x)
    assert port.count == ref.count
    if samplesize * (2 ** depth - 1) < ref.count:
        assert int(np.asarray(ref._fills)[-1]) > 0           # the top level decayed
    _assert_same_sketch(port, ref)


def test_quantile_sketch_slabbed_columns_equal_whole_batches(jax_flips):
    """``add_columns`` of a batch in uneven slabs flushes exactly as ``add``
    of the whole batch (the JAX package's one flush per batch)."""
    ref = jax_running.RunningQuantile(16, 5, flush_blocks=2)
    port = RunningQuantile(16, 5, flush_blocks=2)
    rs = np.random.RandomState(5)
    for x in _stream(5, 10, 4, (45, 70)):
        ref.add(x)
        cols = torch.from_numpy(x.T.copy())
        cuts = np.sort(rs.randint(0, cols.shape[1] + 1, size=3))
        bounds = [0, *cuts, cols.shape[1]]
        port.add_columns([cols[:, a:b] for a, b in zip(bounds[:-1], bounds[1:]) if b > a],
                         cols.shape[1])
    _assert_same_sketch(port, ref)


def test_quantile_sketch_merges_only_where_work_is_done():
    """A full level-0 chunk on an empty sketch is placed with no merge; the
    number of merges stays near one per chunk (not ``depth``)."""
    port = RunningQuantile(64, 12, flush_blocks=1)
    port.add(np.random.RandomState(0).randn(64, 5).astype(np.float32))
    assert port.merges == 0 and list(port._fills[:2]) == [64, 0]
    port.add(np.random.RandomState(1).randn(64 * 256, 5).astype(np.float32))
    assert 200 <= port.merges <= 2 * 257


def test_quantile_state_dicts_load_across_packages(jax_flips):
    ref = jax_running.RunningQuantile(16, 4, flush_blocks=2)
    port = RunningQuantile(16, 4, flush_blocks=2)
    for x in _stream(2, 8, 3, (13, 29)):
        ref.add(x)
        port.add(x)
    loaded = RunningQuantile(flush_blocks=2).set_state_dict(ref.state_dict())
    _assert_same_sketch(loaded, ref)
    back = jax_running.RunningQuantile(flush_blocks=2).set_state_dict(port.state_dict())
    _assert_same_sketch(port, back)
    # a loaded sketch goes on as the JAX package's does (both with the
    # flips of a fresh seed-0 sketch, the key not being part of the state,
    # and the flush width of the constructor: 2 x 1024 columns)
    for x in _stream(9, 6, 3, (13, 29)):
        back.add(x)
        loaded.add(x)
    _assert_same_sketch(loaded, back)


def test_default_flips_are_seeded_cpu_draws():
    a, b = running.flip_source(0), running.flip_source(0)
    fa, fb = a(500, 12), b(500, 12)
    assert fa.dtype == bool and fa.shape == (500, 12) and np.array_equal(fa, fb)
    assert 0.45 < fa.mean() < 0.55
    assert not np.array_equal(running.flip_source(1)(500, 12), fa)
    assert not np.array_equal(a(500, 12), fa)                # the next flush's


def test_quantile_accuracy_against_numpy():
    data = (np.random.RandomState(1).randn(20_000, 4) * np.arange(1, 5)).astype(np.float32)
    port = RunningQuantile(samplesize=512)
    for i in range(0, data.shape[0], 3000):
        port.add(data[i:i + 3000])
    qs = np.array([0.01, 0.25, 0.5, 0.75, 0.99])
    err = np.abs(port.quantiles(qs) - np.quantile(data, qs, axis=0).T) / np.arange(1, 5)[:, None]
    assert err.max() < 0.15
    small = RunningQuantile()
    small.add(np.arange(10, dtype=np.float32).reshape(10, 1))
    assert np.allclose(small.normalize(np.array([[-1.0, 4.0, 9.0, 100.0]])),
                       [[0.0, 0.5, 1.0, 1.0]])


def test_topk_matches_jax():
    data = np.random.RandomState(0).randn(3000, 16).astype(np.float32)
    ref, port = jax_running.RunningTopK(k=10), RunningTopK(k=10)
    for i in range(0, 3000, 700):
        ref.add(data[i:i + 700])
        port.add(data[i:i + 700])
    assert np.array_equal(port.result(), ref.result())
    assert port.count == ref.count == 3000
    got, want = port.state_dict(), ref.state_dict()
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert np.array_equal(RunningTopK().set_state_dict(want).result(), ref.result())


def test_conditional_quantile_matches_jax(jax_flips):
    rs = np.random.RandomState(2)
    ref = jax_running.RunningConditionalQuantile(samplesize=8, depth=3)
    port = RunningConditionalQuantile(samplesize=8, depth=3)
    for i in range(30):
        cond = int(rs.randint(3))
        x = (cond + rs.randn(33, 4)).astype(np.float32)
        ref.add(cond, x)
        port.add(cond, x)
    assert set(port.keys()) == set(ref.keys())
    for c in ref.keys():
        _assert_same_sketch(port.conditional(c), ref.conditional(c))
    loaded = RunningConditionalQuantile(8, 3).set_state_dict(ref.state_dict())
    assert set(loaded.keys()) == set(ref.keys())          # int keys restored
    assert all(np.array_equal(loaded.conditional(c).quantiles(QS),
                              ref.conditional(c).quantiles(QS)) for c in ref.keys())


def test_cross_covariance_matches_jax():
    rs = np.random.RandomState(3)
    a = (rs.randn(4096, 6) * 3 + 1).astype(np.float32)
    b = (a[:, :3] @ rs.randn(3, 5) + 0.5 * rs.randn(4096, 5)).astype(np.float32)
    ref, port = jax_running.RunningCrossCovariance(), RunningCrossCovariance()
    for i in range(0, 4096, 512):
        ref.add(a[i:i + 512], b[i:i + 512])
        port.add(a[i:i + 512], b[i:i + 512])
    assert port.count == ref.count == 4096.0
    for got, want in ((port.covariance(), ref.covariance()),
                      (port.correlation(), ref.correlation()),
                      *zip(port.mean(), ref.mean())):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    got, want = port.state_dict(), ref.state_dict()
    assert set(got) == set(want)
    loaded = RunningCrossCovariance().set_state_dict(want)
    assert np.array_equal(loaded.covariance(), np.asarray(ref.covariance()))


def test_running_variance_matches_jax():
    data = (3 + 2 * np.random.RandomState(4).randn(10000, 7)).astype(np.float32)
    ref, port = jax_running.RunningVariance(), RunningVariance()
    for i in range(0, 10000, 999):
        ref.add(data[i:i + 999])
        port.add(data[i:i + 999])
    assert port.count == ref.count
    np.testing.assert_allclose(port.mean(), ref.mean(), rtol=1e-6)
    np.testing.assert_allclose(port.variance(), ref.variance(), rtol=1e-5)
    np.testing.assert_allclose(port.stdev(0), ref.stdev(0), rtol=1e-5)
