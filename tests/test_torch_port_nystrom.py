"""The port's IPCA sketch and sklearn-mirror tiers against the JAX package's.

Each function of ``ganspace_tpu_torch/estimators/{utils,ipca}.py`` runs on
the same numpy inputs as its ``ganspace_tpu`` counterpart, with the sketch's
test matrix Omega shared (the port's own draw is replaced by JAX's
``PRNGKey(0xA5)`` one), so the two differ only by float32 reassociation.
Tolerances: 1e-4 relative on products and spectra, |cos| > 0.9999 on
components, equality on the host float64 factorizations (the same numpy
code on the same input).  The behavioural cases of
``tests/test_adaptive_refine.py`` and ``tests/test_nystrom_robust.py`` follow,
at their shapes (D=512, c=8), driven the way the decomposition drives the
port: ``fit_partial`` per block, then ``should_refine`` / ``begin_refine``
and the same blocks once more.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ganspace_tpu.estimators import ipca as jipca
from ganspace_tpu.estimators.utils import gram_svd as jax_gram_svd

from ganspace_tpu_torch.estimators import get_estimator
from ganspace_tpu_torch.estimators import ipca
from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
from ganspace_tpu_torch.estimators.utils import gram_svd
from ganspace_tpu_torch.ops.precision import ieee_f32


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


D, NB, C, N_BLOCKS = 512, 256, 8, 16
L = max(4 * C, C + 32)
REL = 1e-4                      # float32 products in another order


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def _close(got, ref, rel=REL):
    """max|d| <= rel * max|ref| (scale-aware: sketches span decades)."""
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max|d| {err:.3e} > {rel} * {scale:.3e}"


def _cos(a, b):
    return np.abs(np.sum(_np(a) * _np(b), axis=-1))


def _jax_omega(d, l):
    return np.array(jax.random.normal(jax.random.PRNGKey(0xA5), (d, l),
                                        jnp.float32))


@pytest.fixture
def shared_omega(monkeypatch):
    """The port sketches against JAX's Omega."""
    monkeypatch.setattr(ipca, "sketch_test_matrix", _jax_omega)


@pytest.fixture(autouse=True)
def _policy_env(monkeypatch):
    monkeypatch.delenv("GANSPACE_IPCA_REFINE", raising=False)
    monkeypatch.delenv("GANSPACE_IPCA_MOMENTS_MAX_D", raising=False)
    with ieee_f32():
        yield


def _blocks(spec, n_blocks=N_BLOCKS, seed=11, offset=0.0):
    rs = np.random.RandomState(seed)
    spec = np.asarray(spec, np.float32)
    return [(rs.randn(NB, len(spec)).astype(np.float32) * spec + offset)
            for _ in range(n_blocks)]


def _decay(r=0.9):
    return r ** np.arange(D)


def _exact_pca(blocks, c=C):
    x = np.concatenate(blocks).astype(np.float64)
    xc = x - x.mean(0)
    w, v = np.linalg.eigh((xc.T @ xc) / (len(x) - 1))
    return v[:, np.argsort(w)[::-1][:c]].T


def _two_pass(est, blocks):
    """The decomposition's sweep order: one sweep, then the refine sweep when the
    policy asks for it."""
    for b in blocks:
        assert est.fit_partial(b)
    if est.should_refine() and est.begin_refine():
        for b in blocks:
            assert est.fit_partial(b)
    return est


def _sketch_states(blocks):
    """The same two-block sketch in both packages, from zero state."""
    om = _jax_omega(D, L)
    ref = jipca._NystromState(jnp.asarray(0.0), jnp.zeros((D,)), jnp.asarray(0.0),
                              jnp.zeros((D, L)))
    got = ipca.NystromState(0.0, torch.zeros(D), torch.zeros(()), torch.zeros(D, L))
    for b in blocks:
        ref = jipca._nystrom_update(ref, jnp.asarray(b), jnp.asarray(om))
        got = ipca.nystrom_update(got, _t(b), _t(om))
    return ref, got, om


# ---------------------------------------------------------------------------
# Module items 1-2: gram_svd and the sketch functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [40, 700])       # k <= D: [k, k] Gram; k > D: [D, D]
def test_gram_svd_matches_jax(k):
    m = np.random.RandomState(k).randn(k, D).astype(np.float32) * _decay(0.99)
    s_ref, vt_ref = jax_gram_svd(jnp.asarray(m), C)
    s, vt = gram_svd(_t(m), C)
    _close(s, s_ref)
    _close(vt, vt_ref, rel=1e-3)                # same signs (svd_flip_vt)
    assert _cos(vt, vt_ref).min() > 0.9999


def test_nystrom_update_and_grams_match_jax():
    ref, got, om = _sketch_states(_blocks(_decay(0.97), n_blocks=2, offset=0.5))
    assert got.count == float(ref.count) == 2 * NB
    for a, b in ((got.s, ref.s), (got.sq, ref.sq), (got.y, ref.y)):
        _close(a, b)
    y_ref, m_ref, tot_ref = jipca._sketch_grams(ref, jnp.asarray(om))
    y, m, tot = ipca.sketch_grams(got, _t(om))
    _close(y, y_ref)
    _close(m, m_ref)
    assert torch.equal(m, m.T)
    np.testing.assert_allclose(float(tot), float(tot_ref), rtol=1e-4)
    w = np.random.RandomState(2).randn(L, L).astype(np.float32)
    f_ref, g_ref = jipca._whitened_gram(y_ref, jnp.asarray(w))
    f, g = ipca.whitened_gram(y, _t(w))
    _close(f, f_ref)
    _close(g, g_ref)


def test_host_factorizations_are_the_jax_ones():
    a = np.random.RandomState(3).randn(L, L)
    m = (a @ a.T * np.logspace(0, -9, L)).astype(np.float32)
    m = 0.5 * (m + m.T)
    np.testing.assert_array_equal(ipca.pinv_sqrt_psd(m), jipca._pinv_sqrt_psd(m))
    for got, ref in zip(ipca.eigh_desc(m), jipca._eigh_desc(m)):
        np.testing.assert_array_equal(got, ref)
    e = ipca.eigh_desc(m)[0]
    np.testing.assert_array_equal(ipca.noise_floor_scale(e),
                                  jipca._noise_floor_scale(e))
    bad = m.copy()
    bad[1, 2] = np.inf
    for check in (ipca.check_finite_gram, jipca._check_finite_gram):
        with pytest.raises(FloatingPointError):
            check(bad)
    ipca.check_finite_gram(m)


def test_sketch_factor_range_and_finish_match_jax():
    ref, got, om = _sketch_states(_blocks(_decay(0.97), n_blocks=4, offset=0.5))
    f_ref, e_ref, v_ref, tot_ref = jipca._sketch_factor(ref, jnp.asarray(om))
    f, e, v, tot = ipca.sketch_factor(got, _t(om))
    assert isinstance(f, torch.Tensor) and f.shape == (D, L)
    _close(e[:2 * C], e_ref[:2 * C])
    np.testing.assert_allclose(tot, tot_ref, rtol=1e-4)
    # eigenvector signs are free: hold the top directions by |cos|
    assert np.abs(np.sum(v[:, :2 * C] * v_ref[:, :2 * C], axis=0)).min() > 0.9999
    q_ref = np.asarray(jipca._range_from_factor(f_ref, e_ref, v_ref))
    q = ipca.range_from_factor(f, e, v)
    assert _cos(q.T[:2 * C], q_ref.T[:2 * C]).min() > 0.9999
    comp_ref, sd_ref, ratio_ref = jipca._finish_from_factor(
        f_ref, e_ref, v_ref, tot_ref, float(ref.count), C)
    comp, sd, ratio = ipca.finish_from_factor(f, e, v, tot, got.count, C)
    _close(comp, comp_ref, rel=1e-3)            # same signs
    assert _cos(comp, comp_ref).min() > 0.9999
    np.testing.assert_allclose(sd, sd_ref, rtol=1e-4)
    np.testing.assert_allclose(ratio, ratio_ref, rtol=1e-4)


def test_flip_cols_to_components_matches_jax():
    u = np.random.RandomState(4).randn(D, C).astype(np.float32)
    np.testing.assert_array_equal(
        _np(ipca.flip_cols_to_components(_t(u))),
        np.asarray(jipca._flip_cols_to_components(jnp.asarray(u))))


def test_sketch_test_matrix_is_seeded_and_gaussian():
    om = ipca.sketch_test_matrix(D, L)
    assert om.device.type == "cpu" and om.dtype == torch.float32
    assert torch.equal(om, ipca.sketch_test_matrix(D, L))
    assert abs(float(om.mean())) < 0.02 and abs(float(om.std()) - 1.0) < 0.02


# ---------------------------------------------------------------------------
# Module item 4: the sklearn-mirror tier
# ---------------------------------------------------------------------------

def test_sklearn_tier_math_matches_jax():
    blocks = _blocks(_decay(0.98), n_blocks=4, offset=1.0)
    z = np.zeros((D,), np.float32)
    zc = np.zeros((C,), np.float32)
    ref = jipca._IPCAState(z, z, np.zeros((C, D), np.float32), zc, zc, zc)
    got = ipca.IPCAState(*(torch.from_numpy(a) for a in ref))
    ref = jipca._partial_fit_math(ref, jnp.asarray(blocks[0]), jnp.float32(0.0),
                                  n_components=C, first=True)
    got = ipca.partial_fit_math(got, _t(blocks[0]), 0.0, n_components=C, first=True)
    ref = jipca._partial_fit_math(ref, jnp.asarray(blocks[1]), jnp.float32(NB),
                                  n_components=C, first=False)
    got = ipca.partial_fit_math(got, _t(blocks[1]), float(NB), n_components=C,
                                first=False)
    ref = jipca._partial_fit_scan(ref, jnp.asarray(np.stack(blocks[2:])),
                                  jnp.float32(2 * NB), n_components=C)
    got = ipca.partial_fit_scan(got, _t(np.stack(blocks[2:])), 2.0 * NB,
                                n_components=C)
    for name, a, b in zip(ref._fields, got, ref):
        _close(a, b, rel=1e-3 if name == "components" else REL)
    assert _cos(got.components, ref.components).min() > 0.9999


# ---------------------------------------------------------------------------
# Module items 3 and 5: the estimator API against the JAX estimator
# ---------------------------------------------------------------------------

def test_tier_selection_and_env_override(monkeypatch):
    for cls in (IPCAEstimator, jipca.IPCAEstimator):
        est = cls(4)
        assert est._use_moments(8192) and not est._use_nystrom(8192)
        assert not est._use_moments(8193) and est._use_nystrom(8193)
        monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "256")
        assert est._use_nystrom(D) and not est._use_moments(D)
        monkeypatch.delenv("GANSPACE_IPCA_MOMENTS_MAX_D")
        assert cls(4, mode="sklearn")._use_moments(16) is False
        assert cls(4, mode="sklearn")._use_nystrom(10 ** 6) is False
    with pytest.raises(ValueError):
        IPCAEstimator(4, mode="bogus")
    assert get_estimator("ipca", 4, refine="never").refine_policy == "never"
    assert get_estimator("ipca", 4).refine_policy == "auto"


@pytest.mark.parametrize("refine", ["auto", "always", "never"])
def test_sketch_estimator_matches_jax(shared_omega, monkeypatch, refine):
    monkeypatch.setenv("GANSPACE_IPCA_MOMENTS_MAX_D", "256")
    blocks = _blocks(np.linspace(2.0, 0.2, D), n_blocks=8, offset=0.3)
    ref = _two_pass(jipca.IPCAEstimator(C, refine=refine), blocks)
    got = _two_pass(IPCAEstimator(C, refine=refine), blocks)
    assert got._nystrom is not None and got._omega.shape == (D, L)
    assert got._refined == ref._refined == (refine != "never")
    assert got.refine_skipped == ref.refine_skipped
    assert got.policy_would_skip == ref.policy_would_skip
    assert (got.refine_stats is None) == (ref.refine_stats is None)
    if ref.refine_stats is not None:
        for k, v in ref.refine_stats.items():
            np.testing.assert_allclose(got.refine_stats[k], v, rtol=1e-3, err_msg=k)
    assert got.n_samples_seen_ == ref.n_samples_seen_ == 8 * NB
    np.testing.assert_allclose(got.mean_, ref.mean_, rtol=1e-5, atol=1e-6)
    _close(got.component_spectrum()[:2 * C], ref.component_spectrum()[:2 * C])
    comp, sd, ratio = got.get_components(device=True)
    comp_ref, sd_ref, ratio_ref = ref.get_components()
    assert isinstance(comp, torch.Tensor) and comp.shape == (C, D)
    assert _cos(comp, comp_ref).min() > 0.9999
    np.testing.assert_allclose(sd, sd_ref, rtol=REL)
    np.testing.assert_allclose(ratio, ratio_ref, rtol=REL)
    assert isinstance(got.get_components()[0], np.ndarray)
    assert got.finish_latent_bundle() is None and ref.finish_latent_bundle() is None


@pytest.mark.parametrize("mode", ["nystrom", "sklearn"])
def test_fit_partial_blocks_and_fit_match_jax(shared_omega, mode):
    blocks = _blocks(_decay(0.98), n_blocks=4, offset=0.2)
    ref, got = jipca.IPCAEstimator(C, mode=mode), IPCAEstimator(C, mode=mode)
    assert ref.fit_partial_blocks(np.stack(blocks))
    assert got.fit_partial_blocks(np.stack(blocks))
    ref2, got2 = jipca.IPCAEstimator(C, mode=mode), IPCAEstimator(C, mode=mode)
    ref2.fit(np.concatenate(blocks))
    got2.fit(np.concatenate(blocks))
    for g, r in ((got, ref), (got2, ref2)):
        assert g.n_samples_seen_ == r.n_samples_seen_
        cg, sg, vg = g.get_components()
        cr, sr, vr = r.get_components()
        assert _cos(cg, cr).min() > 0.9999
        np.testing.assert_allclose(sg, sr, rtol=REL)
        np.testing.assert_allclose(vg, vr, rtol=REL)
        np.testing.assert_allclose(g.mean_, r.mean_, rtol=1e-5, atol=1e-6)
    assert got.fit_partial_blocks(np.zeros((2, C - 1, D), np.float32)) is False


def test_moments_spectrum_matches_jax():
    blocks = _blocks(_decay(0.99)[:64], n_blocks=3)
    ref, got = jipca.IPCAEstimator(C), IPCAEstimator(C)
    for b in blocks:
        ref.fit_partial(b)
        got.fit_partial(b)
    _close(got.component_spectrum(), ref.component_spectrum())
    assert got.refine_skipped is None and got.should_refine() is False
    assert got.begin_refine() is False


# ---------------------------------------------------------------------------
# Behaviour: the adaptive refine policy (tests/test_adaptive_refine.py)
# ---------------------------------------------------------------------------

def _policy_run(spec, refine=None, n_blocks=N_BLOCKS):
    blocks = _blocks(spec, n_blocks=n_blocks)
    return _two_pass(IPCAEstimator(C, mode="nystrom", refine=refine), blocks), blocks


def test_decaying_spectrum_skips_refine_and_keeps_parity():
    est, blocks = _policy_run(_decay())
    assert est.refine_skipped is True and est.policy_would_skip is True
    assert est.refine_stats["sketch_tail_frac"] <= est.REFINE_TAIL_FRAC
    assert est.refine_stats["min_rel_gap_topc"] >= est.REFINE_MIN_GAP
    assert est.n_samples_seen_ == N_BLOCKS * NB and not est._refined
    comp, _, _ = est.get_components()
    cos = _cos(_exact_pca(blocks), comp)
    assert cos.min() >= 0.99, cos


def test_flat_spectrum_keeps_refine():
    est, _ = _policy_run(np.ones(D))
    assert est.refine_skipped is False and est.policy_would_skip is False
    assert est.refine_stats["sketch_tail_frac"] > est.REFINE_TAIL_FRAC
    assert est.n_samples_seen_ == N_BLOCKS * NB and est._refined


def _plateau_at_cut():
    spec = _decay()
    spec[C - 3:C + 3] = spec[C - 3]
    return spec


def _degenerate_pair_at_cut():
    spec = _decay()
    spec[C] = spec[C - 1]
    return spec


@pytest.mark.parametrize("spec, n_blocks", [
    (_plateau_at_cut(), N_BLOCKS),
    # a degenerate pair's estimated gap is sample noise ~ sqrt(2/n): 8x the
    # stream puts it near 1%, under the 2% guard
    (_degenerate_pair_at_cut(), 8 * N_BLOCKS),
], ids=["plateau", "degenerate_pair"])
def test_eigengap_guard_keeps_refine(spec, n_blocks):
    est, _ = _policy_run(spec, n_blocks=n_blocks)
    assert est.refine_stats["sketch_tail_frac"] <= est.REFINE_TAIL_FRAC
    assert est.refine_stats["min_rel_gap_topc"] < est.REFINE_MIN_GAP
    assert est.refine_skipped is False and est._refined


@pytest.mark.parametrize("mode, spec, refined", [
    ("always", _decay(), True), ("1", _decay(), True),
    ("never", np.ones(D), False), ("0", np.ones(D), False)])
def test_explicit_policy_overrides(monkeypatch, mode, spec, refined):
    monkeypatch.setenv("GANSPACE_IPCA_REFINE", mode)
    est, _ = _policy_run(spec)
    assert est.refine_skipped is (not refined)
    assert est._refined is refined
    assert est.refine_stats is None             # no auto decision was made


def test_sketch_convergence_is_none_before_data():
    est = IPCAEstimator(C, mode="nystrom")
    assert est.sketch_convergence() is None
    assert est.should_refine() is False
    assert est.component_spectrum() is None


def test_refine_policy_fixed_at_construction(monkeypatch):
    monkeypatch.setenv("GANSPACE_IPCA_REFINE", "never")
    est = IPCAEstimator(C, mode="nystrom")
    monkeypatch.setenv("GANSPACE_IPCA_REFINE", "always")
    _two_pass(est, _blocks(np.ones(D), n_blocks=4))
    assert est.refine_skipped is True and not est._refined
    assert IPCAEstimator(C, mode="nystrom", refine="never").refine_policy == "never"


# ---------------------------------------------------------------------------
# Behaviour: robustness (tests/test_nystrom_robust.py) and refine bookkeeping
# ---------------------------------------------------------------------------

def _shaped(floor=1e-4, r=0.96):
    """r^i floored: ~8 decades of variance."""
    return np.maximum(r ** np.arange(D), floor)


def test_decay_shaped_range_is_finite_and_orthonormal():
    est, _ = _policy_run(_shaped(), refine="never", n_blocks=8)
    q = _np(ipca.range_from_factor(*ipca.sketch_factor(est._nystrom, est._omega)[:3]))
    assert np.isfinite(q).all()
    kept = np.linalg.norm(q, axis=0) > 0.5
    assert kept.sum() >= C
    qk = q[:, kept]
    assert np.abs(qk.T @ qk - np.eye(kept.sum())).max() < 1e-2
    stats = est.sketch_convergence()
    assert 0.0 <= stats["sketch_tail_frac"] <= 1.0
    assert np.isfinite(stats["min_rel_gap_topc"])


def test_decay_shaped_refine_completes_with_quality():
    est, blocks = _policy_run(_shaped(), refine="always", n_blocks=8)
    assert est._refined
    comp, stdev, _ = est.get_components()
    assert np.isfinite(comp).all() and np.isfinite(stdev).all()
    cos = _cos(_exact_pca(blocks), comp)
    assert cos.min() >= 0.99, cos


@pytest.mark.parametrize("mode", ["nystrom", "moments"])
def test_nan_stream_raises(mode):
    blocks = _blocks(np.ones(D), n_blocks=2)
    blocks[1][0, 0] = np.nan if mode == "nystrom" else np.inf
    est = IPCAEstimator(C, mode=mode, refine="never")
    for b in blocks:
        est.fit_partial(b)
    with pytest.raises(FloatingPointError):
        est.get_components()
    if mode == "nystrom":
        with pytest.raises(FloatingPointError):
            est.sketch_convergence()
        with pytest.raises(FloatingPointError):
            ipca.sketch_factor(est._nystrom, est._omega)


def test_pinv_sqrt_drops_noise_directions():
    m = np.diag([4.0, 1.0, 1e-12, -1e-9]).astype(np.float32)
    w = ipca.pinv_sqrt_psd(m)
    assert np.isfinite(w).all()
    p = w @ m.astype(np.float64) @ w
    assert np.allclose(p[:2, :2], np.eye(2), atol=1e-6)
    assert np.abs(p[2:, 2:]).max() < 1e-6
    with pytest.raises(FloatingPointError):
        ipca.pinv_sqrt_psd(np.array([[np.nan, 0.0], [0.0, 1.0]]))


def test_abort_refine_restores_the_first_pass_sketch():
    blocks = _blocks(np.ones(D), n_blocks=6)
    est = IPCAEstimator(C, mode="nystrom")
    for b in blocks:
        est.fit_partial(b)
    first = est._nystrom
    comp0 = est.get_components()[0]
    assert est.should_refine() and est.begin_refine()
    assert est.n_samples_seen_ == 0 and float(est._nystrom.y.abs().max()) == 0.0
    est.fit_partial(blocks[0])                  # a partial second pass
    est.abort_refine()
    assert est._nystrom is first and est.n_samples_seen_ == 6 * NB
    assert not est._refined and est.refine_skipped is None
    np.testing.assert_array_equal(est.get_components()[0], comp0)
    est.abort_refine()                          # nothing armed: no-op
    assert est._nystrom is first


def test_factor_memo_sees_new_data():
    """fit -> should_refine -> fit -> get_components reads the new sketch,
    not the factor memoized before the second fit."""
    blocks = _blocks(_decay(0.97), n_blocks=4, seed=5)
    est = IPCAEstimator(C, mode="nystrom", refine="never")
    for b in blocks[:2]:
        est.fit_partial(b)
    assert est.should_refine() is False          # factors nothing under 'never'
    est.sketch_convergence()                    # memoizes the 2-block factor
    for b in blocks[2:]:
        est.fit_partial(b)
    comp, sd, _ = est.get_components()
    fresh = IPCAEstimator(C, mode="nystrom", refine="never")
    for b in blocks:
        fresh.fit_partial(b)
    comp_f, sd_f, _ = fresh.get_components()
    np.testing.assert_array_equal(comp, comp_f)
    np.testing.assert_array_equal(sd, sd_f)


def test_refined_sketch_beats_single_pass_and_the_sklearn_tier():
    """The production finding at D=512, c=8 (tests/test_nystrom_production.py
    at D=131072): on a slowly decaying stream the single-pass sketch trails
    exact PCA, one refine pass brings every component above 0.99, and the
    sklearn mirror holds only its top half."""
    blocks = _blocks(_decay(0.97), n_blocks=8)
    exact = _exact_pca(blocks)
    single = IPCAEstimator(C, mode="nystrom", refine="never")
    for b in blocks:
        single.fit_partial(b)
    sketch = _two_pass(IPCAEstimator(C, mode="nystrom", refine="always"), blocks)
    sk = IPCAEstimator(C, mode="sklearn")
    for b in blocks:
        sk.fit_partial(b)
    refined = _cos(exact, sketch.get_components()[0])
    assert refined.min() > 0.99, refined
    assert _cos(exact, single.get_components()[0]).min() < refined.min()
    assert _cos(exact, sk.get_components()[0])[:C // 2].min() > 0.95
