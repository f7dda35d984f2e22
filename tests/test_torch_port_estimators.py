"""The port's full-batch estimators (PCA, fbpca, FastICA, sparse PCA) on the
CPU, against sklearn as ``tests/test_estimators.py`` holds the JAX package's,
and against the JAX estimators on the same numpy data.

Bars against JAX: PCA and fbpca |cos| > 0.9999 rank by rank, stdev and
var_ratio within 1e-4 relative; ICA every JAX component matched at |cos| >
0.99 and ``n_iter_`` within 2; SPCA |cos| > 0.99 rank by rank and the same
zero pattern outside entries within 1e-6 of the threshold.  Kernel A's
branch: the JAX PCA and ICA with ``use_pallas_gram`` forced and the Pallas
kernel in interpret mode, against the port's Gram branch, whose
``centered_gram`` takes its plain version on a CPU tensor.
"""

import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA, FastICA

from ganspace_tpu import estimators as jax_estimators
from ganspace_tpu.estimators import pca as jax_pca
from ganspace_tpu.ops import pallas as jax_pallas
from ganspace_tpu.ops.pallas.moments import centered_gram as pallas_centered_gram

from ganspace_tpu_torch.estimators import get_estimator
from ganspace_tpu_torch.estimators import pca as port_pca
from ganspace_tpu_torch.ops.moments import centered_gram

N, D, C = 2000, 48, 6
STAT_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    """These small fits gain nothing from many intra-op threads, and under
    several test workers per machine many threads per worker oversubscribe
    the cores; the previous count is restored after each test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _est(name, c=C, alpha=1.0):
    return get_estimator(name, c, alpha, device="cpu")


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    basis = np.linalg.qr(rs.randn(D, D))[0]
    scales = np.concatenate([np.linspace(10, 2, 12), 0.1 * np.ones(D - 12)])
    return ((rs.randn(N, D) * scales) @ basis.T + 5.0).astype(np.float32)


@pytest.fixture(scope="module")
def centered(data):
    return data - data.mean(0, keepdims=True)


def _sources(n=N, d=D, c=C, seed=0):
    rs = np.random.RandomState(seed)
    s = rs.laplace(size=(n, c)).astype(np.float32)
    a = rs.randn(c, d).astype(np.float32)
    x = s @ a
    return x - x.mean(0, keepdims=True)


def cos_rows(a, b):
    return np.abs(np.sum(a * b, -1)
                  / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)))


def _fit_both(name, x, c=C, alpha=1.0):
    port, ref = _est(name, c, alpha), jax_estimators.get_estimator(name, c, alpha)
    port.fit(x.copy())
    ref.fit(x.copy())
    return port, ref


def _same_pca(port, ref, cos_bar=0.9999):
    (comp, stdev, ratio), (rcomp, rstdev, rratio) = port.get_components(), ref.get_components()
    assert cos_rows(comp, rcomp).min() > cos_bar
    np.testing.assert_allclose(stdev, rstdev, rtol=STAT_RTOL)
    np.testing.assert_allclose(ratio, rratio, rtol=STAT_RTOL)


# -- tests/test_estimators.py, against the port -------------------------------

def test_pca_matches_sklearn(centered):
    ours = _est("pca")
    ours.fit(centered.copy())
    sk = PCA(C, svd_solver="full").fit(centered)
    comp, stdev, var_ratio = ours.get_components()
    assert cos_rows(comp, sk.components_).min() > 0.9999
    assert np.allclose(stdev, np.sqrt(sk.explained_variance_), rtol=1e-2)
    assert np.all(np.abs(ours.mean_) < 1e-3)


def test_fbpca_matches_full_pca(centered):
    ours = _est("fbpca")
    ours.fit(centered.copy())
    sk = PCA(C, svd_solver="full").fit(centered)
    comp, _, _ = ours.get_components()
    assert cos_rows(comp, sk.components_).min() > 0.999
    assert ours.get_param_str() == f"fbpca_c{C}_it2_l{2*C}"


def test_ica_recovers_sources():
    x = _sources()
    ours = _est("ica")
    ours.fit(x)
    comp, stdev, var_ratio = ours.get_components()
    sk = FastICA(C, random_state=0, whiten="unit-variance", max_iter=10000).fit(x)
    skc = sk.components_ / np.linalg.norm(sk.components_, axis=-1, keepdims=True)
    assert np.abs(comp @ skc.T).max(axis=1).min() > 0.99  # every sklearn IC recovered
    assert np.all(np.diff(stdev) <= 1e-6)                 # sorted descending
    assert np.all(np.abs(ours.mean_) < 1e-3)               # sklearn's mean_, set


def test_spca_sparsity_scales_with_alpha(centered):
    sparsities = []
    for alpha in (1.0, 5.0):
        est = _est("spca", alpha=alpha)
        est.fit(centered.copy())
        comp, stdev, _ = est.get_components()
        sparsities.append(np.mean(np.abs(comp) < 1e-8))
        assert np.allclose(np.linalg.norm(comp, axis=1), 1.0, atol=1e-4)
        assert np.all(np.diff(stdev) <= 1e-5)
        assert np.all(np.abs(est.mean_) < 1e-3)
    assert sparsities[1] > sparsities[0] > 0.05


def test_param_strings():
    # Cache filenames depend on these exact strings (decomposition.py:384-394).
    for name, alpha in (("ipca", 1.0), ("pca", 1.0), ("fbpca", 1.0), ("ica", 1.0),
                        ("spca", 10.0)):
        assert (_est(name, 80, alpha).get_param_str()
                == jax_estimators.get_estimator(name, 80, alpha).get_param_str())
    assert _est("pca", 80).get_param_str() == "pca-full_c80"
    assert _est("fbpca", 80).get_param_str() == "fbpca_c80_it2_l160"
    assert _est("ica", 80).get_param_str() == "ica_c80_w"
    assert _est("spca", 80, 10.0).get_param_str() == "spca_c80_a10.0"
    with pytest.raises(RuntimeError):
        _est("nope", 80)


def test_rejects_small_batch():
    ours = _est("ipca")
    assert not ours.fit_partial(np.zeros((C - 1, D), np.float32))


@pytest.mark.parametrize("name", ["pca", "fbpca", "ica", "spca"])
def test_full_batch_estimators_default_to_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        get_estimator(name, C)
    assert not get_estimator(name, C, device="cpu").batch_support


# -- parity with the JAX estimators ------------------------------------------

@pytest.mark.parametrize("name", ["pca", "fbpca"])
def test_pca_and_fbpca_match_jax(centered, name):
    port, ref = _fit_both(name, centered)
    _same_pca(port, ref)
    np.testing.assert_allclose(port.mean_, ref.mean_, atol=1e-6)


def test_ica_matches_jax():
    port, ref = _fit_both("ica", _sources())
    comp, stdev, _ = port.get_components()
    rcomp, rstdev, _ = ref.get_components()
    assert np.abs(rcomp @ comp.T).max(axis=1).min() > 0.99
    assert abs(port.n_iter_ - ref.n_iter_) <= 2, (port.n_iter_, ref.n_iter_)
    np.testing.assert_allclose(stdev, rstdev, rtol=1e-3)


def test_spca_matches_jax(centered):
    port, ref = _fit_both("spca", centered, alpha=1.0)
    comp, _, _ = port.get_components()
    rcomp, _, _ = ref.get_components()
    assert cos_rows(comp, rcomp).min() > 0.99
    # the zero pattern, but for entries that sit within 1e-6 of the threshold
    # (a soft-thresholded entry that small can fall either side of it)
    differ = (comp == 0) != (rcomp == 0)
    assert np.all(np.maximum(np.abs(comp), np.abs(rcomp))[differ] < 1e-6)
    assert np.mean(comp == 0) > 0.05


@pytest.fixture
def kernel_gram_branch(monkeypatch):
    """Both packages on their Gram-kernel branch on the CPU: the JAX Pallas
    kernel in interpret mode, the port's ``centered_gram`` (plain on a CPU
    tensor).  Yields the shapes the port's branch was called at."""
    calls = []

    def interpreted(x, mu=None):
        calls.append(("jax", tuple(x.shape)))
        return pallas_centered_gram(x, mu, interpret=True)

    def recorded(x, mu=None):
        calls.append(("port", tuple(x.shape)))
        return centered_gram(x, mu)
    monkeypatch.setattr(jax_pca, "use_pallas_gram", lambda n, d: True)
    monkeypatch.setattr(jax_pallas, "centered_gram", interpreted)
    # PCA's Gram and ICA's whitening both route through pca.covariance
    monkeypatch.setattr(port_pca, "use_kernel_gram", lambda n, d, device: True)
    monkeypatch.setattr(port_pca, "centered_gram", recorded)
    yield calls


@pytest.mark.parametrize("n,d", [(512, 512), (511, 512), (4096, 511), (8192, 8192),
                                 (8192, 8193), (100, 1024), (1_003_520, 512),
                                 (2 ** 31 // 512 + 64, 512), (2 ** 31 // 8192 + 64, 8192),
                                 (304_128, 8192), (5_001_984, 512)])
def test_use_kernel_gram_keeps_the_jax_rule(monkeypatch, n, d):
    """The port takes kernel A on the card exactly where the JAX package
    takes its Pallas kernel on the TPU, past 2^31 elements too (the kernel
    addresses X in 64 bits), and never on the CPU."""
    monkeypatch.setattr(jax_pca.jax, "default_backend", lambda: "tpu")
    assert port_pca.use_kernel_gram(n, d, torch.device("cuda")) == jax_pca.use_pallas_gram(n, d)
    assert not port_pca.use_kernel_gram(n, d, torch.device("cpu"))


def test_covariance_on_the_cpu_is_the_centered_product():
    rs = np.random.RandomState(3)
    x = torch.from_numpy((rs.randn(600, 512) * 3.0 + 1.0).astype(np.float32))
    mean = x.mean(dim=0)
    launches = centered_gram.launches
    got = port_pca.covariance(x, mean)
    assert centered_gram.launches == launches
    assert torch.equal(got, (x - mean).T @ (x - mean))


def test_pca_kernel_gram_branch_matches_jax(kernel_gram_branch):
    rs = np.random.RandomState(1)
    n, d = 2048, 512
    x = (rs.randn(n, d) * np.linspace(4.0, 0.5, d)).astype(np.float32)
    x -= x.mean(0, keepdims=True)
    launches = centered_gram.launches
    port, ref = _fit_both("pca", x, c=16)
    assert kernel_gram_branch == [("port", (n, d)), ("jax", (n, d))]
    assert centered_gram.launches == launches      # CPU: the plain version
    _same_pca(port, ref)


def test_ica_kernel_gram_branch_matches_jax(kernel_gram_branch):
    x = _sources(n=2048, d=512, c=8, seed=2)
    port, ref = _fit_both("ica", x, c=8)
    assert kernel_gram_branch == [("port", (2048, 512)), ("jax", (2048, 512))]
    assert np.abs(ref.get_components()[0] @ port.get_components()[0].T
                  ).max(axis=1).min() > 0.99
    assert abs(port.n_iter_ - ref.n_iter_) <= 2, (port.n_iter_, ref.n_iter_)
