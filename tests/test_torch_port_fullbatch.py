"""The port's full-batch fit path (the "Collecting" sweep of ``_compute``)
against the JAX package's, end to end on a small StyleGAN2.

Both packages run the same weights on the host RNG stream
(``GANSPACE_DEVICE_RNG=0``, the JAX package on one device), at ``style
--use_w`` (D = 512) and at the conv tap ``conv1`` (64 x 4 x 4, D = 1024,
with the regression sweep).  ``pca`` and ``fbpca`` go through both
``get_or_compute``s: identical filenames, npz keys and ``_meta``;
``act_mean`` within 1e-4 relative (the activations' bar: a fit over the
n_total rows alone, without the zero tail of nb rows, misses it by the
factor n_total / (n_total + nb)); components at |cos| > 0.99.  The JAX
pipeline cannot run ``ica`` or ``spca`` (its estimators never set
``mean_``, which it asserts on), so those two are held against the JAX
estimators' ``fit`` on the matrix the port collected.  The activations of
random weights are near Gaussian, where FastICA's fixed point depends on its
start, and so on the signs LAPACK gives the whitening eigenvectors: the JAX
ICA here takes the port's sign rule (sklearn's ``svd_flip``) for them, a
rule the port adds to the JAX estimator on purpose.  The unchanged JAX ICA
is held against the port's on planted sources in
``test_torch_port_estimators.py``.
"""

import json

import numpy as np
import pytest
import torch

from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.estimators import get_estimator as jax_get_estimator
from ganspace_tpu.estimators import ica as jax_ica
from ganspace_tpu.estimators import utils as jax_utils
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.estimators import ICAEstimator, SPCAEstimator
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel

CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))
C = 8
MEAN_RTOL = 1e-4
# (layer, use_w, n, batch): n_total and nb = max(batch, 2000, 3c) rows
CASES = {"w": ("style", True, 2048, None), "conv": ("conv1", False, 2000, 500)}


@pytest.fixture(autouse=True)
def _few_threads():
    """These small fits gain nothing from many intra-op threads, and under
    several test workers per machine many threads per worker oversubscribe
    the cores; the previous count is restored after each test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _models():
    cfg = dict(resolution=32, channels=CHANNELS)
    params = jax_sg2.init_params(jax_sg2.SG2Config(**cfg), seed=3)
    jax_model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=jax_sg2.SG2Config(**cfg),
                                  params=params)
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(**cfg), params=params,
                               device="cpu")
    return jax_model, port


def _load(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _config_kw(case, estimator, **kw):
    layer, use_w, n, batch = CASES[case]
    return dict(model="StyleGAN2", output_class="ffhq", layer=layer, estimator=estimator,
                components=C, n=n, batch_size=batch, use_w=use_w, **kw)


def _rows(a):
    return a.reshape(C, -1).astype(np.float64)


def _cos(a, b):
    a, b = _rows(a), _rows(b)
    return np.abs(np.sum(a * b, axis=1)
                  / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)))


@pytest.fixture
def host_rng(monkeypatch):
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")


def _port_run(tmp_path, monkeypatch, kw, port=None):
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    port = port or _models()[1]
    return get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("estimator", ["pca", "fbpca"])
def test_full_batch_caches_match_jax(tmp_path, monkeypatch, host_rng, estimator, case):
    kw = _config_kw(case, estimator)
    jax_model, port = _models()
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    ref_path = jax_get_or_compute(JaxConfig(mesh_shape="1", **kw),
                                  JaxInstrumented(jax_model))
    path = _port_run(tmp_path, monkeypatch, kw, port)

    assert path.name == ref_path.name
    ref, got = _load(ref_path), _load(path)
    assert set(got) == set(ref)
    assert json.loads(got["_meta"].item()) == json.loads(ref["_meta"].item())
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    mean_err = np.abs(got["act_mean"] - ref["act_mean"]).max()
    assert mean_err <= MEAN_RTOL * np.abs(ref["act_mean"]).max(), mean_err
    act_cos, lat_cos = _cos(got["act_comp"], ref["act_comp"]), _cos(got["lat_comp"],
                                                                    ref["lat_comp"])
    print(f"\n{estimator} at {kw['layer']}: min |cos| act_comp {act_cos.min():.6f}, "
          f"lat_comp {lat_cos.min():.6f}, act_mean max|d| {mean_err:.3e}")
    assert act_cos.min() > 0.99 and lat_cos.min() > 0.99
    for k in ("act_stdev", "var_ratio", "random_stdevs", "lat_stdev"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("estimator", ["ica", "spca"])
def test_ica_and_spca_match_the_jax_estimators(tmp_path, monkeypatch, host_rng, estimator):
    """The matrix the port collected (n_total + nb rows, the zero tail
    centered to -mean), fitted by the JAX estimator."""
    cls = ICAEstimator if estimator == "ica" else SPCAEstimator
    fitted = []
    fit = cls.fit

    def recording_fit(self, x):
        fitted.append((self, x.numpy().copy()))
        return fit(self, x)
    monkeypatch.setattr(cls, "fit", recording_fit)
    kw = _config_kw("w", estimator)
    path = _port_run(tmp_path, monkeypatch, kw)
    assert path.name == {"ica": "stylegan2-ffhq_style_ica_c8_w_n2048_w.npz",
                         "spca": "stylegan2-ffhq_style_spca_c8_a1.0_n2048_w.npz"}[estimator]
    got = _load(path)
    ((port_est, x),) = fitted
    n_total, nb = 2048, 2048
    assert x.shape == (n_total + nb, 512)
    np.testing.assert_array_equal(x[n_total:], np.broadcast_to(
        -got["act_mean"].reshape(1, -1), (nb, 512)))

    def signed_eigh(g):
        evals, evecs = jax_utils.topk_eigh_desc(g)
        return evals, jax_utils.svd_flip_vt(evecs.T).T
    monkeypatch.setattr(jax_ica, "topk_eigh_desc", signed_eigh)
    ref = jax_get_estimator(estimator, C)
    ref.fit(x.copy())
    rcomp, rstdev, rratio = ref.get_components()
    comp = got["act_comp"].reshape(C, -1)
    if estimator == "ica":
        match = np.abs(rcomp @ comp.T).max(axis=1)
        print(f"\nica: every JAX component matched at |cos| >= {match.min():.6f}; "
              f"{port_est.n_iter_} iterations, JAX {ref.n_iter_}")
        assert match.min() > 0.99
        assert abs(port_est.n_iter_ - ref.n_iter_) <= 2
    else:
        cos = _cos(comp, rcomp)
        print(f"\nspca: min |cos| rank by rank {cos.min():.6f}")
        assert cos.min() > 0.99
        np.testing.assert_allclose(got["act_stdev"], rstdev, rtol=1e-3)
        np.testing.assert_allclose(got["var_ratio"], rratio, rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(comp, axis=1), 1.0, atol=1e-5)
    assert (np.diff(got["act_stdev"]) <= 1e-6).all()


def test_ica_size_guard_matches_jax(tmp_path, monkeypatch, host_rng):
    kw = _config_kw("w", "ica") | dict(n=1_100_000)
    jax_model, port = _models()
    msg = "Matrices too large for ICA, please use N <= 1048575"
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    with pytest.raises(RuntimeError, match=msg):
        jax_get_or_compute(JaxConfig(mesh_shape="1", **kw), JaxInstrumented(jax_model))
    with pytest.raises(RuntimeError, match=msg):
        _port_run(tmp_path, monkeypatch, kw, port)


def test_interrupt_while_collecting_exits_without_a_cache(tmp_path, monkeypatch, host_rng):
    _, port = _models()
    calls = []
    forward = port.partial_forward

    def interrupted(*a, **k):
        calls.append(1)
        if len(calls) == 3:          # the probe, then the sweep's second batch
            raise KeyboardInterrupt
        return forward(*a, **k)
    monkeypatch.setattr(port, "partial_forward", interrupted)
    with pytest.raises(SystemExit) as exc:
        _port_run(tmp_path, monkeypatch, _config_kw("conv", "pca"), port)
    assert exc.value.code == 1 and len(calls) == 3
    assert not list((tmp_path / "torch").rglob("*.npz"))


@pytest.mark.parametrize("estimator", ["ica", "spca"])
def test_cli_writes_ica_and_spca_caches(tmp_path, monkeypatch, host_rng, estimator):
    """``--est ica`` / ``--est spca`` through the port's CLI, ``--sparsity``
    passed through to the estimator and the output directory."""
    _, port = _models()
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyStyleGAN2", lambda oc, device, **kw: port)
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    result = visualize.main(["--model", "TinyStyleGAN2", "--class", "ffhq", "--use_w",
                             "--layer", "style", "--est", estimator, "--sparsity", "2.0",
                             "-c", "4", "-n", "2048", "--device", "cpu"])
    param = {"ica": "ica_c4_w", "spca": "spca_c4_a2.0"}[estimator]
    assert result.cache.name == f"tinystylegan2-ffhq_style_{param}_n2048_w.npz"
    assert set(_load(result.cache)) >= {"act_comp", "lat_comp", "_meta"}
    est_dir = {"ica": "ica", "spca": "spca_2.0"}[estimator]
    summ = tmp_path / "out" / "StyleGAN2-ffhq" / "style" / est_dir / "summ"
    assert (summ / "components_W.jpg").is_file()
