"""FastICA (``ganspace_tpu/estimators/ica.py``; reference ``ICAEstimator``,
``estimators.py:18-52``).

sklearn's defaults, which the reference relies on: logcosh contrast, PCA
whitening to c dimensions, symmetric decorrelation, parallel updates, the
``RandomState(0)`` start.  The whitening covariance comes from PCA's
``covariance`` (kernel A on the card under the JAX package's rule).  The fixed-point loop is a
Python loop with the JAX package's stopping rule (``it < max_iter and lim >
tol``); it reads ``lim`` back every iteration and raises when the cap is hit,
as the reference does (``estimators.py:33-34``).  Each iteration is two
[c, n] x [n, c]-shaped products and a c x c eigh.
"""

from __future__ import annotations

import numpy as np
import torch

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.estimators.pca import (
    as_samples, covariance, project_stdev_sort, total_variance)
from ganspace_tpu_torch.estimators.utils import svd_flip_vt, topk_eigh_desc
from ganspace_tpu_torch.ops.precision import ieee_f32


def _sym_decorrelate(w: torch.Tensor) -> torch.Tensor:
    """W <- (W W^T)^(-1/2) W, the c x c factor formed in float64: a float32
    eigh on the card leaves its vectors orthonormal only to ~1e-4
    (``utils.topk_eigh_desc``), the size of the loop's tolerance on ``lim``."""
    evals, evecs = torch.linalg.eigh((w @ w.T).to(torch.float64))
    inv_sqrt = (evecs * torch.rsqrt(torch.clamp(evals, min=1e-10))) @ evecs.T
    return inv_sqrt.to(w.dtype) @ w


def fastica(x1: torch.Tensor, w_init: torch.Tensor, max_iter: int,
            tol: float = 1e-4) -> tuple[torch.Tensor, int]:
    """x1: whitened data [c, n]; returns (W [c, c], the iterations run)."""
    n = x1.shape[1]
    w = _sym_decorrelate(w_init)
    it, lim = 0, float("inf")
    while it < max_iter and lim > tol:
        g = torch.tanh(w @ x1)
        g_prime = torch.mean(1.0 - torch.square(g), dim=1)
        w1 = _sym_decorrelate((g @ x1.T) / n - g_prime[:, None] * w)
        lim = float(torch.max(torch.abs(torch.abs(torch.diagonal(w1 @ w.T)) - 1.0)))
        w, it = w1, it + 1
    return w, it


class ICAEstimator:
    def __init__(self, n_components: int, device="cuda"):
        self.n_components = n_components
        self.device = require_device(device)
        self.maxiter = 10000
        self.whiten = True  # ICA: whitening is essential, should not be skipped
        self.batch_support = False
        self.stdev = np.zeros((n_components,), np.float32)
        self.total_var = 0.0
        self.mean_ = None
        self.components_ = None
        self.n_iter_ = 0

    def get_param_str(self) -> str:
        return "ica_c{}{}".format(self.n_components, "_w" if self.whiten else "")

    def fit(self, x):
        with ieee_f32():
            self._fit(as_samples(x, self.device))

    def _fit(self, x: torch.Tensor) -> None:
        n = x.shape[0]
        c = self.n_components
        mean = torch.mean(x, dim=0)
        # The data mean, as sklearn's FastICA records it (the JAX estimator
        # omits it, so its pipeline's mean_ check fails).
        self.mean_ = mean.cpu().numpy()[None, :]

        # PCA whitening to c dims: K [c, D] such that K xc^T has identity
        # covariance (D is small beside n for ICA-feasible configurations:
        # the 32-bit LAPACK size guard of reference decomposition.py:212-215).
        evals, evecs = topk_eigh_desc(covariance(x, mean) / n)
        # LAPACK leaves each eigenvector's sign free, and so FastICA's start
        # in the whitened basis.  The JAX package leaves it there; here it is
        # fixed by sklearn's svd_flip rule, so that the start does not depend
        # on the solver build.  On near-Gaussian data FastICA's end point
        # still moves with 1e-7 relative noise in x.
        basis = svd_flip_vt(evecs[:, :c].T)                # [c, D]
        k_mat = basis * torch.rsqrt(torch.clamp(evals[:c], min=1e-12))[:, None]
        x1 = k_mat @ (x - mean).T                         # [c, n]

        w_init = torch.from_numpy(
            np.random.RandomState(0).standard_normal((c, c)).astype(np.float32))
        w, self.n_iter_ = fastica(x1, w_init.to(x.device), self.maxiter)
        if self.n_iter_ >= self.maxiter:
            raise RuntimeError(f"FastICA did not converge (N={n}, it={self.maxiter})")

        # Unmixing rows in D space, normalized; ranked by projected stdev
        # (reference estimators.py:36-48).
        comp = w @ k_mat
        comp = comp / torch.sqrt(torch.sum(comp ** 2, dim=-1, keepdim=True))
        self.total_var = total_variance(x)
        self.components_, self.stdev = project_stdev_sort(comp, x)

    def get_components(self):
        var_ratio = self.stdev ** 2 / self.total_var
        return self.components_, self.stdev, var_ratio  # ICA outputs are not normalized
