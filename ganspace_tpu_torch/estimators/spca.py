"""Sparse PCA (``ganspace_tpu/estimators/spca.py``; reference
``SPCAEstimator``, ``estimators.py:165-204``).

The reference defers to sklearn's ``SparsePCA``.  The JAX package solves
the same objective

    min_{U, V}  1/2 ||X - U V||_F^2 + alpha ||V||_1

by alternating minimization in dense linear algebra, and so does this port:
a ridge least-squares solve for the codes U (c x c), then FISTA
soft-thresholding steps for the sparse components V, warm-started from the
PCA basis.  50 outer steps of 20 FISTA steps each run as eager launches on
the estimator's device.  Components come back normalized and ranked by the
stdev of their ridge-coded coordinates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.estimators.pca import as_samples, check_orthogonality, total_variance
from ganspace_tpu_torch.estimators.utils import gram_svd
from ganspace_tpu_torch.ops.precision import ieee_f32


def _soft(z: torch.Tensor, t: float) -> torch.Tensor:
    return torch.sign(z) * torch.clamp(torch.abs(z) - t, min=0.0)


def spca_alternate(x: torch.Tensor, v0: torch.Tensor, alpha: float,
                   ridge: float = 0.01, n_iter: int = 50,
                   inner_steps: int = 20) -> torch.Tensor:
    """x [n, D] centered; v0 [c, D] the start.  Returns the sparse V [c, D]."""
    eye = torch.eye(v0.shape[0], dtype=x.dtype, device=x.device)
    v = v0
    for _ in range(n_iter):
        # U-step: ridge LS  U = X V^T (V V^T + ridge I)^-1, columns projected
        # to the unit ball like sklearn's dictionary atoms, which pins the
        # scale so that alpha thresholds as the reference's does.
        g = v @ v.T + ridge * eye
        u = torch.linalg.solve(g.T, v @ x.T).T                 # [n, c]
        u = u / torch.clamp(torch.linalg.norm(u, dim=0, keepdim=True), min=1e-12)
        # V-step: FISTA on 1/2 ||X - U V||^2 + alpha ||V||_1, step 1 / the
        # exact Lipschitz constant (the top eigenvalue of the c x c U^T U)
        utu, utx = u.T @ u, u.T @ x
        step = 1.0 / max(float(torch.linalg.eigvalsh(utu)[-1]), 1e-6)
        vk, yk, tk = v, v, 1.0
        for _ in range(inner_steps):
            v_next = _soft(yk - step * (utu @ yk - utx), step * alpha)
            t_next = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * tk * tk))
            yk = v_next + ((tk - 1.0) / t_next) * (v_next - vk)
            vk, tk = v_next, t_next
        v = vk
    return v


class SPCAEstimator:
    def __init__(self, n_components: int, alpha: float = 10.0, device="cuda"):
        self.n_components = n_components
        self.device = require_device(device)
        self.whiten = False
        self.alpha = alpha  # higher alpha => sparser components
        self.batch_support = False
        self.stdev = np.zeros((n_components,), np.float32)
        self.total_var = 0.0
        self.mean_ = None
        self.components_ = None

    def get_param_str(self) -> str:
        return "spca_c{}_a{}{}".format(self.n_components, self.alpha,
                                       "_w" if self.whiten else "")

    def fit(self, x):
        with ieee_f32():
            self._fit(as_samples(x, self.device))
        check_orthogonality(self.components_, "SPCA")

    def _fit(self, x: torch.Tensor) -> None:
        mean = torch.mean(x, dim=0)
        # The data mean, as sklearn's SparsePCA records it (the JAX
        # estimator omits it, so its pipeline's mean_ check fails).
        self.mean_ = mean.cpu().numpy()[None, :]
        xc = x - mean
        _, v0 = gram_svd(xc, self.n_components)                 # PCA warm start
        comp = spca_alternate(xc, v0, float(self.alpha))
        del xc
        comp = comp / torch.clamp(torch.linalg.norm(comp, dim=-1, keepdim=True),
                                  min=1e-12)
        self.total_var = total_variance(x)
        # Sparse components are no orthogonal basis, so they are not ranked
        # by dot-product projections (reference estimators.py:187-189 uses
        # transform()): ridge-coded coordinates serve instead.
        g = comp @ comp.T + 0.01 * torch.eye(comp.shape[0], dtype=comp.dtype,
                                             device=comp.device)
        codes = torch.linalg.solve(g, comp @ x.T).T
        stdev = torch.std(codes, dim=0, correction=0).cpu().numpy()
        idx = np.argsort(stdev)[::-1]
        self.stdev = stdev[idx]
        self.components_ = comp.cpu().numpy()[idx]

    def get_components(self):
        var_ratio = self.stdev ** 2 / self.total_var
        return self.components_, self.stdev, var_ratio  # SPCA outputs are normalized
