"""Randomized-SVD PCA (``ganspace_tpu/estimators/rsvd.py``; reference
``FacebookPCAEstimator``, ``estimators.py:124-160``).

The reference wraps ``fbpca.pca(k, n_iter=2, raw=True, l=2k)``: a Gaussian
range finder with ``l = 2k`` probes and ``n_iter`` QR-stabilized power
iterations, then the exact SVD of the small projected matrix.  Every heavy
step is a dense [n, D]-sized IEEE float32 product on the estimator's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.estimators.pca import (
    as_samples, check_orthogonality, project_stdev_sort, total_variance)
from ganspace_tpu_torch.estimators.utils import gram_svd
from ganspace_tpu_torch.ops.precision import ieee_f32


def randomized_range(x: torch.Tensor, l: int, n_iter: int, seed: int = 0) -> torch.Tensor:
    """Orthonormal basis Q [n, l] approximating the range of x [n, D].

    Omega is the JAX package's: ``RandomState(seed).standard_normal((D, l))``
    on the host.  ``torch.linalg.qr`` may sign Q's columns otherwise than
    ``jnp.linalg.qr``; the caller's ``gram_svd`` fixes the final signs."""
    rs = np.random.RandomState(seed)
    omega = torch.from_numpy(rs.standard_normal((x.shape[1], l)).astype(np.float32))
    q, _ = torch.linalg.qr(x @ omega.to(x.device))
    for _ in range(n_iter):
        z, _ = torch.linalg.qr(x.T @ q)
        q, _ = torch.linalg.qr(x @ z)
    return q


class FacebookPCAEstimator:
    def __init__(self, n_components: int, n_iter: int = 2, seed: int = 0,
                 device="cuda"):
        self.n_components = n_components
        self.device = require_device(device)
        self.batch_support = False
        self.n_iter = n_iter
        self.l = 2 * n_components
        self.seed = seed
        self.stdev = np.zeros((n_components,), np.float32)
        self.total_var = 0.0
        self.mean_ = None
        self.components_ = None

    def get_param_str(self) -> str:
        return "fbpca_c{}_it{}_l{}".format(self.n_components, self.n_iter, self.l)

    def fit(self, x):
        with ieee_f32():
            x = as_samples(x, self.device)
            q = randomized_range(x, self.l, self.n_iter, self.seed)
            _, vt = gram_svd(q.T @ x, self.n_components)      # B = Q^T X [l, D]
            self.total_var = total_variance(x)
            self.components_, self.stdev = project_stdev_sort(vt, x)
            self.mean_ = torch.mean(x, dim=0, keepdim=True).cpu().numpy()
        check_orthogonality(self.components_, "FBPCA")

    def get_components(self):
        var_ratio = self.stdev ** 2 / self.total_var
        return self.components_, self.stdev, var_ratio
