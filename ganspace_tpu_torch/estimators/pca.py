"""Exact full PCA (``ganspace_tpu/estimators/pca.py``; reference
``PCAEstimator``, ``estimators.py:84-118``).

The reference runs sklearn ``PCA(svd_solver='full')`` on the whole centered
sample matrix, then re-ranks the components by projected stdev.  Here: the
SVD through the smaller Gram, on the estimator's device.  On the card a
sample-dominant matrix of 512 to 8192 columns takes its Gram from kernel A
(``covariance``: ``ops/moments.centered_gram``, one launch over all rows, no
centered copy), where the JAX package takes its Pallas kernel on the TPU.
``batch_support=False``: the pipeline hands over the whole matrix at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.estimators.utils import gram_svd, svd_flip_vt, topk_eigh_desc
from ganspace_tpu_torch.ops.moments import centered_gram
from ganspace_tpu_torch.ops.precision import ieee_f32


def use_kernel_gram(n: int, d: int, device: torch.device) -> bool:
    """Kernel A for the Gram: the JAX package's rule for its Pallas kernel
    (``pca.py:20-24``: n >= d, 512 <= d <= 8192) with the card in place of
    the TPU."""
    return device.type == "cuda" and n >= d and 512 <= d <= 8192


def covariance(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """``(x - mean)^T (x - mean)`` [D, D]: one kernel-A launch over all rows
    where ``use_kernel_gram`` holds, else the product of the centered copy.
    PCA's Gram and ICA's whitening covariance both come from here."""
    n, d = x.shape
    if use_kernel_gram(n, d, x.device):
        return centered_gram(x, mean)
    xc = x - mean
    return xc.T @ xc


def as_samples(x, device: torch.device) -> torch.Tensor:
    """The sample matrix as float32 on ``device`` (no copy when it is one)."""
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def project_stdev_sort(components: torch.Tensor, x: torch.Tensor):
    """Projected stdevs and the descending re-rank (reference
    ``estimators.py:100-106``): ``(components np [c, D], stdev np [c])``."""
    stdev = torch.std(components @ x.T, dim=1, correction=0).cpu().numpy()
    idx = np.argsort(stdev)[::-1]
    return components.cpu().numpy()[idx], stdev[idx]


def check_orthogonality(components: np.ndarray, label: str) -> None:
    m = components @ components.T
    off = m - np.eye(m.shape[0]) * np.diag(m)
    if not np.allclose(off, 0, atol=1e-4):
        print(f"{label} components not orthogonal, max dot {np.abs(off).max()}")


def total_variance(x: torch.Tensor) -> float:
    return float(torch.sum(torch.var(x, dim=0, correction=0)))


class PCAEstimator:
    def __init__(self, n_components: int, device="cuda"):
        self.n_components = n_components
        self.device = require_device(device)
        self.solver = "full"
        self.batch_support = False
        self.stdev = np.zeros((n_components,), np.float32)
        self.total_var = 0.0
        self.mean_ = None
        self.components_ = None

    def get_param_str(self) -> str:
        return f"pca-{self.solver}_c{self.n_components}"

    def fit(self, x):
        with ieee_f32():
            x = as_samples(x, self.device)
            n, d = x.shape
            mean = torch.mean(x, dim=0)
            if n >= d:      # gram_svd's [D, D] side, the Gram from covariance
                _, v = topk_eigh_desc(covariance(x, mean))
                vt = svd_flip_vt(v[:, :self.n_components].T)
            else:
                _, vt = gram_svd(x - mean, self.n_components)
            # Save the variance for later; rank by projected stdev
            # (reference estimators.py:94-106).
            self.total_var = total_variance(x)
            self.components_, self.stdev = project_stdev_sort(vt, x)
        check_orthogonality(self.components_, "PCA")
        self.mean_ = mean.cpu().numpy()[None, :]

    def get_components(self):
        var_ratio = self.stdev ** 2 / self.total_var
        return self.components_, self.stdev, var_ratio
