"""Streaming PCA: the exact-moments tier of ``ganspace_tpu/estimators/ipca.py``.

For feature dims up to ``MOMENTS_MAX_D`` (the W/Z latent spaces) the
estimator keeps Chan-merged streaming moments -- count, mean and the
centered scatter M2 = sum (x - mu)(x - mu)^T -- and factorizes once at the
end, which is exact covariance PCA.  Each block costs one centered Gram,
computed by the CUDA kernel of ``ops/moments.py`` with mu the block mean.

The Nystrom sketch tier and the sklearn-mirror tier (D > MOMENTS_MAX_D, the
conv taps) are not ported yet (ROADMAP.md, queue 1: the Nystrom / conv-tap tier).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ganspace_tpu_torch.estimators.utils import svd_flip_vt, topk_eigh_desc
from ganspace_tpu_torch.ops.moments import centered_gram

_NOT_FINITE = ("non-finite moment statistics: the activation stream contains "
               "NaN/Inf, so the factorization is refused")


class MomentsState(NamedTuple):
    count: float           # samples absorbed
    mean: torch.Tensor     # [D]
    m2: torch.Tensor       # [D, D] centered scatter sum (x-mu)(x-mu)^T


def moments_update(state: MomentsState, x: torch.Tensor) -> MomentsState:
    """One block of Chan-stable streaming moments: one centered Gram (the
    CUDA kernel on the card), no eigh."""
    n = float(x.shape[0])
    batch_mean = torch.mean(x, dim=0)
    gram = centered_gram(x, batch_mean)
    new_count = state.count + n
    delta = batch_mean - state.mean
    new_mean = state.mean + delta * (n / new_count)
    new_m2 = state.m2 + gram + torch.outer(delta, delta) * (state.count * n / new_count)
    return MomentsState(new_count, new_mean, new_m2)


def proj_variance(state: MomentsState, dirs: torch.Tensor) -> torch.Tensor:
    """Population variance of the stream's projections onto the rows of
    ``dirs`` [k, D], exact from the scatter: Var(d.x) = d M2 d / n."""
    return torch.sum((dirs @ state.m2) * dirs, dim=1) / state.count


def moments_finish(state: MomentsState, n_components: int):
    """(components [c, D], stdev [c], var_ratio [c]) from the moments."""
    cov = state.m2 / max(state.count - 1.0, 1.0)
    evals, evecs = topk_eigh_desc(cov)
    evals = torch.clamp(evals, min=0.0)
    comp = svd_flip_vt(evecs[:, :n_components].T)
    var_ratio = evals[:n_components] / torch.clamp(torch.sum(evals), min=1e-30)
    return comp, torch.sqrt(evals[:n_components]), var_ratio


def moments_finish_bundle(state: MomentsState, n_components: int):
    """Components plus a [3, c] stats pack: stdev, var_ratio and lat_stdev
    (the exact full-stream projection stdev of the unit-row components,
    which in W space is the latent stdev)."""
    comp, stdev, ratio = moments_finish(state, n_components)
    pv = proj_variance(state, comp)
    return comp, torch.stack([stdev, ratio, torch.sqrt(torch.clamp(pv, min=0.0))])


class IPCAEstimator:
    """Exact-moments tier of ``ganspace_tpu.estimators.IPCAEstimator``.

    State lives on the device of the first block it is given."""

    #: feature dims up to this use the exact-moments tier
    MOMENTS_MAX_D = 8192

    def __init__(self, n_components: int):
        self.n_components = n_components
        self.batch_support = True
        self.n_samples_seen_ = 0
        self._moments: Optional[MomentsState] = None

    def get_param_str(self) -> str:
        return f"ipca_c{self.n_components}"   # the reference never whitens

    def _require_moments(self) -> MomentsState:
        if self._moments is None or self._moments.count == 0.0:
            raise RuntimeError("IPCAEstimator: no samples fitted yet")
        if not bool(torch.isfinite(self._moments.m2).all()):
            raise FloatingPointError(_NOT_FINITE)
        return self._moments

    def fit_partial(self, x) -> bool:
        x = torch.as_tensor(x, dtype=torch.float32)
        n, d = x.shape
        if n < self.n_components:
            print(f"\nIPCA error: n_samples={n} < n_components={self.n_components}")
            return False
        if d > self.MOMENTS_MAX_D:
            raise NotImplementedError(
                f"IPCA on D={d} > {self.MOMENTS_MAX_D} needs the Nystrom sketch "
                "tier, not yet ported (ROADMAP.md, queue 1)")
        if self._moments is None:
            self._moments = MomentsState(
                0.0, torch.zeros((d,), dtype=torch.float32, device=x.device),
                torch.zeros((d, d), dtype=torch.float32, device=x.device))
        self._moments = moments_update(self._moments, x)
        self.n_samples_seen_ += n
        return True

    @property
    def mean_(self) -> np.ndarray:
        return self._moments.mean.cpu().numpy()

    def get_components(self):
        """(components [c, D], stdev [c], var_ratio [c]) as numpy."""
        comp, stdev, var_ratio = moments_finish(self._require_moments(),
                                                self.n_components)
        return comp.cpu().numpy(), stdev.cpu().numpy(), var_ratio.cpu().numpy()

    def finish_latent_bundle(self):
        """Samples-are-latents finish: ``(components [c, D] on the device,
        stats np [3, c])`` with rows (stdev, var_ratio, lat_stdev)."""
        comp, stats = moments_finish_bundle(self._require_moments(),
                                            self.n_components)
        return comp, stats.cpu().numpy()

    def projected_variance(self, dirs) -> np.ndarray:
        """Exact population variance of the full stream's projections onto
        ``dirs`` [k, D]."""
        state = self._require_moments()
        dirs = torch.as_tensor(dirs, dtype=torch.float32, device=state.m2.device)
        return proj_variance(state, dirs).cpu().numpy()
