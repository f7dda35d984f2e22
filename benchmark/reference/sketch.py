"""Plain streaming PCA by the Nystrom sketch, and the latent regression
from the fit's cross-moments: the decomposition a conv-tap fit makes.

The published method (Tropp et al., "Fixed-rank approximation of a
positive-semidefinite matrix from streaming data", NeurIPS 2017) with the
choices the program documents for its sketch tier:

* a Gaussian test matrix Omega [D, l], l = min(max(4c, c + 32), D), drawn by
  the CPU generator seeded 0xA5;
* one pass accumulates Y = sum x x^T Omega, sum x, sum |x|^2, and for the
  regression sum x z^T and sum z;
* the centered sketch Yc = Y - n mu (mu^T Omega), the whitening
  W = (Omega^T Yc)^(-1/2) with eigenvalues under l * eps_f32 of the largest
  dropped, F = Yc W, and the eigenpairs (e, v) of F^T F, descending;
* a second pass with Omega replaced by the orthonormal range
  F v e^(-1/2), unless the first leaves at most 1.2% of the centered energy
  unresolved and no relative gap among the top c + 1 eigenvalues is under
  2%;
* components u_i = F v_i e_i^(-1/2), explained variance e_i / (n - 1), its
  ratio to the total centered energy / (n - 1);
* latent directions: the rows v_i (sum x z^T - mu sum z^T), normalized.

Products run in float32 (IEEE, or TF32 for the control); the sums over
blocks and everything after them in float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from benchmark.reference import ieee

REFINE_TAIL_FRAC = 0.012
REFINE_MIN_GAP = 0.02
F32_EPS = float(np.finfo(np.float32).eps)


def test_matrix(d: int, l: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(0xA5)
    return torch.randn(d, l, generator=gen, dtype=torch.float32)


def sketch_size(c: int, d: int) -> int:
    return min(max(4 * c, c + 32), d)


@dataclass
class Sums:
    n: int
    y: torch.Tensor      # [D, l] float64
    s: torch.Tensor      # [D] float64
    sq: float
    xz: torch.Tensor     # [D, zdim] float64
    zs: torch.Tensor     # [zdim] float64


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    torch.distributed.all_reduce(t)
    return t


def stream(blocks: Callable[[int], tuple], n_blocks: int, omega: torch.Tensor,
           share=(0, 1)) -> Sums:
    """One pass over ``blocks(i) -> (x [b, D], z [b, zdim])`` float32; with
    ``share = (rank, world)`` over every world-th block from ``rank``, the
    sums then added up over the process group."""
    rank, world = share
    acc = None
    for i in range(rank, n_blocks, world):
        x, z = blocks(i)
        xo = x @ omega
        parts = (x.T @ xo, torch.sum(x, dim=0), torch.sum(x.double() ** 2), x.T @ z,
                 torch.sum(z, dim=0))
        parts = [p.double() for p in parts]
        if acc is None:
            acc = [0, *[torch.zeros_like(p) for p in parts]]
        acc[0] += x.shape[0]
        for k, p in enumerate(parts):
            acc[k + 1] += p
    if world > 1:
        n = _all_reduce(torch.tensor([float(acc[0])], dtype=torch.float64,
                                     device=omega.device))
        acc = [int(n.item()), *[_all_reduce(t) for t in acc[1:]]]
    n, y, s, sq, xz, zs = acc
    return Sums(n, y, s, float(sq), xz, zs)


def _pinv_sqrt(m: np.ndarray) -> np.ndarray:
    e, v = np.linalg.eigh(m)
    keep = e > m.shape[0] * F32_EPS * max(float(e[-1]), 0.0)
    vk = v[:, keep]
    return (vk / np.sqrt(e[keep])) @ vk.T


def _floor_scale(e: np.ndarray) -> np.ndarray:
    emax = max(float(e[0]), 0.0) if e.size else 0.0
    return np.where(e > emax * 1e-12, 1.0 / np.sqrt(np.maximum(e, 1e-300)), 0.0)


@dataclass
class Factor:
    f: torch.Tensor      # [D, l] float64
    e: np.ndarray        # descending
    v: np.ndarray
    total: float
    mu: torch.Tensor     # [D] float64


def factor(sm: Sums, omega: torch.Tensor) -> Factor:
    om = omega.double()
    mu = sm.s / sm.n
    yc = sm.y - sm.n * torch.outer(mu, mu @ om)
    m = (om.T @ yc).cpu().numpy()
    w = _pinv_sqrt(0.5 * (m + m.T))
    f = yc @ torch.from_numpy(w).to(yc)
    g = (f.T @ f).cpu().numpy()
    e, v = np.linalg.eigh(0.5 * (g + g.T))
    total = sm.sq - sm.n * float(torch.sum(mu * mu))
    return Factor(f, e[::-1].copy(), v[:, ::-1].copy(), total, mu)


def wants_refine(fa: Factor, c: int) -> bool:
    ev = np.maximum(fa.e, 1e-30)
    tail = max(fa.total - float(ev.sum()), 0.0) / max(fa.total, 1e-30)
    hi = min(min(c, len(ev)) + 1, len(ev))
    gap = float(np.min(1.0 - ev[1:hi] / ev[:hi - 1])) if hi > 1 else 1.0
    return not (tail <= REFINE_TAIL_FRAC and gap >= REFINE_MIN_GAP)


@dataclass
class Fit:
    n: int
    mean: torch.Tensor        # [D] float64
    comp: torch.Tensor        # [c, D] float64, unit rows
    explained: np.ndarray     # [c]
    ratio: np.ndarray         # [c]
    lat_comp: torch.Tensor    # [c, zdim] float64, unit rows
    f: torch.Tensor           # [D, l]: the fitted operator C = F F^T / (n - 1)
    k: torch.Tensor           # [D, zdim]: sum (x - mu) z^T
    refined: bool


def fit(blocks: Callable[[int], tuple], n_blocks: int, c: int, d: int, device,
        tf32: bool = False, refine: Optional[bool] = None, share=(0, 1)) -> Fit:
    """The decomposition of ``n_blocks`` blocks; ``refine`` None follows the
    policy above, True / False force the second pass or skip it.  ``share``
    (rank, world): the blocks split over a process group, every rank ending
    with the same sums and so the same fit."""
    with torch.no_grad(), ieee(tf32):
        omega = test_matrix(d, sketch_size(c, d)).to(device)
        sm = stream(blocks, n_blocks, omega, share)
        fa = factor(sm, omega)
        refined = wants_refine(fa, c) if refine is None else refine
        if refined:
            q = (fa.f @ torch.from_numpy(fa.v * _floor_scale(fa.e)[None, :]).to(fa.f)).float()
            del fa
            sm = stream(blocks, n_blocks, q, share)
            fa = factor(sm, q)
        ec = fa.e[:c]
        u = fa.f @ torch.from_numpy(fa.v[:, :c] * _floor_scale(ec)[None, :]).to(fa.f)
        comp = u.T.contiguous()
        denom = max(sm.n - 1.0, 1.0)
        explained = np.maximum(ec, 0.0) / denom
        ratio = explained / max(fa.total / denom, 1e-30)
        k = sm.xz - torch.outer(fa.mu, sm.zs)
        lat = comp @ k
        lat = lat / torch.linalg.norm(lat, dim=1, keepdim=True).clamp_min(1e-30)
        return Fit(sm.n, fa.mu, comp, explained, ratio, lat, fa.f, k, refined)


def judge(ref: Fit, mean, comp, stdev, ratio, lat_comp) -> dict:
    """The program's outputs against the reference fit, four numbers:

    * ``mean``: |mean - mean_ref| / |mean_ref|;
    * ``var_ratio``: the largest relative gap of a variance ratio;
    * ``eig_residual``: max_i |C v_i - stdev_i^2 v_i| / lambda_1 with C the
      reference's fitted covariance operator and v_i the program's unit
      components: how far each is from an eigenpair of it (first order in
      any error, and blind to a rotation inside a cluster of equal
      eigenvalues);
    * ``lat_comp``: max_i |l_i - normalize(v_i K)|, the program's latent
      directions against its own components regressed on the reference's
      cross-moments K (the sign follows v_i)."""
    dev = ref.f.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev)

    c = ref.comp.shape[0]
    mean, comp, lat_comp = t(mean).reshape(-1), t(comp).reshape(c, -1), t(lat_comp).reshape(c, -1)
    stdev, ratio = np.asarray(stdev, np.float64), np.asarray(ratio, np.float64)
    out = {"mean": float(torch.linalg.norm(mean - ref.mean) / torch.linalg.norm(ref.mean))}
    out["var_ratio"] = float(np.max(np.abs(ratio - ref.ratio) / np.maximum(ref.ratio, 1e-300)))
    cv = (comp @ ref.f) @ ref.f.T / max(ref.n - 1.0, 1.0)
    res = torch.linalg.norm(cv - t(stdev ** 2)[:, None] * comp, dim=1)
    out["eig_residual"] = float(torch.max(res)) / float(ref.explained[0])
    want = comp @ ref.k
    want = want / torch.linalg.norm(want, dim=1, keepdim=True).clamp_min(1e-30)
    out["lat_comp"] = float(torch.max(torch.linalg.norm(lat_comp - want, dim=1)))
    return out
