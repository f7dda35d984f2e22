"""Shared numerical helpers for the estimators (``ganspace_tpu/estimators/utils.py``)."""

from __future__ import annotations

import torch


def svd_flip_vt(vt: torch.Tensor) -> torch.Tensor:
    """Deterministic signs from the rows of V^T, as sklearn's
    ``svd_flip(u_based_decision=False)``: each component is flipped so its
    largest-|.| coordinate is positive."""
    idx = torch.argmax(torch.abs(vt), dim=1)
    signs = torch.sign(torch.gather(vt, 1, idx[:, None]))
    return vt * signs


def topk_eigh_desc(g: torch.Tensor):
    """eigh of a symmetric PSD float32 matrix, ALL eigenpairs descending,
    returned in float32.

    The factorization itself runs in float64 on g's device: on an H100 the
    float32 CUDA solver returned W-space eigenvectors orthonormal only to
    2.6e-4 (D = 512, c = 80), where the float32 CPU solver reaches 1e-6; in
    float64 the D x D solve costs milliseconds and the float32 rows are
    orthonormal to rounding."""
    evals, evecs = torch.linalg.eigh(g.to(torch.float64))
    return (torch.flip(evals, (0,)).to(g.dtype),
            torch.flip(evecs, (1,)).to(g.dtype))


def gram_svd(m: torch.Tensor, n_keep: int):
    """Top-``n_keep`` singular triplets of ``m`` [k, D] via the smaller Gram.

    One k x D @ D x k (or D x k @ k x D) product, then the eigh of the
    min(k, D)-sized Gram.  Returns (s [n_keep], vt [n_keep, D]) with
    sklearn's Vt-based signs.  Only the dominant triplets are consumed, so
    the squared condition number of the Gram costs nothing that is read.
    Callers run it under ``ops/precision.ieee_f32`` (TF32 off)."""
    k, d = m.shape
    if k <= d:
        evals, u = topk_eigh_desc(m @ m.T)                    # [k, k]
        s_k = torch.sqrt(torch.clamp(evals, min=0.0))[:n_keep]
        vt = (u[:, :n_keep].T @ m) / torch.clamp(s_k, min=1e-30)[:, None]
    else:
        evals, v = topk_eigh_desc(m.T @ m)                    # [D, D]
        s_k = torch.sqrt(torch.clamp(evals, min=0.0))[:n_keep]
        vt = v[:, :n_keep].T
    return s_k, svd_flip_vt(vt)
