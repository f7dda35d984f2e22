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
