"""The Nystrom sketch's block update on the card (``csrc/sketch_update.cu``).

``y' = y + x^T (x Omega)``, ``s' = s + sum_rows x``, ``sq' = sq + sum x^2``
for x [n, D] and Omega [D, l], the products in 3xTF32 on ``wgmma``.  Here
is what the kernel pair reads and how its work is cut: Omega's operand image
(:func:`omega_image`, made once per Omega by the caller), the tiling, chosen
from (n, D, l) and the card's SM count alone (:func:`tiling`), and the
launch (:func:`sketch_update`).  The plain version and the dispatch on the
device are ``estimators/ipca.nystrom_update_plain`` and ``nystrom_update``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ganspace_tpu_torch.ops._build import check, load_kernels, stream_handle
from ganspace_tpu_torch.ops.tf32x3 import split_tf32, sw128_image

KM = 128            # rows of a unit (two warpgroups of 64)
KC = 32             # K of a stage
KN = 160            # columns of a unit (csrc/sketch_update.cu's kN)
#: a unit's pipeline fill and epilogue, in stages: the price of a K split
UNIT_OVERHEAD = 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class SketchTiling(NamedTuple):
    n_nt: int        # column tiles of KN over l
    splits: int      # kernel 1's ranges of K = D
    per_split: int   # 32-deep stages of one range (the last may be shorter)


@functools.lru_cache(maxsize=64)
def tiling(n: int, d: int, l: int, sms: int) -> SketchTiling:
    """Kernel 1 (``x Omega``) has ceil(n / 128) x ceil(l / 160) units; where
    they are too few for ``sms`` blocks, K = D is split into ranges, as many
    as minimize waves x (stages of a range + :data:`UNIT_OVERHEAD`), the
    fewest on a tie.  Kernel 2 (``x^T P``) never splits: its units own a
    D tile for all of n."""
    n_nt, chunks = _cdiv(l, KN), _cdiv(d, KC)
    base = n_nt * _cdiv(n, KM)
    best = None
    for want in range(1, chunks + 1):
        per = _cdiv(chunks, want)
        splits = _cdiv(chunks, per)
        cost = _cdiv(base * splits, sms) * (per + UNIT_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return SketchTiling(n_nt, best[1], best[2])


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def omega_image_plain(omega: torch.Tensor) -> torch.Tensor:
    """Kernel 1's B operand: Omega^T [l, D], zero-padded to whole column
    tiles and 32-deep stages, split into TF32 hi and lo (``split_tf32``),
    each [160, 32] tile in the swizzle wgmma reads (``sw128_image``):
    [ceil(l / 160), ceil(D / 32), 2 (hi, lo), 160 * 32], contiguous.  The
    oracle of the card's image kernel; kernel 2's P image
    has the same layout (P^T over n)."""
    d, l = omega.shape
    n_nt, chunks = _cdiv(l, KN), _cdiv(d, KC)
    ot = torch.zeros((n_nt * KN, chunks * KC), dtype=torch.float32, device=omega.device)
    ot[:l, :d] = omega.T
    hi, lo = split_tf32(ot.reshape(n_nt, KN, chunks, KC).transpose(1, 2))
    return sw128_image(torch.stack((hi, lo), dim=2)).contiguous()


def omega_image(omega: torch.Tensor) -> torch.Tensor:
    """:func:`omega_image_plain` of float32 ``omega`` [D, l] on a CUDA
    device, made by ``csrc/sketch_update.cu``'s image kernel in one launch."""
    if omega.ndim != 2 or omega.dtype != torch.float32 or omega.device.type != "cuda":
        raise ValueError(f"omega_image: Omega must be float32 [D, l] on a CUDA device, got "
                         f"{omega.dtype} {tuple(omega.shape)} on {omega.device}")
    d, l = omega.shape
    omega = omega.contiguous()
    img = torch.empty((_cdiv(l, KN), _cdiv(d, KC), 2, KN * KC), dtype=torch.float32,
                      device=omega.device)
    check(load_kernels().ganspace_sketch_omega_image(omega.data_ptr(), img.data_ptr(), d, l,
                                                     stream_handle(omega)),
          "omega_image")
    return img


def sketch_update(x: torch.Tensor, image: torch.Tensor, y: torch.Tensor, s: torch.Tensor,
                  sq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y + x^T (x Omega), s + sum_rows x, sq + sum x^2)`` as new tensors,
    for ``image = omega_image(Omega)``; every operand float32, contiguous,
    on the current CUDA device (``estimators/ipca.nystrom_update`` checks
    them).  One call launches the pair, and counts one in ``.launches``."""
    n, d = x.shape
    l = y.shape[1]
    t = tiling(n, d, l, _sms(x.device.index))
    n_mt, chunks2 = _cdiv(n, KM), _cdiv(n, KC)
    if image.shape != (t.n_nt, _cdiv(d, KC), 2, KN * KC):
        raise ValueError(f"sketch_update: Omega's image {tuple(image.shape)} does not fit "
                         f"D = {d}, l = {l}")
    f32 = dict(dtype=torch.float32, device=x.device)
    y_out, s_out, sq_out = torch.empty_like(y), torch.empty_like(s), torch.empty_like(sq)
    part = torch.empty((t.splits, n_mt * KM, t.n_nt * KN), **f32)
    pimg = torch.empty((t.n_nt, chunks2, 2, KN * KC), **f32)
    sqpart = torch.empty((n_mt * t.splits,), **f32)
    check(load_kernels().ganspace_sketch_update(
        x.data_ptr(), image.data_ptr(), y.data_ptr(), s.data_ptr(), sq.data_ptr(),
        y_out.data_ptr(), s_out.data_ptr(), sq_out.data_ptr(), part.data_ptr(),
        pimg.data_ptr(), sqpart.data_ptr(), n, d, l, KN, t.splits, stream_handle(x)),
        "sketch_update")
    sketch_update.launches += 1
    return y_out, s_out, sq_out


#: launches of the kernel pair since the last reset (CPU calls do not count)
sketch_update.launches = 0
