"""One 3xTF32 tensor-core step (``csrc/tf32x3.cuh``) on a 16 x 8 x 8 tile.

Both kernels build their products from this step; :func:`tile_3xtf32`
runs it alone so that its fragment layouts can be checked against the
plain product on the card.  A CPU tensor takes the plain version."""

from __future__ import annotations

import torch

from ganspace_tpu_torch.ops._build import check, load_kernels, stream_handle


def tile_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in float32: the CPU path and the step's oracle."""
    return a @ b.T


def tile_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [16, 8] @ b[8, 8].T through one m16n8k8 3xTF32 step."""
    if a.shape != (16, 8) or b.shape != (8, 8):
        raise ValueError(f"tile_3xtf32: a must be [16, 8] and b [8, 8], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return tile_3xtf32_plain(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32 or b.device != a.device:
        raise TypeError("tile_3xtf32: operands must be float32 on one CUDA device")
    a, b = a.contiguous(), b.contiguous()
    d = torch.empty((16, 8), dtype=torch.float32, device=a.device)
    check(load_kernels().ganspace_tf32x3_tile(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                              stream_handle(a)),
          "tile_3xtf32")
    return d


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x`` as the kernels split it (``tf32x3::split``):
    hi = tf32(x), rounded to nearest with ties away from zero on the
    magnitude bits, lo = tf32(x - hi); x = hi + lo to float32 rounding."""
    def to_tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def sw128_image(b: torch.Tensor) -> torch.Tensor:
    """b [..., N, 32] (N a multiple of 8, K = 32 contiguous) as tf32
    ``wgmma`` reads a K-major tile in the 128-byte swizzle
    (``csrc/wgmma_tf32.cuh``), flat [..., N * 32]: row n at 128 bytes, its
    16-byte chunk j at chunk j ^ (n % 8), eight rows to a 1024-byte atom."""
    n = b.shape[-2]
    if b.shape[-1] != 32 or n % 8:
        raise ValueError(f"sw128_image: b must be [..., 8m, 32], got {tuple(b.shape)}")
    rows = torch.arange(n, device=b.device)[:, None]
    col = torch.arange(32, device=b.device)[None, :]
    # the swizzle is its own inverse, so the gather uses the scatter's index
    index = (rows * 32 + ((col // 4) ^ (rows % 8)) * 4 + col % 4).reshape(-1)
    return b.reshape(*b.shape[:-2], n * 32).index_select(-1, index)


def wgmma_tile_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [64, 32] @ b [N, 32].T (N = 128 or 144) through four k8 steps of
    the 3xTF32 ``wgmma`` product of the stride-2 kernel, B split on the host
    and read from its swizzled image.  A CPU tensor takes the plain product."""
    if a.shape != (64, 32) or b.ndim != 2 or b.shape[1] != 32 or b.shape[0] not in (128, 144):
        raise ValueError(f"wgmma_tile_3xtf32: a must be [64, 32] and b [128 or 144, 32], "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return tile_3xtf32_plain(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32 or b.device != a.device:
        raise TypeError("wgmma_tile_3xtf32: operands must be float32 on one CUDA device")
    hi, lo = split_tf32(b)
    b_hi, b_lo = sw128_image(hi), sw128_image(lo)
    a = a.contiguous()
    d = torch.empty((64, b.shape[0]), dtype=torch.float32, device=a.device)
    check(load_kernels().ganspace_wgmma_tile(a.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(),
                                             d.data_ptr(), b.shape[0], stream_handle(a)),
          "wgmma_tile_3xtf32")
    return d
