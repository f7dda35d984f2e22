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
