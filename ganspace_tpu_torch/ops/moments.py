"""Centered Gram ``(X - mu)^T (X - mu)``: CUDA kernel and plain version.

Counterpart of ``ganspace_tpu/ops/pallas/moments.py::centered_gram``.  The
kernel (``csrc/centered_gram.cu``) runs on the tensor cores in 3xTF32 and
centers X on its way from shared memory to the fragments, so no centered
copy of X is written.  A CPU tensor takes the plain
PyTorch version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ganspace_tpu_torch.ops._build import check, load_kernels, stream_handle


def centered_gram_plain(x: torch.Tensor, mu: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle."""
    x = x.to(torch.float32)
    if mu is None:
        mu = x.mean(dim=0)
    xc = x - mu.to(torch.float32).reshape(1, -1)
    return xc.T @ xc


def centered_gram(x: torch.Tensor, mu: torch.Tensor | None = None) -> torch.Tensor:
    """(X - mu)^T (X - mu) for X [N, D] float32; mu defaults to the column mean."""
    if x.ndim != 2:
        raise ValueError(f"centered_gram: x must be [N, D], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return centered_gram_plain(x, mu)
    if x.device.type != "cuda":
        raise ValueError(f"centered_gram: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"centered_gram: x must be float32, got {x.dtype}")
    n, d = x.shape
    # the kernel counts rows and columns in int (with a stage of headroom
    # for the per-rank rounding) and addresses X and G in 64 bits
    if max(n, d) > 2 ** 31 - 2 ** 10:
        raise ValueError(f"centered_gram: {n} x {d} exceeds the kernel's int row count")
    x = x.contiguous()
    if mu is None:
        mu = x.mean(dim=0)
    if mu.shape != (d,) or mu.dtype != torch.float32 or mu.device != x.device:
        raise ValueError("centered_gram: mu must be float32 [D] on x's device")
    mu = mu.contiguous()
    g = torch.empty((d, d), dtype=torch.float32, device=x.device)
    lib = load_kernels()
    check(lib.ganspace_centered_gram(x.data_ptr(), mu.data_ptr(), g.data_ptr(),
                                     n, d, stream_handle(x)),
          "centered_gram")
    centered_gram.launches += 1
    return g


#: kernel launches since the last reset (CPU calls do not count)
centered_gram.launches = 0
