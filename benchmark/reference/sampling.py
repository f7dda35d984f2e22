"""The latent streams a fit draws, re-derived from the seed by the rule the
program documents: block ``i`` of stream ``s`` under seed ``k`` comes from
its own generator, seeded with the SplitMix64 finalizer of the packed word
``(s << 62) | (k << 31) | i`` (all 64 bits on the card's Philox, the xor of
the two halves on the CPU's mt19937).  StyleGAN2 draws a standard normal
block, BigGAN ``truncation * TruncNormal(-2, 2)`` by ``trunc_normal_``."""

from __future__ import annotations

import numpy as np
import torch

STREAM_MAIN = 0
_MASK64 = (1 << 64) - 1
INT32_MAX = 2**31 - 1


def _mix64(v: int) -> int:
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _MASK64
    return v ^ (v >> 31)


def block_generator(seed: int, stream: int, i: int, device) -> torch.Generator:
    if not (0 <= seed <= INT32_MAX and 0 <= i <= INT32_MAX and 0 <= stream < 4):
        raise ValueError(f"block {i} of stream {stream} under seed {seed}: out of range")
    s = _mix64((stream << 62) | (seed << 31) | i)
    device = torch.device(device)
    if device.type == "cpu":
        s = (s ^ (s >> 32)) & 0xFFFFFFFF
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    return gen


def gaussian_block(seed: int, i: int, n: int, dim: int, device) -> torch.Tensor:
    gen = block_generator(seed, STREAM_MAIN, i, device)
    return torch.randn((n, dim), generator=gen, dtype=torch.float32, device=gen.device)


def truncated_block(seed: int, i: int, n: int, dim: int, truncation: float,
                    device) -> torch.Tensor:
    gen = block_generator(seed, STREAM_MAIN, i, device)
    t = torch.empty((n, dim), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return truncation * t


def host_gaussian(seed: int, dim: int) -> np.ndarray:
    """One latent as the host stream draws it for a given seed:
    ``RandomState(seed).standard_normal(dim)`` in float32, [1, dim]."""
    return np.random.RandomState(seed).standard_normal(dim).astype(np.float32)[None]
