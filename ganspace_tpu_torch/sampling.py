"""Latent sampling: the JAX package's host stream bit for bit, and the
device streams.

Counterpart of ``ganspace_tpu/sampling.py``.  **Host stream**
(``GANSPACE_DEVICE_RNG=0``): every seedless ``sample_latent`` call first
draws ``seed = randint(int32_max)`` from a seeded stream (``SeedStream``; the
JAX package uses numpy's global state for the same sequence), then samples
``RandomState(seed).standard_normal(dim * n)``.

**Device streams** (the default): block ``i`` of a named stream is drawn
from its own generator, :func:`block_generator` ``(seed, stream, i)``, the
counterpart of ``jax.random.fold_in(PRNGKey(seed), i)``.  A block depends
only on (seed, stream, i, shape): never on the chunking or on earlier draws,
so a refine pass regenerates the first pass's samples.  On the card the
generator is Philox; on the CPU it is torch's CPU generator.  Neither gives
threefry's values, and the two differ from each other: device streams are
compared only statistically.

Seed map (reference ``decomposition.py:34-37``):
  SAMPLING=1, RANDOM_DIRS=2, LINREG=3, VISUALIZATION=5.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

SEED_SAMPLING = 1
SEED_RANDOM_DIRS = 2
SEED_LINREG = 3
SEED_VISUALIZATION = 5

#: The device streams, by name (the JAX package's key in parentheses):
#: the fit stream (``PRNGKey(config.seed or SEED_SAMPLING)``), the fused W
#: stream's remainder blocks (``PRNGKey(seed + 1_000_003)``), the regression
#: stream (``PRNGKey(SEED_LINREG)``) and the random baseline directions
#: (``PRNGKey(SEED_RANDOM_DIRS)``).
STREAM_MAIN, STREAM_W_TAIL, STREAM_LINREG, STREAM_RAND_DIRS = range(4)

_INT32_MAX = np.iinfo(np.int32).max
_MASK64 = (1 << 64) - 1


def _mix64(v: int) -> int:
    """The SplitMix64 finalizer: a bijection of 64-bit words."""
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _MASK64
    return v ^ (v >> 31)


def block_seed(seed: int, stream: int, i: int) -> int:
    """The 64-bit generator seed of block ``i`` of ``stream`` under ``seed``.

    (stream, seed, i) packs into 2 + 31 + 31 bits and goes through a
    bijection, so no two blocks of any streams share a seed."""
    if not (stream in range(4) and 0 <= seed <= _INT32_MAX and 0 <= i <= _INT32_MAX):
        raise ValueError(f"block_seed: stream {stream}, seed {seed}, block {i} "
                         f"out of range")
    return _mix64((stream << 62) | (seed << 31) | i)


def block_generator(seed: int, stream: int, i: int, device) -> torch.Generator:
    """A fresh generator on ``device`` for block ``i`` of ``stream``.

    Philox on the card takes all 64 bits of :func:`block_seed`.  The CPU
    generator (mt19937) keeps only 32 bits of any seed, so it is seeded with
    the xor of the two halves: on the CPU two blocks can share a stream
    with probability about k^2 / 2^33 among k blocks."""
    device = torch.device(device)
    s = block_seed(seed, stream, i)
    if device.type == "cpu":
        s = (s ^ (s >> 32)) & 0xFFFFFFFF
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    return gen


def device_gaussian(gen: torch.Generator, n: int, dim: int) -> torch.Tensor:
    """An [n, dim] float32 standard-normal draw on ``gen``'s device."""
    return torch.randn((n, dim), generator=gen, dtype=torch.float32,
                       device=gen.device)


class SeedStream:
    """A seeded stand-in for numpy's global RandomState.

    ``np.random.seed(s); np.random.randint(int32_max)`` draws the same values
    as ``RandomState(s).randint(int32_max)``, so this reproduces the JAX
    package's seed sequence exactly without touching global state.  ``None``
    seeds from the OS, like an unseeded global stream."""

    def __init__(self, seed: Optional[int] = None):
        self._rs = np.random.RandomState(seed)

    def next_seed(self) -> int:
        return int(self._rs.randint(_INT32_MAX))

    def randint(self, low: int, high: int) -> int:
        return int(self._rs.randint(low, high))


def gaussian_latents(n_samples: int, dim: int, seed: int) -> np.ndarray:
    """``RandomState(seed).standard_normal(dim * n).astype(float32)``
    reshaped to [n, dim] (reference ``wrappers.py:171-174``): the values of
    ``ganspace_tpu.sampling.gaussian_latents``."""
    z = np.random.RandomState(seed).standard_normal(dim * n_samples)
    return z.astype(np.float32).reshape(n_samples, dim)


def random_directions(components: int, dimensions: int) -> np.ndarray:
    """Unit-norm random baseline directions (reference ``decomposition.py:42-46``)."""
    gen = np.random.RandomState(seed=SEED_RANDOM_DIRS)
    dirs = gen.normal(size=(components, dimensions))
    dirs /= np.sqrt(np.sum(dirs ** 2, axis=1, keepdims=True))
    return dirs.astype(np.float32)


def random_directions_device(components: int, dimensions: int, device) -> torch.Tensor:
    """Unit-norm baseline directions drawn on ``device``: block 0 of the
    random-direction stream under ``SEED_RANDOM_DIRS``, deterministic like
    the host stream, with other values (``ganspace_tpu/sampling.py:134-150``).
    Device-RNG runs use them: no host draw of [c, D] and no upload."""
    gen = block_generator(SEED_RANDOM_DIRS, STREAM_RAND_DIRS, 0, device)
    dirs = device_gaussian(gen, components, dimensions)
    return dirs / torch.sqrt(torch.sum(dirs ** 2, dim=1, keepdim=True))
