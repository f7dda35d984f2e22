"""Host-side latent sampling, bit-identical to the JAX package's host stream.

Counterpart of the host half of ``ganspace_tpu/sampling.py``.  Every
seedless ``sample_latent`` call first draws ``seed = randint(int32_max)``
from a seeded stream (``SeedStream``; the JAX package uses numpy's global
state for the same sequence), then samples
``RandomState(seed).standard_normal(dim * n)``.  Device-side RNG (threefry in
JAX, Philox in torch) is not ported.

Seed map (reference ``decomposition.py:34-37``):
  SAMPLING=1, RANDOM_DIRS=2, LINREG=3, VISUALIZATION=5.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SEED_SAMPLING = 1
SEED_RANDOM_DIRS = 2
SEED_LINREG = 3
SEED_VISUALIZATION = 5

_INT32_MAX = np.iinfo(np.int32).max


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
