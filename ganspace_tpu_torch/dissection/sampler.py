"""Deterministic dataset subsetting (reference ``netdissect/sampler.py``): a
copy of ``ganspace_tpu/dissection/sampler.py``, host code.

A sampler is a fixed sequence of dataset indices.  ``FixedRandomSubsetSampler``
derives it from a seeded shuffle so classifier-mode dissection over a random
subset of broden is exactly reproducible across runs and machines;
``coordinate_sample`` deterministically picks spatial points of a feature map
in a resolution-independent way (halving the resolution halves the
coordinates of the same logical sample points).
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence, Union

import numpy as np


class FixedSubsetSampler:
    """A fixed sequence of dataset indices (reference ``sampler.py:19-43``).

    Iterating yields input-dataset indices; ``subset`` composes samplers by
    dereferencing output positions into input indices.
    """

    def __init__(self, samples: Sequence[int]):
        self.samples = list(samples)

    def __iter__(self):
        return iter(self.samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, key):
        return self.samples[key]

    def subset(self, new_subset: Sequence[int]) -> "FixedSubsetSampler":
        return FixedSubsetSampler(self.dereference(new_subset))

    def dereference(self, indices: Sequence[int]) -> List[int]:
        """Output positions (small numbers indexing this sample sequence) ->
        input dataset indices (numbers indexing the original full set)."""
        return [self.samples[i] for i in indices]


class FixedRandomSubsetSampler(FixedSubsetSampler):
    """Seeded-shuffle subset of a dataset (reference ``sampler.py:45-76``):
    ``random.Random(seed)`` shuffles ``range(len(data_source))`` and the
    ``[start:end)`` slice of the shuffle is the sample sequence — the same
    subset every run for a given seed."""

    def __init__(self, data_source, start: Optional[int] = None,
                 end: Optional[int] = None, seed: int = 1,
                 class_filter: Union[int, Callable, None] = None):
        rng = random.Random(seed)
        shuffled = list(range(len(data_source)))
        # Float-draw Fisher-Yates, spelled out: random.shuffle's internal
        # draw changed across Python versions, but the published subset
        # sequences (reference sampler.py:126-134) come from the float
        # algorithm — pinning it keeps seeded subsets stable forever.
        for i in reversed(range(1, len(shuffled))):
            j = int(rng.random() * (i + 1))
            shuffled[i], shuffled[j] = shuffled[j], shuffled[i]
        self.data_source = data_source
        super().__init__(shuffled[start:end])
        if class_filter is not None:
            self.samples = self.class_subset(class_filter).samples

    def class_subset(self, class_filter) -> FixedSubsetSampler:
        """Keep only samples matching the rule (an int compares against the
        item's label ``item[1]``; a callable filters the full item)."""
        if isinstance(class_filter, int):
            rule = lambda d: d[1] == class_filter  # noqa: E731
        else:
            rule = class_filter
        return self.subset([i for i, j in enumerate(self.samples)
                            if rule(self.data_source[j])])


def coordinate_sample(shape: Sequence[int], sample_size: int,
                      seeds: Sequence[int], grid: int = 13, seed: int = 1,
                      flat: bool = False) -> np.ndarray:
    """Deterministic, resolution-independent spatial sampling of a feature
    map (reference ``sampler.py:78-110``): per seed, shuffle the ``grid^d``
    grid squares, keep ``sample_size`` of them, jitter each uniformly inside
    its square, then scale to ``shape`` — the same logical points are picked
    at any resolution."""
    if flat:
        sampind = np.zeros((len(seeds), sample_size), dtype=int)
    else:
        sampind = np.zeros((len(seeds), len(shape), sample_size), dtype=int)
    assert sample_size <= grid
    for j, s in enumerate(seeds):
        rng = np.random.RandomState(s)
        square_count = grid ** len(shape)
        square = np.stack(np.unravel_index(
            rng.choice(square_count, square_count)[:sample_size],
            (grid,) * len(shape)))
        uniform = (square + rng.uniform(size=square.shape)) / grid
        coords = (uniform * np.array(shape)[:, None]).astype(int)
        if flat:
            sampind[j] = np.ravel_multi_index(coords, dims=tuple(shape))
        else:
            sampind[j] = coords
    return sampind
