"""One module per model family: weights from the seed, the program's model,
the reference, the work of a unit."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def weights_from_specs(specs: List[Tuple[str, tuple, float, float]], seed: int,
                       device) -> Dict[str, torch.Tensor]:
    """``(key, shape, scale, offset)`` -> offset + scale N(0, 1), every
    parameter a view of one ``randn`` on a generator seeded on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape, scale, offset in specs:
        n = math.prod(shape)
        out[key] = flat[at:at + n].view(shape).mul_(scale).add_(offset)
        at += n
    return out
