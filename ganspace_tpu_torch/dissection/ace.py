"""Ablation-based causal effect (ACE) optimization.

Counterpart of ``ganspace_tpu/dissection/ace.py`` (the reference's
``netdissect/aceoptimize.py``): find the per-unit ablation vector
``alpha in [0,1]^U`` at one generator layer that most suppresses a target
segmentation class in the generated images, under an L1 sparsity budget:

    min_alpha  E_z[ mean p_class(G(z; x_layer * (1 - alpha))) ] + l1 * |alpha|_1

The ablation enters through ``InstrumentedModel``'s edit override, so the
generator runs with autograd from the tap on (``models/base.py``); its
convolutions after the tap take the kernels' x-adjoints in the backward
(``ops/modconv.py``: kernel B's modes on kernel B, the stride-2 mode's
stock), and the segmenter's stock torch ops theirs.  Each step is
``torch.optim.Adam`` (optax ``adam``'s update: bias-corrected, eps outside
the square root) and a projection onto [0, 1].  ``ablation_effect`` is the
evaluation half (reference ``evalablate.py`` / ``fullablate.py``).

Latents are ``model.sample_latent(batch, seed=...)`` on the host stream, the
JAX package's bit for bit, so both packages optimise over the same z.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ganspace_tpu_torch.models.base import InstrumentedModel


def _class_presence(segmenter, images: torch.Tensor, classnum: int) -> torch.Tensor:
    """Differentiable mean probability of ``classnum`` over all pixels
    (``SegmenterBase.class_probability`` protocol)."""
    return torch.mean(segmenter.class_probability(images, classnum))


def _forward_with_ablation(inst: InstrumentedModel, tap: str, z, alpha_spatial):
    inst._edit_override = {tap: {"ablation": alpha_spatial}}
    try:
        return inst.model.forward(z)
    finally:
        inst._edit_override = None


def _l1(alpha: torch.Tensor) -> torch.Tensor:
    """sum |alpha| with JAX's subgradient (+1 at 0, where the optimisation
    starts), not torch's 0."""
    return torch.sum(torch.where(alpha >= 0, alpha, -alpha))


def _probe_units(inst: InstrumentedModel, layer: str, batch: int, seed: int):
    """(units, rank) of the tap's activations, from one partial forward."""
    inst.retain_layer(layer)
    inst.model.partial_forward(inst.model.sample_latent(batch, seed=seed), layer)
    feat = inst.retained_features()[layer]
    return (feat.shape[1] if feat.ndim >= 2 else feat.shape[-1]), feat.ndim


def ace_optimize(inst: InstrumentedModel, layer: str, segmenter,
                 classnum: int, *, n_batches: int = 4, batch: int = 4,
                 steps: int = 50, lr: float = 0.05, l1: float = 0.005,
                 seed: int = 1, init: Optional[np.ndarray] = None,
                 progress: bool = False) -> Dict:
    """Returns {'ablation': [U] in [0,1], 'ranking': units by strength,
    'loss_history': [steps], 'baseline': untouched class presence}."""
    model = inst.model
    tap = model.resolve_tap(layer)
    units, spatial_rank = _probe_units(inst, layer, batch, seed)
    zs = [model.sample_latent(batch, seed=seed + 1 + i) for i in range(n_batches)]
    shape = (1, units) + (1,) * (spatial_rank - 2)

    alpha = torch.zeros(units, dtype=torch.float32, device=model.device) if init is None \
        else torch.as_tensor(np.asarray(init, np.float32), device=model.device).clone()
    alpha.requires_grad_(True)
    opt = torch.optim.Adam([alpha], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    with torch.no_grad():
        baseline = float(np.mean([float(_class_presence(segmenter, model.forward(z), classnum))
                                  for z in zs]))

    history = []
    for step in range(steps):
        z = zs[step % len(zs)]
        opt.zero_grad(set_to_none=True)
        img = _forward_with_ablation(inst, tap, z, alpha.reshape(shape))
        presence = _class_presence(segmenter, img, classnum)
        loss = presence + l1 * _l1(alpha)
        loss.backward()
        opt.step()
        with torch.no_grad():
            alpha.clamp_(0.0, 1.0)
        history.append(float(loss.detach()))
        if progress and step % 10 == 0:
            print(f"ace step {step}: loss {history[-1]:.5f} "
                  f"presence {float(presence.detach()):.5f}")

    alpha_np = alpha.detach().cpu().numpy()
    return {
        "ablation": alpha_np,
        "ranking": np.argsort(-alpha_np),
        "loss_history": history,
        "baseline": baseline,
        "classnum": classnum,
        "layer": layer,
        "units": units,
    }


@torch.no_grad()
def ablation_effect(inst: InstrumentedModel, layer: str, segmenter,
                    classnum: int, ranking: Sequence[int], *,
                    ks: Sequence[int] = (0, 1, 2, 4, 8, 16, 32),
                    n_batches: int = 4, batch: int = 4,
                    seed: int = 99) -> Dict[int, float]:
    """Hard-ablate the top-k ranked units and measure the remaining class
    presence (reference ``evalablate.py:248`` / ``fullablate.py:235``);
    returns {k: presence}."""
    model = inst.model
    tap = model.resolve_tap(layer)
    units, spatial_rank = _probe_units(inst, layer, 1, seed)
    zs = [model.sample_latent(batch, seed=seed + 1 + i) for i in range(n_batches)]
    out = {}
    for k in ks:
        alpha = np.zeros((units,), np.float32)
        alpha[np.asarray(ranking[:k], np.int64)] = 1.0
        a = torch.from_numpy(alpha).to(model.device).reshape(
            (1, units) + (1,) * (spatial_rank - 2))
        vals = [float(_class_presence(segmenter, _forward_with_ablation(inst, tap, z, a),
                                      classnum)) for z in zs]
        out[int(k)] = float(np.mean(vals))
    return out
