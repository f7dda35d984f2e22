"""Bring-your-own-generator walkthrough: the port of ``examples/custom_model.py``
(the custom-model-import part of the reference's ``Ganspace_colab.ipynb``).

A custom generator is an ``nn.Module`` subclass of
:class:`~ganspace_tpu_torch.models.base.BaseGenerator` whose synthesis
threads a :class:`~ganspace_tpu_torch.models.base.TapState` through its
stages: each ``ts.tap(name, x)`` gives the model retention, activation
edits and an early exit for ``partial_forward``.  Registered by name, it
runs through every CLI, estimator, edit mode and server of the port.

ToyGAN holds the JAX example's weights (the same ``RandomState`` draws) and
runs on the card unless ``--device`` names another device; its fit at
``fc2`` (D = 4096) streams through the moments tier, whose centered Gram is
the port's kernel A (``csrc/centered_gram.cu``).

    python -m ganspace_tpu_torch.examples.custom_model [--n 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.models.base import BaseGenerator, TapState, grad_while_edit_override
from ganspace_tpu_torch.ops.precision import ieee_f32
from ganspace_tpu_torch.sampling import gaussian_latents


# ---------------------------------------------------------------------------
# 1. The generator: config, params and a synthesis over taps
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ToyConfig:
    z_dim: int = 64
    width: int = 256
    resolution: int = 32        # output is [B, 3, res, res]


def init_params(cfg: ToyConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX example's parameters: the same keys and ``RandomState``
    draws in the same order."""
    rs = np.random.RandomState(seed)
    half = cfg.resolution // 2
    return {
        "fc1.weight": (rs.randn(cfg.z_dim, cfg.width) / np.sqrt(cfg.z_dim)
                       ).astype(np.float32),
        "fc2.weight": (rs.randn(cfg.width, 16 * half * half) /
                       np.sqrt(cfg.width)).astype(np.float32),
        "rgb.weight": (0.1 * rs.randn(16, 3, 3, 3)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# 2. The wrapper: the BaseGenerator surface
# ---------------------------------------------------------------------------

class ToyGenerator(BaseGenerator):
    """fc1 -> fc2 -> reshape to a feature map -> nearest 2x up -> 3x3 to RGB,
    each stage ending in a tap."""

    def __init__(self, class_name=None, cfg: Optional[ToyConfig] = None,
                 seed: int = 0, device="cuda", **_):
        super().__init__("ToyGAN", class_name or "default")
        self.cfg = cfg or ToyConfig()
        self.name = "ToyGAN"
        self.has_latent_residual = False
        params = init_params(self.cfg, seed)
        for key in ("fc1", "fc2", "rgb"):
            setattr(self, key, nn.Parameter(torch.from_numpy(params[f"{key}.weight"]),
                                            requires_grad=False))
        self.to(require_device(device))

    def tap_names(self):
        return ("fc1", "fc2", "output")

    def sample_latent(self, n_samples=1, seed=0, truncation=None):
        if seed is None:
            seed = self.host_rng.next_seed()
        return torch.from_numpy(
            gaussian_latents(n_samples, self.cfg.z_dim, seed)).to(self.device)

    def _gaussian_latent_dim(self):
        # No stream of its own, as in the JAX example: the decomposition
        # calls sample_latent for each batch.
        return None

    def _latents_from_gaussian(self, z):
        return z

    def synthesize(self, z: torch.Tensor, ts: TapState):
        """The image in [-1, 1], or None when ``ts`` stopped at a tap."""
        res = self.cfg.resolution
        x = ts.tap("fc1", torch.tanh(z @ self.fc1))
        if ts.stopped:
            return None
        x = torch.tanh(x @ self.fc2).reshape(z.shape[0], 16, res // 2, res // 2)
        x = ts.tap("fc2", x)
        if ts.stopped:
            return None
        x = F.interpolate(x, size=(res, res), mode="nearest-exact")
        # rgb.weight is [in, out, 3, 3]; the JAX example convolves with its
        # transpose, [out, in, 3, 3]
        x = torch.tanh(F.conv2d(x, self.rgb.transpose(0, 1), padding=1))
        return ts.tap("output", x)

    @grad_while_edit_override
    def _run(self, x, stop_at: Optional[str]):
        if isinstance(x, list):
            x = x[0]
        z = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        retain, edits, store = self._instrumentation()
        ts = TapState(retain, edits, stop_at)
        with ieee_f32():
            img = self.synthesize(z, ts)
        if store is not None:
            store(ts.retained)
        return img

    def forward(self, x):
        return 0.5 * (self._run(x, None) + 1)

    def partial_forward(self, x, layer_name):
        # a true early exit: the stages after the tap never run
        self._run(x, self.resolve_tap(layer_name))


# ---------------------------------------------------------------------------
# 3. Register it and drive the standard pipeline
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch.examples.custom_model")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("-c", "--components", type=int, default=4)
    p.add_argument("--outdir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    args = p.parse_args(argv)

    outdir = Path(args.outdir or tempfile.mkdtemp(prefix="ganspace_custom_"))
    os.environ.setdefault("GANSPACE_OUTPUT_DIR", str(outdir))

    from ganspace_tpu_torch.config import Config
    from ganspace_tpu_torch.decomposition import get_or_compute
    from ganspace_tpu_torch.edit import create_strip_centered
    from ganspace_tpu_torch.models import (get_instrumented_model, register_model,
                                           unregister_model)

    register_model("ToyGAN", ToyGenerator)
    try:
        inst = get_instrumented_model("ToyGAN", None, "fc2", device=args.device)
        print(f"feature shapes: {dict(inst.feature_shape)}")

        cfg = Config(model="ToyGAN", layer="fc2", estimator="ipca",
                     components=args.components, n=args.n, batch_size=128,
                     device=args.device)
        npz_path = get_or_compute(cfg, inst)
        data = np.load(npz_path)
        print(f"components: {npz_path.name}  "
              f"var_ratio={np.round(data['var_ratio'], 3).tolist()}")

        z = inst.model.sample_latent(1, seed=5)
        frames = create_strip_centered(
            inst, "activation", "fc2", [z],
            data["act_comp"][:1], data["lat_comp"][:1],
            data["act_stdev"][:1], data["lat_stdev"][:1],
            data["act_mean"], data["lat_mean"],
            sigma=2.0, layer_start=0, layer_end=1, num_frames=5)[0]
        strip = np.hstack([np.asarray(f) for f in frames])
        from PIL import Image
        out = outdir / "toygan_component0_strip.png"
        Image.fromarray((np.clip(strip, 0, 1) * 255).astype(np.uint8)).save(out)
        print(f"edit strip: {out}")
    finally:
        unregister_model("ToyGAN")
    return 0


if __name__ == "__main__":
    sys.exit(main())
