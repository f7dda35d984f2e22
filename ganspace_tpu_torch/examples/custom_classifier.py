"""Bring-your-own-classifier walkthrough for the dissection CLI's
``--features`` mode (reference ``ClassifierSegRunner``,
``netdissect/dissection.py:1529``); the port of ``examples/custom_classifier.py``.

A "classifier layer" is a function ``images [B,3,H,W] float [0,1] tensor ->
activations [B,U,h,w]``, and the CLI imports a *factory* for it:

    python -m ganspace_tpu_torch.dissection \
        --features ganspace_tpu_torch.examples.custom_classifier:features \
        --broden dataset/broden --layer conv2 --samples 64 [--device cpu]

``features(layer)`` below returns a random-init stack of three stride-2 3x3
convs with ReLU, tapped at ``layer``: the weights of the JAX example (the
same ``RandomState(0)`` draws) and its ``"SAME"`` padding, which at stride 2
pads (0, 1) on an even side, not (1, 1).  It runs on the images' device.

    python -m ganspace_tpu_torch.examples.custom_classifier [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

LAYERS = ("conv1", "conv2", "conv3")
_WIDTHS = {"conv1": 16, "conv2": 32, "conv3": 64}


def _params(seed: int = 0):
    rs = np.random.RandomState(seed)
    params, c_in = {}, 3
    for name in LAYERS:
        c_out = _WIDTHS[name]
        w = rs.randn(c_out, c_in, 3, 3).astype(np.float32)
        params[name] = w * np.sqrt(2.0 / (c_in * 9))
        c_in = c_out
    return params


def _same_pad(size: int, k: int = 3, stride: int = 2):
    """(before, after) of ``"SAME"`` padding along one side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _forward(params, x: torch.Tensor, layer: str) -> torch.Tensor:
    """The conv stack up to ``layer`` (the later stages never run)."""
    for name in LAYERS:
        (top, bottom), (left, right) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        x = F.conv2d(F.pad(x, (left, right, top, bottom)), params[name], stride=2)
        x = F.relu(x)
        if name == layer:
            return x
    raise KeyError(layer)


def features(layer: str | None = None):
    """The ``--features`` factory: ``factory(layer) -> features_fn``."""
    layer = layer or "conv2"
    if layer not in LAYERS:
        raise SystemExit(f"unknown layer {layer!r}; choose from {LAYERS}")
    host = _params()
    on_device = {}

    def fn(images):
        images = torch.as_tensor(images, dtype=torch.float32)
        if images.device not in on_device:
            on_device[images.device] = {k: torch.from_numpy(v).float().to(images.device)
                                        for k, v in host.items()}
        return _forward(on_device[images.device], images, layer)
    fn.__name__ = layer
    return fn


def main(argv=None) -> int:
    import argparse
    import tempfile

    from ganspace_tpu_torch.dissection.__main__ import main as dissect_main
    from ganspace_tpu_torch.dissection.broden import write_synthetic_broden

    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch.examples.custom_classifier")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    tmp = Path(tempfile.mkdtemp(prefix="custom_classifier_"))
    broden = write_synthetic_broden(tmp / "broden", n_images=8, size=32)
    rc = dissect_main([
        "--features", "ganspace_tpu_torch.examples.custom_classifier:features",
        "--broden", str(broden),
        "--layer", "conv2",
        "--samples", "8", "--batch", "4",
        "--rank-all-labels",
        "--outdir", str(tmp / "out"),
        "--device", args.device,
    ])
    print(f"outputs under {tmp / 'out'}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
