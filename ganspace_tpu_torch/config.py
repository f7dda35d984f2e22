"""Unified CLI / programmatic configuration.

Counterpart of ``ganspace_tpu/config.py``: the same flag names and defaults,
so commands carry over unchanged, plus ``--device`` (``cuda`` by default).

    python -m ganspace_tpu_torch.apps.visualize --model StyleGAN2 --class ffhq \
        --layer style --use_w --est ipca -c 80 -n 300000
"""

from __future__ import annotations

import argparse
import json
import sys
from copy import deepcopy


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GAN component analysis config (PyTorch)")
    p.add_argument("--model", dest="model", type=str, default="StyleGAN",
                   help="The network to analyze (StyleGAN, StyleGAN2, ProGAN, BigGAN-XYZ)")
    p.add_argument("--layer", dest="layer", type=str, default="g_mapping",
                   help="The layer to analyze")
    p.add_argument("--class", dest="output_class", type=str, default=None,
                   help="Output class to generate (BigGAN: Imagenet, ProGAN: LSUN)")
    p.add_argument("--est", dest="estimator", type=str, default="ipca",
                   help="The algorithm to use [pca, ipca, fbpca, spca, ica]")
    p.add_argument("--sparsity", type=float, default=1.0,
                   help="Sparsity parameter of SPCA")
    p.add_argument("--video", dest="make_video", action="store_true",
                   help="Generate output videos")
    p.add_argument("--batch", dest="batch_mode", action="store_true",
                   help="Don't open windows, instead save results to file")
    p.add_argument("-b", dest="batch_size", type=int, default=None,
                   help="Minibatch size, leave empty for automatic detection")
    p.add_argument("-c", dest="components", type=int, default=80,
                   help="Number of components to keep")
    p.add_argument("-n", type=int, default=300_000,
                   help="Number of examples to use in decomposition")
    p.add_argument("--use_w", action="store_true",
                   help="Use W latent space (StyleGAN(2))")
    p.add_argument("--sigma", type=float, default=2.0,
                   help="Number of stdevs to walk in visualize")
    p.add_argument("--inputs", type=str, default=None,
                   help="Path to directory with named components")
    p.add_argument("--seed", type=int, default=None,
                   help="Seed used in decomposition")
    p.add_argument("--mesh", dest="mesh_shape", type=str, default=None,
                   help="Device mesh shape, e.g. '8' or '4x2' (one process per "
                        "device); default: all visible GPUs, 1-D")
    p.add_argument("--dtype", dest="dtype", type=str, default=None,
                   help="Synthesis precision: float32 (the default for fits) or "
                        "bfloat16 (preview: the bf16 datapath, a _bf16 cache graded "
                        "by its spectrum); the viewer defaults to bfloat16 storage "
                        "and precision, --dtype float32 pins full precision there")
    p.add_argument("--device", dest="device", type=str, default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    return p


class Config:
    """Attribute-bag config merging argparse CLI, dict overrides and tracked defaults."""

    def __init__(self, **kwargs):
        self.from_args([])  # set all defaults
        self.default_args = deepcopy(self.__dict__)
        self.from_dict(kwargs)  # override

    def from_dict(self, dictionary) -> "Config":
        for k, v in dictionary.items():
            setattr(self, k, v)
        return self

    def from_args(self, args=None) -> "Config":
        if args is None:
            args = sys.argv[1:]
        parsed = _build_parser().parse_args(args)
        return self.from_dict(vars(parsed))

    def __str__(self) -> str:
        custom, default = {}, {}
        for k, v in self.__dict__.items():
            if k == "default_args":
                continue
            if k in self.default_args and self.default_args.get(k) == v:
                default[k] = v
            else:
                custom[k] = v
        return json.dumps({"custom": custom, "default": default}, indent=4)

    __repr__ = __str__
