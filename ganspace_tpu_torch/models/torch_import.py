"""Importers of the StyleGAN families' PyTorch checkpoints (the StyleGAN
half of ``ganspace_tpu/models/torch_import.py``).

Each returns the flat numpy parameter dict that the models'
``params_from_jax`` loads, keyed as the JAX package keys it:

* StyleGAN2: the rosinality ``.pt`` with ``g_ema`` and ``latent_avg``; the
  grouped-conv leading dim is squeezed, the noises and blur buffers dropped;
* StyleGAN: the lernapparat state dict, whose names match one to one; the
  fixed blur buffers are dropped.

A path is read with ``torch.load``; an in-memory dict is taken as it is.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t.astype(np.float32) if t.dtype != np.float32 else t
    return t.detach().cpu().numpy().astype(np.float32)


def _load_state(path_or_dict):
    if isinstance(path_or_dict, dict):
        return path_or_dict
    return torch.load(path_or_dict, map_location="cpu", weights_only=False)


def import_stylegan2(path_or_dict) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """-> (params, latent_avg).  Input: {'g_ema': state_dict, 'latent_avg': t}."""
    ckpt = _load_state(path_or_dict)
    state = ckpt.get("g_ema", ckpt)
    latent_avg = _to_np(ckpt["latent_avg"]) if "latent_avg" in ckpt \
        else np.zeros((512,), np.float32)

    params: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        v = _to_np(value)
        if key.startswith("noises.") or ".blur.kernel" in key or key.endswith(".kernel"):
            continue  # fixed buffers rebuilt locally
        if re.search(r"(^|\.)conv\.weight$", key) and v.ndim == 5:
            v = v[0]  # grouped-conv leading dim [1, out, in, k, k] -> [out, in, k, k]
        params[key] = v
    return params, latent_avg


def import_stylegan(path_or_dict) -> Dict[str, np.ndarray]:
    state = _load_state(path_or_dict)
    return {key: _to_np(value) for key, value in state.items()
            if ".intermediate.kernel" not in key and not key.endswith("blur.kernel")}
