"""Importers of the generators' PyTorch checkpoints
(``ganspace_tpu/models/torch_import.py``).

Each returns the flat numpy parameter dict that the models'
``params_from_jax`` loads, keyed as the JAX package keys it:

* StyleGAN2: the rosinality ``.pt`` with ``g_ema`` and ``latent_avg``; the
  grouped-conv leading dim is squeezed, the noises and blur buffers dropped;
* StyleGAN: the lernapparat state dict, whose names match one to one; the
  fixed blur buffers are dropped;
* BigGAN-deep: the HuggingFace ``pytorch_model.bin``, whose spectral-norm
  weights are baked: in eval mode torch computes ``W = W_orig / sigma``
  with ``sigma = u^T W v`` from the stored power-iteration vectors, a
  constant, so the division happens once here;
* ProGAN: the GANDissect state dict (``layerN.conv.weight``,
  ``layerN.wscale.b``, ``output_KxK.*``), or the old ``features.N.*``
  naming, with the channel schedule read off the conv shapes;
* DCGAN: a pytorch_GAN_zoo save, bound by module order, not by name.

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


def bake_spectral_norm(w_orig: np.ndarray, u: np.ndarray,
                       v: np.ndarray | None = None) -> np.ndarray:
    """W_orig / sigma with sigma = u^T W_mat v (torch eval-mode semantics).

    If ``v`` is absent (older torch checkpoints store only ``u``), it is the
    deterministic ``normalize(W_mat^T u)`` torch recomputes each forward.
    """
    w_mat = w_orig.reshape(w_orig.shape[0], -1)
    if v is None:
        v = w_mat.T @ u
        v = v / max(np.linalg.norm(v), 1e-12)
    sigma = float(u @ w_mat @ v)
    return (w_orig / sigma).astype(np.float32)


def import_biggan(path_or_dict) -> Dict[str, np.ndarray]:
    """The HuggingFace BigGAN-deep state dict -> flat params, every
    ``weight_orig`` / ``weight_u`` / ``weight_v`` triple baked into one
    ``weight``."""
    state = {k: _to_np(v) for k, v in _load_state(path_or_dict).items()}
    params: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        if key.endswith(".weight_orig"):
            base = key[:-len(".weight_orig")]
            params[base + ".weight"] = bake_spectral_norm(
                value, state.get(base + ".weight_u"), state.get(base + ".weight_v"))
        elif not key.endswith((".weight_u", ".weight_v")):
            params[key] = value
    return params


def import_progan(path_or_dict) -> Tuple[Dict[str, np.ndarray], Tuple[int, ...]]:
    """-> (params, the channel schedule read off the conv shapes).  The old
    ``features.N.*`` naming goes through ``tf_import.import_progan_old_pt``."""
    state = _load_state(path_or_dict)
    if "state_dict" in state:
        state = state["state_dict"]
    if any(re.fullmatch(r"features\.\d+\.conv\.weight", k) for k in state):
        # "old pytorch" naming (reference proggan.py:271-298)
        from ganspace_tpu_torch.models.tf_import import import_progan_old_pt
        return import_progan_old_pt(state)
    params = {k: _to_np(v) for k, v in state.items()}

    # The schedule (reference proggan.py sizes_from_state_dict): layer1's
    # conv is [s1, s0, 4, 4]; each odd layer >= 3 is an up-conv block whose
    # output channels are the next entry.
    n_layers = max(int(re.findall(r"\d+", k)[0])
                   for k in params if re.fullmatch(r"layer\d+\.conv\.weight", k))
    w1 = params["layer1.conv.weight"]
    sizes = [w1.shape[1], w1.shape[0]]
    for i in range(3, n_layers + 1, 2):
        sizes.append(params[f"layer{i}.conv.weight"].shape[0])
    return params, tuple(sizes)


def import_ganzoo_dcgan(path_or_dict):
    """-> (params, DCGANConfig).  Input: a pytorch_GAN_zoo checkpoint, the
    hub save dict (``{'config', 'netG', 'netD', ...}``) or the generator's
    state dict alone (reference ``models/wrappers.py:438-466``).

    The binding goes by order, not by name: the zoo's generator is a flat
    trunk of transposed convs (1 -> 4 px, then 2x stages, then RGB) with
    eval-mode batch norms between them, the graph of ``models/dcgan.py``.
    So a module is a transposed conv when its ``weight`` is 4-d and a batch
    norm when it has ``running_mean``, and modules bind in state-dict order
    (their execution order), whatever a zoo version names them."""
    state = _load_state(path_or_dict)
    for key in ("netG", "state_dict"):
        if isinstance(state.get(key), dict):
            state = state[key]
            break

    modules: Dict[str, dict] = {}       # leaves by module prefix, in order
    for k, v in state.items():
        prefix, _, leaf = k.rpartition(".")
        modules.setdefault(prefix, {})[leaf] = v

    params: Dict[str, np.ndarray] = {}
    ci = -1
    for prefix, leaves in modules.items():
        if "running_mean" in leaves:                      # BatchNorm2d
            if ci < 0:
                raise ValueError(f"zoo DCGAN state dict: BatchNorm module {prefix!r} "
                                 f"precedes any transposed conv")
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                params[f"bn{ci}.{leaf}"] = _to_np(leaves[leaf])
        elif "weight" in leaves and _to_np(leaves["weight"]).ndim == 4:
            w = _to_np(leaves["weight"])                  # [in, out, k, k]
            if w.shape[2:] != (4, 4):
                raise ValueError(f"zoo DCGAN conv {prefix!r} has kernel {w.shape[2:]}, "
                                 f"expected (4, 4)")
            ci += 1
            params[f"deconv{ci}.weight"] = w
            params[f"deconv{ci}.bias"] = (_to_np(leaves["bias"])
                                          if leaves.get("bias") is not None
                                          else np.zeros((w.shape[1],), np.float32))
    if ci < 1:
        raise ValueError("zoo DCGAN state dict: fewer than two transposed convs found; "
                         "not a GNet checkpoint?")

    from ganspace_tpu_torch.models.dcgan import DCGANConfig
    z_total = params["deconv0.weight"].shape[0]
    cond = 20 if z_total > 20 else 0   # the last 20 dims (wrappers.py:457-461)
    cfg = DCGANConfig(latent_dim=z_total - cond, cond_dim=cond,
                      base_channels=params["deconv0.weight"].shape[1],
                      resolution=4 * 2 ** ci)
    return params, cfg
