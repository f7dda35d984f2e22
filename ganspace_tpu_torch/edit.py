"""Edit-strip engine (``ganspace_tpu/edit.py``, reference ``notebooks/notebook_utils.py``).

A component is applied as

  * a **latent** offset over a window of per-layer latent slots (W+):
        z[i] = z - zeroing_offset + sigma * lat_stdev * z_comp
    for i in [layer_start, layer_end)   (reference ``notebook_utils.py:86-90``)
  * and/or an **activation** offset injected at the tapped layer:
        edit_layer(layer, offset = sigma * act_stdev * x_comp - zeroing_offset)
    (reference ``notebook_utils.py:92-95``)

The *centered* variant first projects the sample onto the component and
subtracts, so sigma=0 lands exactly on the mean (``notebook_utils.py:68-81``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _normalize(v):
    return v / torch.sqrt(torch.sum(v ** 2, dim=-1, keepdim=True) + 1e-8)


def create_strip_centered(inst, mode, layer, latents, x_comp, z_comp, act_stdev,
                          lat_stdev, act_mean, lat_mean, sigma, layer_start,
                          layer_end, num_frames=5, as_uint8=False,
                          max_batch=None):
    """Strip where the sample is centered along the component first."""
    return _create_strip_impl(inst, mode, layer, latents, x_comp, z_comp,
                              act_stdev, lat_stdev, act_mean, lat_mean, sigma,
                              layer_start, layer_end, num_frames, center=True,
                              as_uint8=as_uint8, max_batch=max_batch)


@torch.no_grad()
def _create_strip_impl(inst, mode, layer, latents, x_comp, z_comp, act_stdev,
                       lat_stdev, act_mean, lat_mean, sigma, layer_start,
                       layer_end, num_frames, center, as_uint8=False,
                       max_batch=None):
    device = inst.model.device

    def dev(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32,
                                                      device=device)

    latents = [dev(l) for l in latents]
    latents = [l if l.ndim > 1 else l[None] for l in latents]

    max_lat = inst.model.get_max_latents()
    if layer_end < 0 or layer_end > max_lat:
        layer_end = max_lat
    layer_start = int(np.clip(layer_start, 0, layer_end))

    # Cached components carry a placeholder batch dim ([c, 1, ...]):
    # collapse it so the per-frame offsets batch to [frames, ...].
    x_comp = dev(x_comp)
    if x_comp.ndim >= 3 and x_comp.shape[1] == 1:
        x_comp = x_comp[:, 0]
    z_comp = dev(z_comp)
    if z_comp.ndim >= 3 and z_comp.shape[1] == 1:
        z_comp = z_comp[:, 0]
    act_stdev, lat_stdev = dev(act_stdev), dev(lat_stdev)
    act_mean, lat_mean = dev(act_mean), dev(lat_mean)

    sigma_range = np.linspace(-sigma, sigma, num_frames, dtype=np.float32)
    frames: List[List[np.ndarray]] = [[] for _ in range(len(latents))]

    for i_lat, z_single in enumerate(latents):
        zeroing_offset_act = 0
        zeroing_offset_lat = 0
        if center:
            if mode == "activation":
                # Center along the activation (reference
                # notebook_utils.py:71-77); the tap value of a partial
                # forward equals the full forward's.
                inst.close()
                inst.retain_layer(layer)
                inst.model.partial_forward(z_single, layer)
                value = inst.retained_features()[layer]
                dotp = torch.sum((value - act_mean) * _normalize(x_comp),
                                 dim=-1, keepdim=True)
                zeroing_offset_act = _normalize(x_comp) * dotp
            else:
                # Shift the latent onto the mean along the component
                # (reference notebook_utils.py:79-81).
                dotp = torch.sum((z_single - lat_mean) * _normalize(z_comp),
                                 dim=-1, keepdim=True)
                zeroing_offset_lat = dotp * _normalize(z_comp)

        # Replicate the latent num_frames times with a per-frame sigma, and
        # render in max_batch-sized chunks (reference notebook_utils.py:40-47).
        n_base = z_single.shape[0]
        z_batch = torch.repeat_interleave(z_single, num_frames, dim=0)
        sig = torch.as_tensor(np.tile(sigma_range, n_base), device=device)

        inst.remove_edits()
        total = num_frames * n_base
        z = z_batch
        if mode in ("latent", "both"):
            delta = z_comp * sig.reshape([-1] + [1] * (z_comp.ndim - 1)) * lat_stdev
            zoff = (torch.repeat_interleave(zeroing_offset_lat, num_frames, dim=0)
                    if center and mode != "activation" else 0)
            z_list = [z_batch] * max_lat
            for i in range(layer_start, layer_end):
                z_list[i] = z_batch - zoff + delta
            z = z_list

        act_offset = None
        if mode in ("activation", "both"):
            comp_batch = (torch.repeat_interleave(x_comp, total, dim=0)
                          if x_comp.shape[0] == 1
                          else x_comp.expand((total,) + tuple(x_comp.shape[1:])))
            delta = comp_batch * sig.reshape([-1] + [1] * (comp_batch.ndim - 1))
            aoff = (torch.repeat_interleave(zeroing_offset_act, num_frames, dim=0)
                    if center and mode == "activation" else 0)
            act_offset = delta * act_stdev - aoff

        bs = total if not max_batch else min(int(max_batch), total)
        chunks = []
        for s in range(0, total, bs):
            e = min(s + bs, total)
            z_chunk = [zl[s:e] for zl in z] if isinstance(z, list) else z[s:e]
            inst.remove_edits()
            if act_offset is not None:
                inst.edit_layer(layer, offset=act_offset[s:e])
            img = inst.model.sample_np(z_chunk, uint8=as_uint8)
            if img.ndim == 3:
                img = img[None]
            chunks.append(img)
        img_batch = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        for j in range(num_frames):
            frames[i_lat].append(img_batch[j])

        inst.remove_edits()

    return frames
