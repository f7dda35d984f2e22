"""Batch visualizer CLI (``ganspace_tpu/apps/visualize.py``, reference ``visualize.py``).

Loads or computes components, then renders per-component summary grids at
+-sigma, random-direction baseline grids with the PC stdevs, grids for 10
random samples and, with ``--video``, sweep videos (150 frames out and
back, at sigma and 3 sigma: the first 15 components, and the first 5 for
each random sample; MP4 through ffmpeg when it is on PATH, GIF otherwise)
into the reference's output tree ``out/{model}/{layer}/{est}/{comp,inst,summ}``
under the same filenames as the JAX CLI, with a ``+lightbox.html`` gallery
page in each directory that holds images.

Usage (the model is built on the card; ``--device cpu`` runs the plain
PyTorch path):
    python -m ganspace_tpu_torch.apps.visualize      # StyleGAN ffhq, g_mapping, ipca
    python -m ganspace_tpu_torch.apps.visualize --model StyleGAN --class bedrooms \
        --layer g_mapping --est ipca -c 1 --video
    python -m ganspace_tpu_torch.apps.visualize --model StyleGAN --class ffhq \
        --layer g_synthesis.blocks.16x16 --est ipca -c 80 -n 50000
    python -m ganspace_tpu_torch.apps.visualize --model StyleGAN2 --class ffhq \
        --layer style --use_w --est ipca -c 80 -n 300000
    python -m ganspace_tpu_torch.apps.visualize --model StyleGAN2 --class ffhq \
        --layer convs.2 --est ipca -c 80 -n 50000

A conv tap renders activation-mode grids (``*_ACT.jpg``) beside the
latent-mode ones (``*_Z.jpg`` or ``*_W.jpg``).
"""

from __future__ import annotations

import datetime
import os
import time
from os import makedirs
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from PIL import Image

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute, read_meta
from ganspace_tpu_torch.edit import create_strip_centered
from ganspace_tpu_torch.imaging import pad_frames, to_uint8
from ganspace_tpu_torch.models import get_instrumented_model
from ganspace_tpu_torch.sampling import (
    SEED_VISUALIZATION, random_directions, random_directions_device)
from ganspace_tpu_torch.tools.lightbox import write_lightbox
from ganspace_tpu_torch.utils.video import make_mp4

#: frames per forward when ``-b`` is not given; a strip has 5 frames, so
#: every strip renders as one batch
RENDER_MAX_BATCH = 16

#: frames of one sweep video before it is mirrored (visualize.py:184-200)
VIDEO_FRAMES = 150


def make_grid(inst, layer_key, latent, lat_mean, lat_comp, lat_stdev, act_mean,
              act_comp, act_stdev, scale=1, n_rows=10, n_cols=5,
              edit_type="latent", max_batch=None):
    """Rows of centered edit strips, one per component (reference
    ``visualize.py:79-120`` minus the matplotlib chrome)."""
    inst.remove_edits()
    rows = []
    for r in range(n_rows):
        out_batch = create_strip_centered(
            inst, edit_type, layer_key, [latent],
            act_comp[r:r + 1], lat_comp[r:r + 1], act_stdev[r], lat_stdev[r],
            act_mean, lat_mean, scale, 0, -1, n_cols,
            as_uint8=True, max_batch=max_batch)[0]
        rows.append(out_batch[:n_cols])
    inst.remove_edits()
    return rows


def save_grid_image(rows, outpath):
    strips = [np.hstack(pad_frames([np.atleast_3d(img) for img in row]))
              for row in rows]
    Image.fromarray(to_uint8(np.vstack(strips))).save(outpath)


def load_components(path) -> SimpleNamespace:
    """Read a component cache (this port's, the JAX package's or the
    reference's) into host arrays, with its ``_meta`` sidecar or None."""
    with np.load(path, allow_pickle=False) as data:
        return SimpleNamespace(
            X_comp=data["act_comp"], X_global_mean=data["act_mean"],
            X_stdev=data["act_stdev"], Z_comp=data["lat_comp"],
            Z_global_mean=data["lat_mean"], Z_stdev=data["lat_stdev"],
            var_ratio=data["var_ratio"], meta=read_meta(data))


def baseline_directions(meta, device):
    """``dirs(components, dims)`` for the random-direction grids: the
    device stream's when the cache records ``device_rng`` true, the host
    stream's when false; ``GANSPACE_DEVICE_RNG`` decides for a cache without
    the record (``ganspace_tpu/apps/visualize.py:202-217``)."""
    cached = meta.get("device_rng") if meta else None
    use_device = (cached if cached is not None
                  else os.environ.get("GANSPACE_DEVICE_RNG", "1") == "1")
    if use_device:
        return lambda c, d: random_directions_device(c, d, device)
    return random_directions


def main(args=None):
    """Run the CLI; returns the cache path and the timings: ``fit_seconds``,
    ``render_seconds``, ``images`` rendered (video frames included), the
    ``videos`` written and, when the components were computed, the fit's
    ``phases`` (seconds by phase)."""
    args = args if isinstance(args, Config) else Config().from_args(args)
    device = require_device(args.device)
    t_start = datetime.datetime.now()
    timestamp = lambda: datetime.datetime.now().strftime("%d.%m %H:%M")  # noqa: E731
    print(f"[{timestamp()}] {args.model}, {args.layer}, {args.estimator}")

    layer_key = args.layer
    outdir = Path(os.environ.get("GANSPACE_OUTPUT_DIR", Path.cwd())) / "out"

    inst = get_instrumented_model(args.model, args.output_class, layer_key,
                                  device, use_w=args.use_w)
    model = inst.model
    model.seed_host_rng(0)
    feature_shape = inst.feature_shape[layer_key]
    latent_shape = model.get_latent_shape()
    print("Feature shape:", feature_shape)

    # Layout of activations (visualize.py:159-165)
    if len(feature_shape) != 4:  # non-spatial
        axis_mask = np.ones(len(feature_shape), dtype=np.int32)
    else:
        axis_mask = np.array([0, 1, 1, 1])  # whole activation volume
    sample_shape = np.array(feature_shape) * axis_mask
    sample_shape[sample_shape == 0] = 1

    t_fit = time.perf_counter()
    phases = {}
    dump_name = get_or_compute(args, inst, phases=phases)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_seconds = time.perf_counter() - t_fit
    t = load_components(dump_name)
    n_comp = t.X_comp.shape[0]

    max_batch = args.batch_size or RENDER_MAX_BATCH
    print("Batch size:", max_batch)
    print(f"[{timestamp()}] Creating visualizations")
    t_render = time.perf_counter()
    n_images = 0

    model.seed_host_rng(SEED_VISUALIZATION)

    est_id = f"spca_{args.sparsity}" if args.estimator == "spca" else args.estimator
    outdir_comp = outdir / model.name / layer_key.lower() / est_id / "comp"
    outdir_inst = outdir / model.name / layer_key.lower() / est_id / "inst"
    outdir_summ = outdir / model.name / layer_key.lower() / est_id / "summ"
    for d in (outdir_comp, outdir_inst, outdir_summ):
        makedirs(d, exist_ok=True)

    print(f"Sparsity: {np.mean(t.X_comp == 0):.2f}")

    def get_edit_name(mode):
        if mode == "activation":
            is_stylegan = "StyleGAN" in args.model
            is_w = layer_key in ("style", "g_mapping")
            return "W" if (is_stylegan and is_w) else "ACT"
        if mode == "latent":
            return model.latent_space_name()
        if mode == "both":
            return "BOTH"
        raise RuntimeError(f"Unknown edit mode {mode}")

    # Only visualize applicable edit modes (visualize.py:237-240)
    if args.use_w and layer_key in ("style", "g_mapping"):
        edit_modes = ["latent"]  # activation edit is identical
    else:
        edit_modes = ["activation", "latent"]

    n_rows = min(14, n_comp)

    def grid(edit_mode, latent, lat_comp, act_comp, name):
        nonlocal n_images
        rows = make_grid(inst, layer_key, latent, t.Z_global_mean, lat_comp,
                         t.Z_stdev, t.X_global_mean, act_comp, t.X_stdev,
                         scale=args.sigma, edit_type=edit_mode, n_rows=n_rows,
                         max_batch=max_batch)
        n_images += sum(len(r) for r in rows)
        save_grid_image(rows, outdir_summ / f"{name}_{get_edit_name(edit_mode)}.jpg")

    videos = []

    def video(edit_mode, latent, c, sigma, outpath):
        """One sweep of component ``c``, out and back."""
        nonlocal n_images
        rows = make_grid(inst, layer_key, latent, t.Z_global_mean, t.Z_comp[c:c + 1],
                         t.Z_stdev[c:c + 1], t.X_global_mean, t.X_comp[c:c + 1],
                         t.X_stdev[c:c + 1], n_rows=1, n_cols=VIDEO_FRAMES, scale=sigma,
                         edit_type=edit_mode, max_batch=max_batch)
        n_images += len(rows[0])
        videos.append(make_mp4(rows[0] + rows[0][::-1], 5, outpath))

    # Summary grid, real components
    for edit_mode in edit_modes:
        grid(edit_mode, t.Z_global_mean, t.Z_comp, t.X_comp, "components")

    if args.make_video:
        for sigma in [args.sigma, 3 * args.sigma]:
            for c in range(min(15, n_comp)):
                for edit_mode in edit_modes:
                    video(edit_mode, t.Z_global_mean, c, sigma, outdir_comp /
                          f"{get_edit_name(edit_mode)}_sigma{sigma}_comp{c}.mp4")

    # Summary grid, random directions with the PC stdevs (visualize.py:268-279),
    # from the stream the decomposition's random_stdevs used.
    dirs = baseline_directions(t.meta, device)
    rand_act = dirs(n_comp, int(np.prod(sample_shape))).reshape(-1, *sample_shape)
    rand_z = dirs(n_comp, int(np.prod(inst.input_shape))).reshape(-1, *latent_shape)
    for edit_mode in edit_modes:
        grid(edit_mode, t.Z_global_mean, rand_z, rand_act, "random_dirs")

    # Random instances with components applied
    n_random_imgs = 10
    latents = model.sample_latent(n_samples=n_random_imgs)
    for img_idx in range(n_random_imgs):
        z = latents[img_idx][None, ...]
        for edit_mode in edit_modes:
            grid(edit_mode, z, t.Z_comp, t.X_comp, f"samp{img_idx}_real")
        if args.make_video:
            for sigma in [args.sigma, 3 * args.sigma]:
                for edit_mode in edit_modes:
                    for c in range(min(5, n_comp)):
                        video(edit_mode, z, c, sigma, outdir_inst /
                              f"{get_edit_name(edit_mode)}_sigma{sigma}_"
                              f"img{img_idx}_comp{c}.mp4")

    # A browsable gallery page per output directory (visualize.py:258-264).
    for d in (outdir_comp, outdir_inst, outdir_summ):
        if any(p.suffix.lower() in (".jpg", ".png", ".gif") for p in d.iterdir()):
            write_lightbox(d, title=f"{model.name}/{layer_key}/{est_id} {d.name}")

    render_seconds = time.perf_counter() - t_render
    print("Done in", datetime.datetime.now() - t_start)
    return SimpleNamespace(cache=dump_name, fit_seconds=fit_seconds,
                           render_seconds=render_seconds, images=n_images,
                           videos=videos, phases=phases)


if __name__ == "__main__":
    main()
