"""Shared setup for the figure scripts (``notebooks/notebook_init.py``,
reference ``notebooks/notebook_init.py``).

``setup(args, ...)`` returns a namespace: the instrumented model on
``--device``, the components computed (or read from the cache) as float32
numpy arrays, and the output directory.  The figure modules reach the port
through its public API only (``get_instrumented_model``, ``get_or_compute``,
``create_strip(_centered)``, ``save_frames``, ``sample_np``).

A figure's grids go to the image writer pool (``native.ImageWriterPool``:
C++ threads, zlib PNG) of its run: ``@figure_main`` gives each run one
pool and drains it before ``main`` returns, so a grid encodes while the
next one renders.

Every script takes ``--tiny`` to run on randomly initialised reduced models
(the JAX package's reduced configs, built with the same weights), so the
suite runs offline; at full width the same scripts render the paper's
figures from whatever checkpoints are found, or seeded random weights.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.edit import create_strip, create_strip_centered, save_frames  # noqa: F401  (re-export)
from ganspace_tpu_torch.models import get_instrumented_model
from ganspace_tpu_torch.native import ImageWriterPool

OUTDIR = Path(os.environ.get("GANSPACE_FIGURE_DIR", "out/figures"))

#: the running figure's writer pool (:func:`figure_writer`)
_WRITER = None


def tiny_overrides(model: str) -> dict:
    """Reduced configs for checkpoint-free runs (the JAX package's)."""
    if model == "StyleGAN2":
        from ganspace_tpu_torch.models.stylegan2 import SG2Config
        return {"cfg": SG2Config(
            resolution=64,
            channels=((4, 128), (8, 128), (16, 64), (32, 64), (64, 32)))}
    if model == "StyleGAN":
        from ganspace_tpu_torch.models.stylegan import SG1Config
        return {"cfg": SG1Config(resolution=64, fmap_base=512)}
    if "BigGAN" in model:
        from ganspace_tpu_torch.models.biggan import BigGANConfig
        return {"cfg": BigGANConfig(
            output_dim=64, z_dim=32, channel_width=16,
            layers=((False, 16, 16), (True, 16, 8), (True, 8, 8),
                    (True, 8, 4), (True, 4, 2)),
            attention_layer_position=3)}
    if model == "ProGAN":
        from ganspace_tpu_torch.models.proggan import ProGANConfig
        return {"cfg": ProGANConfig(sizes=(128, 64, 64, 32, 16))}
    if model == "DCGAN":
        from ganspace_tpu_torch.models.dcgan import DCGANConfig
        return {"cfg": DCGANConfig(resolution=32, base_channels=64)}
    return {}


def parse_args(argv=None, **defaults):
    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true",
                   help="random-init reduced model, no checkpoint")
    p.add_argument("--model", default=defaults.get("model", "StyleGAN2"))
    p.add_argument("--class", dest="output_class",
                   default=defaults.get("output_class"))
    p.add_argument("--layer", default=defaults.get("layer", "style"))
    p.add_argument("--n", type=int, default=defaults.get("n", 2048))
    p.add_argument("--components", "-c", type=int,
                   default=defaults.get("components", 16))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--outdir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    return p.parse_args(argv)


def setup(args, use_w: bool = True, estimator: str = "ipca"):
    """Model + components namespace shared by every figure script."""
    kwargs = tiny_overrides(args.model) if args.tiny else {}
    inst = get_instrumented_model(args.model, args.output_class, args.layer,
                                  device=args.device, use_w=use_w, **kwargs)
    model = inst.model
    if use_w and hasattr(model, "use_w"):
        model.use_w()

    cfg = Config(model=args.model, output_class=args.output_class,
                 layer=args.layer, estimator=estimator,
                 components=args.components, n=args.n, use_w=use_w,
                 seed=args.seed if args.seed else None, device=args.device)
    dump = get_or_compute(cfg, inst)
    # Host float32 arrays, as the scripts read them with np.asarray; the
    # edit engine moves what it uses to the model's device.  Non-numeric
    # sidecar keys (the _meta provenance string) are skipped.
    with np.load(dump, allow_pickle=False) as data:
        t = SimpleNamespace(**{k: data[k].astype(np.float32) for k in data.files
                               if np.issubdtype(data[k].dtype, np.number)})

    outdir = Path(args.outdir) if args.outdir else OUTDIR
    outdir.mkdir(parents=True, exist_ok=True)
    return SimpleNamespace(inst=inst, model=model, cfg=cfg, comps=t,
                           outdir=outdir)


def drain(pool: ImageWriterPool) -> None:
    """Wait for every queued grid; raise if a write failed."""
    pool.wait()
    failed = pool.errors()
    pool.close()
    if failed:
        raise OSError(f"{failed} figure grid(s) failed to write")


@contextlib.contextmanager
def figure_writer():
    """The writer pool of a figure run, opened here unless one is running,
    and then drained on the way out."""
    global _WRITER
    if _WRITER is not None:
        yield _WRITER
        return
    _WRITER = ImageWriterPool(4)
    try:
        yield _WRITER
    finally:
        pool, _WRITER = _WRITER, None
        drain(pool)


def figure_main(main):
    """Run a figure script's ``main`` with one writer pool for its grids,
    drained before it returns."""
    @functools.wraps(main)
    def run(*args, **kwargs):
        with figure_writer():
            return main(*args, **kwargs)
    return run


def save_figure_grid(rows, outpath, pad: int = 2):
    """Stack rows of HWC images (float [0, 1] or uint8) into one PNG,
    queued on the figure run's writer pool (written before the figure's
    ``main`` returns; at once outside a run).

    The frames are quantized one by one and padded in uint8 (white: 255,
    what a float 1.0 quantizes to), so a grid of 1024-px frames never
    exists as float32; the pixels are those of the float grid quantized."""
    from ganspace_tpu_torch.imaging import pad_frames, to_uint8
    strips = [np.hstack(pad_frames([to_uint8(np.atleast_3d(f)) for f in row]))
              for row in rows]
    w = max(s.shape[1] for s in strips)
    strips = [np.pad(s, ((0, 0), (0, w - s.shape[1]), (0, 0)),
                     constant_values=255) for s in strips]
    grid = np.vstack(strips)
    Path(outpath).parent.mkdir(parents=True, exist_ok=True)
    with figure_writer() as pool:
        pool.save_png(outpath, grid)
    print(f"wrote {outpath}")
    return outpath
