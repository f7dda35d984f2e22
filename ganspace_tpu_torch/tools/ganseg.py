"""Generate images and write segmentation visualizations
(``ganspace_tpu/tools/ganseg.py``, reference ``netdissect/tool/ganseg.py``).

    python -m ganspace_tpu_torch ganseg --model DCGAN --size 16 \
        --outdir out/ganseg [--segmenter color|unified] [--device cuda]

The generator and the segmenter run on ``--device`` (the card by default);
each image and its colour-coded segmentation are written side by side as a
PNG through the image writer pool (``native.ImageWriterPool``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch ganseg")
    p.add_argument("--model", default="DCGAN")
    p.add_argument("--class", dest="output_class", default=None)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--segmenter", choices=("color", "unified"),
                   default="color")
    p.add_argument("--outdir", default="out/ganseg")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    args = p.parse_args(argv)

    import torch

    from ganspace_tpu_torch.dissection import ColorSegmenter, UnifiedParsingSegmenter
    from ganspace_tpu_torch.dissection.viz import segment_visualization
    from ganspace_tpu_torch.imaging import to_uint8
    from ganspace_tpu_torch.models import get_model
    from ganspace_tpu_torch.native import ImageWriterPool
    from ganspace_tpu_torch.tools.lightbox import write_lightbox

    model = get_model(args.model, args.output_class, device=args.device)
    seg = ColorSegmenter() if args.segmenter == "color" \
        else UnifiedParsingSegmenter(device=model.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    with ImageWriterPool(4) as pool, torch.no_grad():
        done = 0
        while done < args.size:
            b = min(args.batch, args.size - done)
            imgs = model.forward(model.sample_latent(b, seed=args.seed + done))
            segmap = seg.segment_batch(torch.clamp(imgs, 0, 1)).cpu().numpy()
            imgs_np = np.clip(imgs.permute(0, 2, 3, 1).cpu().numpy(), 0, 1)
            for i in range(b):
                side = np.hstack([imgs_np[i], segment_visualization(segmap[i])])
                pool.save_png(outdir / f"ganseg_{done + i:05d}.png", to_uint8(side))
            done += b
        pool.wait()
        if pool.errors():
            raise RuntimeError(f"{pool.errors()} image(s) failed to write")
    write_lightbox(outdir, title=f"{args.model} segmentations")
    print(f"wrote {args.size} image|segmentation pairs to {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
