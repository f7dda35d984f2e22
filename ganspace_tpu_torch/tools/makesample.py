"""Sample images from a generator to PNG files
(``ganspace_tpu/tools/makesample.py``, reference ``netdissect/tool/makesample.py``).

    python -m ganspace_tpu_torch makesample --model DCGAN --size 32 \
        --outdir out/samples [--seed 1] [--batch 16] [--class NAME] [--device cuda]

Each batch is quantized to uint8 on the device before the copy to the host
and written by the image writer pool (``native.ImageWriterPool``).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch makesample")
    p.add_argument("--model", default="DCGAN")
    p.add_argument("--class", dest="output_class", default=None)
    p.add_argument("--size", type=int, default=100, help="number of images")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--truncation", type=float, default=None)
    p.add_argument("--outdir", default="out/samples")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    args = p.parse_args(argv)

    import torch

    from ganspace_tpu_torch.imaging import uint8_nhwc
    from ganspace_tpu_torch.models import get_model
    from ganspace_tpu_torch.native import ImageWriterPool
    from ganspace_tpu_torch.tools.lightbox import write_lightbox

    model = get_model(args.model, args.output_class, device=args.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    with ImageWriterPool(4) as pool, torch.no_grad():
        print(f"writer: {'native (fastio)' if pool.native else 'PIL'}")
        done = 0
        while done < args.size:
            b = min(args.batch, args.size - done)
            z = model.sample_latent(b, seed=args.seed + done,
                                    truncation=args.truncation)
            imgs = uint8_nhwc(model.forward(z))
            for i in range(b):
                pool.save_png(outdir / f"image_{done + i:05d}.png", imgs[i])
            done += b
        pool.wait()
        if pool.errors():
            raise RuntimeError(f"{pool.errors()} image(s) failed to write")
    write_lightbox(outdir, title=f"{args.model} samples")
    print(f"wrote {args.size} samples to {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
