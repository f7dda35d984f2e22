"""Per-unit top-activating sample grids for a whole layer
(``ganspace_tpu/tools/allunitsample.py``, reference
``netdissect/tool/allunitsample.py``).

    python -m ganspace_tpu_torch allunitsample --model DCGAN --layer deconv1 \
        --samples 128 --outdir out/units [--topk 6] [--device cuda]

The stats pass runs on ``--device`` (the card by default); each unit's top
samples are regenerated batch-aligned (``dissect.regenerate_sample``),
synthesized as one batch, put side by side and quantized to uint8 on the
device, and written as one PNG per unit through the image writer pool
(``native.ImageWriterPool``).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch allunitsample")
    p.add_argument("--model", default="DCGAN")
    p.add_argument("--class", dest="output_class", default=None)
    p.add_argument("--layer", required=True)
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--topk", type=int, default=6)
    p.add_argument("--outdir", default="out/units")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    args = p.parse_args(argv)

    import torch

    from ganspace_tpu_torch.dissection import tally_stats
    from ganspace_tpu_torch.dissection.dissect import regenerate_sample
    from ganspace_tpu_torch.imaging import uint8_nhwc
    from ganspace_tpu_torch.models import get_instrumented_model
    from ganspace_tpu_torch.native import ImageWriterPool
    from ganspace_tpu_torch.ops.precision import ieee_f32
    from ganspace_tpu_torch.tools.lightbox import write_lightbox

    inst = get_instrumented_model(args.model, args.output_class, args.layer,
                                  device=args.device)
    model = inst.model
    with ieee_f32():
        stats = tally_stats(inst, args.layer, n_samples=args.samples,
                            batch=args.batch, seed=args.seed, k_top=args.topk)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    with ImageWriterPool(4) as pool, torch.no_grad():
        for u in range(stats["units"]):
            # batch-aligned regeneration: index s lives in the batch drawn
            # with seed + (s // batch) * batch, not seed + s; the unit's
            # top samples then run as one batch
            z = torch.cat([regenerate_sample(model, s, seed=args.seed, batch=args.batch,
                                             n_samples=args.samples)
                           for s in stats["topk_samples"][u][:args.topk]])
            imgs = model.forward(z)
            pool.save_png(outdir / f"unit_{u:04d}.png",
                          uint8_nhwc(torch.cat(list(imgs), dim=2)[None])[0])
        pool.wait()
        if pool.errors():
            raise RuntimeError(f"{pool.errors()} image(s) failed to write")
    write_lightbox(outdir, title=f"{args.model}/{args.layer} top samples")
    print(f"wrote {stats['units']} unit grids to {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
