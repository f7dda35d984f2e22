"""End-to-end quickstart: the port of ``examples/quickstart.py`` (the
reference's ``Ganspace_colab.ipynb`` analog).

Runs the whole story on a checkpoint-free model in about a minute:
  1. build and instrument a generator,
  2. compute (or load) PCA components over sampled activations,
  3. render a component-edit strip,
  4. export a named direction and load it back,
  5. dissect one layer against a segmenter and write the HTML report.

Everything runs on the card unless ``--device`` names another device:

    python -m ganspace_tpu_torch.examples.quickstart [--model ProGAN --class bedroom \
        --layer layer4] [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch.examples.quickstart")
    p.add_argument("--model", default="DCGAN")
    p.add_argument("--class", dest="output_class", default=None)
    p.add_argument("--layer", default="deconv1")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("-c", "--components", type=int, default=6)
    p.add_argument("--outdir", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="smallest settings (quick smoke run / CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    args = p.parse_args(argv)
    if args.tiny:
        args.n = min(args.n, 128)
        args.components = min(args.components, 4)

    outdir = Path(args.outdir or tempfile.mkdtemp(prefix="ganspace_quickstart_"))
    os.environ.setdefault("GANSPACE_OUTPUT_DIR", str(outdir))

    # 1. model + instrumentation
    from ganspace_tpu_torch.config import Config
    from ganspace_tpu_torch.models import get_instrumented_model
    inst = get_instrumented_model(args.model, args.output_class, args.layer,
                                  device=args.device)
    model = inst.model
    print(f"model: {model.name}; taps: {model.tap_names()[:6]}...")

    # 2. decomposition (cached by config under $GANSPACE_OUTPUT_DIR)
    from ganspace_tpu_torch.decomposition import get_or_compute
    cfg = Config(model=args.model, output_class=args.output_class,
                 layer=args.layer, estimator="ipca",
                 components=args.components, n=args.n, device=args.device)
    npz = get_or_compute(cfg, inst)
    data = np.load(npz)
    print(f"components: {npz.name}; var_ratio[:3] = "
          f"{np.round(data['var_ratio'][:3], 4)}")

    # 3. edit strip along PC0
    from ganspace_tpu_torch.edit import create_strip_centered, save_frames
    z = model.sample_latent(1, seed=5)
    frames = create_strip_centered(
        inst, "latent", args.layer, [z], data["act_comp"][:1],
        data["lat_comp"][:1], data["act_stdev"][0], data["lat_stdev"][0],
        data["act_mean"], data["lat_mean"], 2.0, 0, -1, num_frames=5)
    save_frames("quickstart pc0", model.name, str(outdir / "strips"), frames)

    # 4. named-direction round trip
    from ganspace_tpu_torch import directions as dirlib
    params = dirlib.direction_params(
        name="demo_direction", sigma_range=2.0, component_index=0,
        act_comp=data["act_comp"][0], lat_comp=data["lat_comp"][0],
        latent_space=model.latent_space_name(),
        act_stdev=float(data["act_stdev"][0]),
        lat_stdev=float(np.ravel(data["lat_stdev"])[0]),
        model_name=model.name, output_class=str(model.outclass),
        estimator="ipca", components=args.components, samples=args.n,
        layer=args.layer, component_class=str(model.outclass),
        edit_type="latent", truncation=1.0, edit_start=0,
        edit_end=model.get_max_latents(), example_seed=5)
    pkl = dirlib.export_direction(params, outdir / "directions")
    loaded = dirlib.load_named_components(outdir / "directions", model.name,
                                          str(model.outclass))
    print(f"direction exported+reloaded: {pkl.name} ({len(loaded)} found)")

    # 5. dissection + report
    from ganspace_tpu_torch.dissection import ColorSegmenter, dissect, generate_report
    report = dissect(inst, args.layer, ColorSegmenter(), n_samples=64,
                     batch=16)
    html = generate_report(report, outdir / "dissect", inst=inst, n_units=8)
    top = report["units"][0]
    print(f"dissection: top unit {top['unit']} -> {top['label']} "
          f"(iou {top['iou']:.3f}); report at {html}")
    print(f"\nall quickstart outputs under {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
