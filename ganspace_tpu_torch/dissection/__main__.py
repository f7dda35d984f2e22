"""Dissection CLI (reference ``python -m netdissect``,
``netdissect/__main__.py:30`` — the ``--gan`` mode, which is the only mode
relevant to generator dissection); counterpart of
``ganspace_tpu/dissection/__main__.py``.

    python -m ganspace_tpu_torch.dissection --model DCGAN --layer deconv1 \
        --samples 256 --outdir out/dissect [--segmenter color|unified|ade] \
        [--seg-params NPZ] [--segsizes 256 ...] [--iqr] [--maxiou] [--cov] \
        [--ace-class N] [--serve PORT] [--done-dir JOBDIR] [--no-labels] \
        [--no-report] [--netname NAME] [--quiet] [--device cuda|cpu]

Writes ``dissect.json``, ``bargraph.svg``, ``dissect.html`` and per-unit
top-image grids under ``--outdir`` (see ``report.py``), with ``--ace-class``
``ace.json`` and the ACE page, and prints the seconds of each pass (the
quantile sketches' share beside it).  The model and the segmenter run on
``--device`` (default ``cuda``, never falling back to the CPU); with
``--serve`` the last layer's session is served afterwards.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

def _strfloat(v: str):
    """Reference ``strfloat`` (``netdissect/__main__.py``): a float quantile
    in (0, 1), or a named per-unit threshold mode."""
    if v in ("iqr", "maxiou"):
        return v
    f = float(v)
    if not 0.0 < f < 1.0:
        raise argparse.ArgumentTypeError(
            f"quantile must be in (0, 1) or 'iqr'/'maxiou', got {v}")
    return f


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ganspace_tpu_torch.dissection",
        description="Dissect generator units against a segmentation")
    p.add_argument("--model", default="DCGAN")
    p.add_argument("--class", dest="output_class", default=None)
    p.add_argument("--layer", action="append",
                   help="layer(s) to dissect, each NAME or NAME:DISPLAY "
                        "(reference --layers strpair aliases); repeatable "
                        "(required unless --imagedir is given)")
    p.add_argument("--imagedir", default=None,
                   help="image-only mode (reference --imagedir / "
                        "ImageOnlySegRunner): segment every image in DIR "
                        "with --segmenter, write colorized overlays + a "
                        "gallery + a label histogram; no GAN involved. "
                        "Images in one batch must share a resolution.")
    p.add_argument("--features", default=None, metavar="MODULE:ATTR",
                   help="classifier mode (reference ClassifierSegRunner / "
                        "--model without --gan): import ATTR from MODULE and "
                        "call it as factory(layer) -> features_fn, where "
                        "features_fn(images [B,3,H,W] tensor) -> [B,U,h,w] "
                        "unit activations; dissect those units against "
                        "--broden ground-truth labels. See "
                        "ganspace_tpu_torch/examples/custom_classifier.py. "
                        "Requires --broden.")
    p.add_argument("--broden", default=None, metavar="DIR",
                   help="broden-format dataset directory providing the "
                        "images and segmentation ground truth for "
                        "--features mode (reference --segments)")
    p.add_argument("--outdir", default="out/dissect")
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--sample-seed", type=int, default=None, metavar="SEED",
                   help="classifier mode: dissect a seeded-shuffle random "
                        "subset of --samples dataset items instead of the "
                        "first --samples (reference FixedRandomSubsetSampler"
                        ", netdissect/sampler.py:45)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--quantile", type=_strfloat, default=0.995,
                   help="activation threshold: a quantile in (0,1), or "
                        "'iqr' (information-quality-ratio search, the "
                        "reference GAN mode's default) / 'maxiou' (IoU "
                        "search) for per-unit thresholds; costs one extra "
                        "stats pass, fused with the quantile/top-k pass")
    p.add_argument("--segmenter", choices=("color", "unified", "ade"),
                   default="color")
    p.add_argument("--seg-params", default=None,
                   help="npz of imported segmenter params (the JAX "
                        "package's flat names); never downloaded")
    p.add_argument("--segsizes", type=int, nargs="+", default=[256])
    p.add_argument("--maxiou", action="store_true",
                   help="per-unit IoU-maximizing thresholds "
                        "(reference --maxiou); writes max_iou.npz")
    p.add_argument("--iqr", action="store_true",
                   help="also run the conditional-quantile/IQR pass")
    p.add_argument("--cov", action="store_true",
                   help="also run the covariance pass")
    p.add_argument("--ace-class", type=int, default=None,
                   help="optimize an ablation for this flat label number")
    p.add_argument("--ace-steps", type=int, default=50)
    p.add_argument("--rank-all-labels", action="store_true",
                   help="report top units per LABEL (reference "
                        "--rank_all_labels), not just per-unit best labels")
    p.add_argument("--examples", type=int, default=20,
                   help="units shown in the report with top-image examples "
                        "(reference --examples)")
    p.add_argument("--no-images", action="store_true")
    p.add_argument("--no-labels", action="store_true",
                   help="skip the segmentation/label tally; rank units by "
                        "top activation instead (reference --no-labels)")
    p.add_argument("--no-report", action="store_true",
                   help="write dissect.json + npz data but skip the HTML "
                        "summary and unit images (reference --no-report)")
    p.add_argument("--netname", default=None,
                   help="display name used in the report "
                        "(reference --netname)")
    p.add_argument("--workers", type=int, default=None,
                   help="decode threads for dataset loaders in --features/"
                        "--imagedir modes (reference --num_workers; default "
                        "min(8, cpus) or GANSPACE_LOADER_WORKERS)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress progress prints (reference --quiet)")
    p.add_argument("--meta", nargs="+", default=None, metavar="FILE",
                   help="json file(s) of metadata to attach to the report "
                        "(reference --meta)")
    p.add_argument("--merge", default=None, metavar="FILE",
                   help="json file of per-unit data to merge into the "
                        "report — {'layers': [{'layer': L, 'units': "
                        "[{...}, ...]}]}, units in unit order (reference "
                        "--merge; e.g. mark units uninterpretable from an "
                        "outside analysis)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="after dissecting, serve the (last) layer's report "
                        "+ live-edit viewer on this port")
    p.add_argument("--done-dir", default=None,
                   help="job directory for at-most-once sweep claiming")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu); cuda refuses "
                        "to fall back to the CPU")
    return p


def make_segmenter(args, device):
    """The ``--segmenter`` on ``device``: ``color``, or the unified or ADE
    net with the ``--seg-params`` weights (seeded random ones without)."""
    if args.segmenter == "color":
        from ganspace_tpu_torch.dissection import ColorSegmenter
        return ColorSegmenter()
    params = None
    if args.seg_params:
        with np.load(args.seg_params) as data:
            params = {k: data[k] for k in data.files}
    if args.segmenter == "ade":
        from ganspace_tpu_torch.dissection.segmenter import SemanticSegmenter
        return SemanticSegmenter(params=params, segsizes=tuple(args.segsizes), device=device)
    from ganspace_tpu_torch.dissection import UnifiedParsingSegmenter
    return UnifiedParsingSegmenter(params=params, segsizes=tuple(args.segsizes),
                                   device=device)


def _rank_all_labels(report, k: int) -> None:
    """Top-k units per LABEL (reference --rank_all_labels) from the report's
    IoU matrix; attaches ``report["label_rankings"]``."""
    iou = report["iou_matrix"]          # [U, L]
    k = min(k, iou.shape[0])
    rankings = []
    for l, label in enumerate(report["labels"]):
        if not np.any(iou[:, l] > 0):
            continue
        top = np.argsort(-iou[:, l])[:k]
        rankings.append({"label": label,
                         "units": [int(u) for u in top],
                         "ious": [round(float(iou[u, l]), 5) for u in top]})
    report["label_rankings"] = rankings


def _label_histogram(m: np.ndarray, n_labels: int) -> np.ndarray:
    """Pixel counts per label for one segmentation map [H,W] or [C,H,W]:
    each pixel counts once per label it carries, and background (0) only
    where NO channel labels the pixel."""
    if m.ndim == 3:
        per_label = np.zeros(n_labels, np.int64)
        for c in range(m.shape[0]):
            per_label += np.bincount(m[c].ravel(),
                                     minlength=n_labels)[:n_labels]
        per_label[0] = int(np.sum(~np.any(m > 0, axis=0)))
        return per_label
    return np.bincount(m.ravel(), minlength=n_labels)[:n_labels]


def _apply_meta_merge(report, args) -> None:
    """Attach --meta metadata and merge --merge per-unit records (reference
    ``dissection.py:171-175,307-318``): merge units are positional in unit
    order within the matching layer entry."""
    if args.meta:
        meta = {}
        for mf in args.meta:
            meta.update(json.loads(Path(mf).read_text()))
        report["meta"] = meta
    if args.merge:
        data = json.loads(Path(args.merge).read_text())
        lrec = next((l for l in data.get("layers", [])
                     if l.get("layer") == report["layer"]), None)
        by_unit = sorted(report["units"], key=lambda r: r["unit"])
        for u, urec in enumerate(lrec.get("units", []) if lrec else []):
            if u < len(by_unit):
                by_unit[u].update(urec)


def _import_spec(spec: str):
    """``pkg.mod:attr`` -> the attribute (an explicit import path in place
    of the reference's ``autoimport_eval`` of a Python expression)."""
    import importlib

    mod, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(f"--features must be MODULE:ATTR, got {spec!r}")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _dissect_classifier_cli(args, outroot: Path, device) -> int:
    """Classifier mode (reference ``ClassifierSegRunner``,
    ``netdissect/dissection.py:1529``): per-unit quantile thresholds over the
    dataset, then IoU of thresholded upsampled unit masks vs the broden
    ground-truth label maps."""
    if not isinstance(args.quantile, float):
        # validate flags before any dataset/model IO
        build_parser().error(
            "--quantile iqr/maxiou (per-unit threshold search) is only "
            "available in GAN-mode dissection; classifier mode takes a "
            "fixed quantile")

    from ganspace_tpu_torch.dissection.broden import BrodenDataset
    from ganspace_tpu_torch.dissection.report import generate_report
    from ganspace_tpu_torch.dissection.runners import dissect_classifier

    factory = _import_spec(args.features)
    ds = BrodenDataset(args.broden)
    categories = [ds.label_category.get(n, "-")
                  for n in range(len(ds.labels))]
    lq = args.quantile
    say = (lambda *a, **k: None) if args.quiet else print
    for layer_arg in (args.layer or [None]):
        layer, _, display = (layer_arg or "").partition(":")
        display = display or layer
        features_fn = factory(layer or None)
        outdir = outroot if not layer \
            else outroot / display.replace("/", "_")
        say(f"dissecting {args.features}[{layer or 'features'}] "
            f"vs {args.broden} -> {outdir}")
        sampler = None
        if args.sample_seed is not None:
            from ganspace_tpu_torch.dissection.sampler import FixedRandomSubsetSampler
            sampler = FixedRandomSubsetSampler(ds, end=args.samples,
                                               seed=args.sample_seed)
        report = dissect_classifier(
            features_fn, ds, ds.labels, categories=categories,
            batch=args.batch, level_quantile=lq, limit=args.samples,
            workers=args.workers, sampler=sampler, device=device)
        if layer:
            report["layer"] = display
        if args.netname:
            report["model"] = args.netname
        if args.rank_all_labels:
            _rank_all_labels(report, args.examples)
        _apply_meta_merge(report, args)
        html = generate_report(report, outdir, inst=None,
                               n_units=args.examples,
                               html_summary=not args.no_report)
        say(f"report: {html}")
    return 0


def _segment_imagedir(args, segmenter, outroot: Path, device) -> int:
    """Image-only runner (reference ``ImageOnlySegRunner``,
    ``dissection.py:1505``): per-image colorized segmentations + label
    pixel histogram for a directory of images."""
    from PIL import Image

    from ganspace_tpu_torch.dissection.broden import ParallelImageFolders
    from ganspace_tpu_torch.dissection.runners import segment_dataset
    from ganspace_tpu_torch.dissection.viz import segment_visualization
    from ganspace_tpu_torch.tools.lightbox import write_lightbox

    to_chw = lambda a: np.transpose(  # noqa: E731
        np.asarray(a, np.float32) / 255.0, (2, 0, 1))
    ds = ParallelImageFolders([args.imagedir], transforms=[to_chw])
    maps = segment_dataset(segmenter, ds, batch=args.batch,
                           limit=args.samples, workers=args.workers, device=device)
    outroot.mkdir(parents=True, exist_ok=True)
    labels, _ = segmenter.get_label_and_category_names()
    counts = np.zeros(len(labels), np.int64)
    for m, key in zip(maps, ds.keys):
        m = np.asarray(m)
        counts += _label_histogram(m, len(labels))
        rgb = (segment_visualization(m) * 255).astype(np.uint8)
        # Keys are already extension-less; .stem here would merge distinct
        # dotted names (photo.2024/photo.2025 -> photo) and overwrite.
        name = str(key).replace("/", "__")
        Image.fromarray(rgb).save(outroot / f"seg_{name}.png")
    (outroot / "labels.json").write_text(json.dumps(
        [{"label": str(l), "pixels": int(c)}
         for l, c in zip(labels, counts) if c], indent=2))
    write_lightbox(outroot, title=f"segmentations: {args.imagedir}")
    if not args.quiet:
        print(f"segmented {len(maps)} images -> {outroot}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.serve is not None and (args.features or args.broden or args.imagedir):
        build_parser().error("--serve needs a generator session; it is not "
                             "available in --features/--imagedir modes")
    if args.done_dir:
        from ganspace_tpu_torch.utils import exit_if_job_done
        exit_if_job_done(args.done_dir)

    from ganspace_tpu_torch import require_device
    from ganspace_tpu_torch.ops.precision import ieee_f32

    device = require_device(args.device)
    with ieee_f32():
        rc, session = _run(args, device)
    if args.done_dir:
        from ganspace_tpu_torch.utils import mark_job_done
        mark_job_done(args.done_dir)
    if session is not None:
        from ganspace_tpu_torch.dissection.server import serve
        serve(session, port=args.serve)
    return rc


def _run(args, device):
    """The command's work: (exit code, the last layer's
    ``DissectionSession`` when ``--serve`` is given, else None)."""
    from ganspace_tpu_torch.dissection.dissect import (
        DeviceClock, collect_covariance, collect_stats_and_cond_quantiles, dissect,
        iqr_max_scores, load_stats_cache, maxiou_scores, save_stats_cache, tally_stats,
    )
    from ganspace_tpu_torch.dissection.report import generate_report
    from ganspace_tpu_torch.models import get_instrumented_model

    outroot = Path(args.outdir)
    if args.features or args.broden:
        if not (args.features and args.broden):
            build_parser().error("--features and --broden go together")
        return _dissect_classifier_cli(args, outroot, device), None

    segmenter = make_segmenter(args, device)
    if args.imagedir:
        return _segment_imagedir(args, segmenter, outroot, device), None
    if not args.layer:
        build_parser().error("--layer is required unless --imagedir or "
                             "--features is given")

    say = (lambda *a, **k: None) if args.quiet else print
    last_session = None
    for layer_arg in args.layer:
        # NAME:DISPLAY aliases (reference --layers strpair): the display
        # name labels the output directory and report; the real module
        # path addresses the tap point.
        layer, _, display = layer_arg.partition(":")
        display = display or layer
        inst = get_instrumented_model(args.model, args.output_class, layer,
                                      device=device)
        outdir = outroot / display.replace("/", "_")
        say(f"dissecting {args.model}/{layer} -> {outdir}")

        if args.no_labels:
            # Reference --no-labels: skip the segmentation tally entirely;
            # report units ranked by their top activation.
            if isinstance(args.quantile, str) or args.iqr or args.maxiou \
                    or args.cov or args.ace_class is not None:
                build_parser().error(
                    "--no-labels skips segmentation; it cannot combine with "
                    "--quantile iqr/maxiou, --iqr, --maxiou, --cov, or "
                    "--ace-class")
            prov = {"model": args.model, "class": str(args.output_class),
                    "layer": layer, "n": args.samples, "batch": args.batch,
                    "seed": args.seed}
            cache_path = outdir / "stats_cache.npz"
            layer_stats, _ = load_stats_cache(cache_path, prov)
            if layer_stats is None:
                with DeviceClock(device) as clock:
                    layer_stats = tally_stats(inst, layer, n_samples=args.samples,
                                              batch=args.batch, seed=args.seed)
                say(f"pass stats: {clock.seconds:.3f} s "
                    f"(sketch {layer_stats['sketch_seconds']:.3f} s)")
                save_stats_cache(cache_path, layer_stats, None, prov)
            else:
                say(f"reusing cached stats: {cache_path}")
            levels = layer_stats["quantiles"].quantiles(args.quantile)[:, 0]
            units = [{
                "unit": int(u),
                "label": "-", "category": "-", "iou": 0.0,
                "activation_level": float(levels[u]),
                "top_samples": [int(s) for s in
                                layer_stats["topk_samples"][u]],
                "top_values": [float(v) for v in
                               layer_stats["topk_values"][u]],
            } for u in range(layer_stats["units"])]
            units.sort(key=lambda r: -r["top_values"][0])
            report = {
                "layer": display,
                "model": args.netname or args.model,
                "n_samples": args.samples, "batch": args.batch,
                "seed": args.seed, "level_quantile": args.quantile,
                "labels": [], "units": units,
            }
            _apply_meta_merge(report, args)
            with DeviceClock(device) as clock:
                out = generate_report(report, outdir,
                                      inst=None if args.no_images else inst,
                                      n_units=args.examples,
                                      html_summary=not args.no_report)
            say(f"pass report: {clock.seconds:.3f} s")
            say(f"report: {out}")
            if args.serve is not None:
                from ganspace_tpu_torch.dissection.server import DissectionSession
                last_session = DissectionSession(inst, layer, report, outdir=outdir,
                                                 stats=layer_stats)
            continue

        # One conditional-quantile pass feeds every consumer: string
        # --quantile modes (per-unit thresholds), --iqr, and --maxiou.
        # When one is wanted, the fused pass streams ONE synthesis sweep
        # into both the stats and the conditional sketches.  The passes
        # cache and resume, keyed on the exact draw geometry.
        per_unit_levels = None
        stats = None
        need_cond = isinstance(args.quantile, str) or args.iqr or args.maxiou
        prov = {"model": args.model, "class": str(args.output_class),
                "layer": layer, "n": args.samples, "batch": args.batch,
                "seed": args.seed, "segmenter": args.segmenter,
                "seg_params": str(args.seg_params),
                "segsizes": str(tuple(args.segsizes))}
        cache_path = outdir / "stats_cache.npz"
        cached_stats, cached_cond = load_stats_cache(cache_path, prov)
        if need_cond:
            if cached_stats is not None and cached_cond is not None:
                say(f"reusing cached stats: {cache_path}")
                layer_stats, stats = cached_stats, cached_cond
            else:
                with DeviceClock(device) as clock:
                    layer_stats, stats = collect_stats_and_cond_quantiles(
                        inst, layer, segmenter, n_samples=args.samples,
                        batch=args.batch, seed=args.seed)
                say(f"pass stats+conditional: {clock.seconds:.3f} s (sketches "
                    f"{layer_stats['sketch_seconds']:.3f} s raw, "
                    f"{stats['sketch_seconds']:.3f} s upsampled)")
                save_stats_cache(cache_path, layer_stats, stats, prov)
        else:
            if cached_stats is not None:
                say(f"reusing cached stats: {cache_path}")
                layer_stats = cached_stats
            else:
                with DeviceClock(device) as clock:
                    layer_stats = tally_stats(inst, layer, n_samples=args.samples,
                                              batch=args.batch, seed=args.seed)
                say(f"pass stats: {clock.seconds:.3f} s "
                    f"(sketch {layer_stats['sketch_seconds']:.3f} s)")
                save_stats_cache(cache_path, layer_stats, None, prov)
        # Each level search runs at most once even when the same criterion
        # is wanted both for thresholds (--quantile iqr/maxiou) and for
        # reporting (--iqr/--maxiou) — it is a full O(U*K*L) sketch sweep.
        searches = {}

        def level_search(kind):
            if kind not in searches:
                searches[kind] = (iqr_max_scores(stats) if kind == "iqr"
                                  else maxiou_scores(stats))
            return searches[kind]

        if isinstance(args.quantile, str):
            # Per-unit levels at each unit's best label under the chosen
            # criterion: 'iqr' = information-quality-ratio search (the
            # reference GAN default, dissection.py:102-115), 'maxiou' =
            # IoU search.
            lv = level_search(args.quantile)
            score_key, level_key = (("max_iqr", "max_iqr_level")
                                    if args.quantile == "iqr"
                                    else ("max_iou", "max_iou_level"))
            best = np.argmax(lv[score_key], axis=1)
            rows = np.arange(len(best))
            per_unit_levels = lv[level_key][rows, best]

        tally_path = outdir / "tally_cache.npz"
        before = tally_path.stat().st_mtime_ns if tally_path.is_file() else None
        with DeviceClock(device) as clock:
            report = dissect(inst, layer, segmenter, n_samples=args.samples,
                             batch=args.batch, seed=args.seed,
                             level_quantile=(0.995 if per_unit_levels is not None
                                             else args.quantile),
                             stats=layer_stats, levels=per_unit_levels,
                             cache_path=tally_path, cache_provenance=prov)
        if before is not None and tally_path.stat().st_mtime_ns == before:
            say(f"reusing cached tally: {tally_path}")
        else:
            say(f"pass tally: {clock.seconds:.3f} s")
        report["layer"] = display
        if args.netname:
            report["model"] = args.netname
        if args.serve is not None:
            from ganspace_tpu_torch.dissection.server import DissectionSession
            last_session = DissectionSession(inst, layer, report, outdir=outdir,
                                             stats=layer_stats)

        if args.iqr:
            # Information-quality-ratio level search (reference collect_iqr
            # via iqr.npz); each unit reports its best label under max IQR.
            iq = level_search("iqr")
            outdir.mkdir(parents=True, exist_ok=True)
            np.savez(outdir / "iqr.npz", **iq)       # reference field names
            best = np.argmax(iq["max_iqr"], axis=1)
            for rec in report["units"]:
                u = rec["unit"]
                rec["iqr_label"] = report["labels"][int(best[u])]
                rec["iqr_score"] = float(iq["max_iqr"][u, best[u]])
                rec["iqr_level"] = float(iq["max_iqr_level"][u, best[u]])
                rec["iqr_quantile"] = float(
                    iq["max_iqr_quantile"][u, best[u]])
                rec["iqr_agreement"] = float(
                    iq["max_iqr_agreement"][u, best[u]])
        if args.maxiou:
            mi = level_search("maxiou")
            outdir.mkdir(parents=True, exist_ok=True)
            np.savez(outdir / "max_iou.npz", **mi)   # reference field names
            best = np.argmax(mi["max_iou"], axis=1)
            for rec in report["units"]:
                u = rec["unit"]
                rec["maxiou_label"] = report["labels"][int(best[u])]
                rec["maxiou"] = float(mi["max_iou"][u, best[u]])
                rec["maxiou_level"] = float(mi["max_iou_level"][u, best[u]])
                rec["maxiou_quantile"] = float(
                    mi["max_iou_quantile"][u, best[u]])
        if args.rank_all_labels:
            _rank_all_labels(report, args.examples)
        if args.cov:
            with DeviceClock(device) as clock:
                cov = collect_covariance(inst, layer, segmenter, n_samples=args.samples,
                                         batch=args.batch, seed=args.seed)
            say(f"pass covariance: {clock.seconds:.3f} s")
            outdir.mkdir(parents=True, exist_ok=True)
            np.save(outdir / "correlation.npy", cov["correlation"])

        _apply_meta_merge(report, args)
        with DeviceClock(device) as clock:
            html = generate_report(report, outdir,
                                   inst=None if args.no_images else inst,
                                   n_units=args.examples, html_summary=not args.no_report)
        say(f"pass report: {clock.seconds:.3f} s")
        say(f"report: {html}")

        if args.ace_class is not None:
            _ace(args, inst, layer, segmenter, report, outdir, device, say)
    return 0, last_session


def _ace(args, inst, layer, segmenter, report, outdir: Path, device, say) -> None:
    """``--ace-class``: optimise the ablation, measure the effect of
    ablating the top units by ACE's ranking and by IoU with the class, and
    write ``ace.json`` and the ACE page."""
    from ganspace_tpu_torch.dissection import ace
    from ganspace_tpu_torch.dissection.dissect import DeviceClock
    from ganspace_tpu_torch.dissection.report import generate_ace_report

    with DeviceClock(device) as clock:
        result = ace.ace_optimize(inst, layer, segmenter, args.ace_class,
                                  steps=args.ace_steps, seed=args.seed, progress=True)
    say(f"pass ace: {clock.seconds:.3f} s")
    # the comparison ranking: units by IoU with the target class
    # (reference aceplotablate.py: 'Units by ACE' vs 'Top units by IoU')
    iou_rank = np.argsort(-report["iou_matrix"][:, args.ace_class])
    with DeviceClock(device) as clock:
        effect = ace.ablation_effect(inst, layer, segmenter, args.ace_class,
                                     result["ranking"])
        iou_effect = ace.ablation_effect(inst, layer, segmenter, args.ace_class, iou_rank)
    say(f"pass ace effect: {clock.seconds:.3f} s")
    (outdir / "ace.json").write_text(json.dumps({
        "classnum": result["classnum"],
        "baseline": result["baseline"],
        "ablation": result["ablation"].tolist(),
        "ranking": result["ranking"].tolist(),
        "loss_history": result["loss_history"],
        "ablation_effect": effect,
        "iou_ablation_effect": iou_effect,
    }, indent=2))
    classname = report["labels"][args.ace_class]
    ace_html = generate_ace_report(
        outdir, classname, {"ace": result},
        {"Units by ACE": effect, "Top units by IoU": iou_effect})
    say(f"ace: baseline {result['baseline']:.5f}, "
        f"effect@top8 {effect.get(8, float('nan')):.5f}; report: {ace_html}")


if __name__ == "__main__":
    sys.exit(main())
