"""Dissection runners for non-generator sources
(reference ``dissection.py``'s ``ImageOnlySegRunner:1505`` /
``ClassifierSegRunner:1529``); counterpart of
``ganspace_tpu/dissection/runners.py``.

The generator path lives in :func:`dissect.dissect`; these runners cover the
other two reference modes:

* :func:`dissect_classifier` — dissect the units of an arbitrary feature
  extractor (a classifier layer) against a labeled segmentation dataset
  (broden ground truth): per-unit quantiles over dataset images, then IoU of
  thresholded upsampled unit masks vs the label maps.
* :func:`segment_dataset` — the image-only mode: run a segmenter over
  dataset images (no features), returning per-image label maps.

Images go to ``device`` a batch at a time; the features stay there.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ganspace_tpu_torch.dissection.dissect import Tally, score_tally
from ganspace_tpu_torch.stats import RunningQuantile


def _features(features_fn: Callable, images, device) -> torch.Tensor:
    act = torch.as_tensor(features_fn(torch.as_tensor(images, device=device)))
    return act[:, :, None, None] if act.ndim == 2 else act


@torch.no_grad()
def dissect_classifier(features_fn: Callable, dataset, labels: Sequence[str],
                       *, categories: Optional[Sequence[str]] = None,
                       batch: int = 16, level_quantile: float = 0.995,
                       samplesize: int = 1024, limit: Optional[int] = None,
                       workers: Optional[int] = None, sampler=None,
                       device="cuda") -> Dict:
    """``features_fn(images [B,3,H,W] tensor on device) -> activations
    [B,U,h,w]``; ``dataset`` yields (images, seg [B,C,H,W]) via ``.batches``
    (broden).

    Returns the same report dict shape as :func:`dissect.dissect`, so
    ``report.generate_report`` renders it unchanged.
    """
    n_labels = len(labels)
    categories = list(categories) if categories is not None \
        else ["-"] * n_labels

    # Pass 1: per-unit quantiles.  Datasets yield (img, seg) or
    # (img, seg, bincount) tuples (BrodenDataset vs MultiSegmentDataset).
    rq: Optional[RunningQuantile] = None
    n_images = 0
    for images, *_ in dataset.batches(batch, limit=limit, workers=workers, sampler=sampler):
        act = _features(features_fn, images, device)
        u = act.shape[1]
        if rq is None:
            rq = RunningQuantile(samplesize=samplesize)
        rq.add_columns([act.transpose(0, 1).reshape(u, -1)], act[0, 0].numel() * act.shape[0])
        n_images += act.shape[0]
    assert rq is not None, "empty dataset"
    units = rq.units
    levels = rq.quantiles(level_quantile)[:, 0]

    # Pass 2: IoU tally vs ground-truth labels
    tally = Tally(levels, n_labels, device)
    for images, seg, *_ in dataset.batches(batch, limit=limit, sampler=sampler,
                                            workers=workers):
        tally.add(_features(features_fn, images, device),
                  torch.as_tensor(seg, device=device))
    iou, _ = score_tally(*tally.result())
    best = np.argmax(iou, axis=1)
    report_units: List[dict] = []
    for u in range(units):
        report_units.append({
            "unit": int(u),
            "label": str(labels[int(best[u])]),
            "category": str(categories[int(best[u])]),
            "iou": float(iou[u, best[u]]),
            "activation_level": float(levels[u]),
            "top_samples": [],
            "top_values": [],
        })
    report_units.sort(key=lambda r: -r["iou"])
    return {
        "layer": getattr(features_fn, "__name__", "features"),
        "model": "classifier",
        "n_samples": n_images,
        "level_quantile": level_quantile,
        "labels": list(labels),
        "units": report_units,
        "iou_matrix": iou,
    }


@torch.no_grad()
def segment_dataset(segmenter, dataset, *, batch: int = 16,
                    limit: Optional[int] = None,
                    workers: Optional[int] = None,
                    sampler=None, device="cuda") -> List[np.ndarray]:
    """Image-only mode: segment every dataset image; returns label maps."""
    out: List[np.ndarray] = []
    for images, *_ in dataset.batches(batch, limit=limit, workers=workers, sampler=sampler):
        seg = segmenter.segment_batch(torch.as_tensor(images, device=device))
        out.extend(list(seg.cpu().numpy()))
    return out
