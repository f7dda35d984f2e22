"""GAN-dissection engine (reference ``netdissect/dissection.py``).

Counterpart of ``ganspace_tpu/dissection/dissect.py``.  It quantifies what
individual convolutional units of a generator encode:

  1. **stats pass** — stream N generated samples, collecting per-unit
     activation quantiles (level-compaction sketch) and per-unit top-k
     images (reference ``collect_quantiles_and_topk``, ``dissection.py:680``);
  2. **tally pass** — threshold each unit at a top quantile, upsample the
     unit mask to image resolution, and accumulate intersection/union
     counts against a semantic segmentation of the same images (reference
     ``collect_bincounts``/IoU scoring, ``dissection.py:743,1008``);
  3. **report** — per-unit best-matching concept + IoU (see ``report.py``).

Every pass runs the generator's full forward on its device (the segmenter
needs the image), so on the card each batch goes through the synthesis
kernels.  Activations stay on the device from the generator to the
sketches: only per-label pixel counts (which the per-label loop needs) and
the final results come back to the host.  Upsampled maps at image size are
made in slabs of images sized from the free device memory (one float32
[16, 512, 1024, 1024] batch is 34 GB), so no configuration needs a smaller
batch than the JAX package takes.

The label sampler's Gumbel noise comes from a device stream of its own
(:func:`label_noise`: Philox on the card, the CPU generator on the CPU), so
its draws differ from the JAX package's and between devices; tests swap
:func:`label_noise` for JAX's draws.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ganspace_tpu_torch.dissection.viz import resize
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops.precision import ieee_f32
from ganspace_tpu_torch.sampling import STREAM_LABELS, block_generator, gumbel
from ganspace_tpu_torch.stats import (
    RunningConditionalQuantile, RunningCrossCovariance, RunningQuantile,
)

#: the share of the free device memory one slab of upsampled maps may take
SLAB_MEMORY_SHARE = 0.5


def upsample_grid(act: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample of unit activations [B, U, h, w] to image ``size``
    (reference ``upsample_grid``, ``dissection.py:1322``)."""
    return resize(act, size, "bilinear")


def image_slabs(n: int, per_image_bytes: int, device) -> Iterator[Tuple[int, int]]:
    """[i0, i1) ranges covering ``n`` images, each slab's working set at
    most ``SLAB_MEMORY_SHARE`` of the free device memory (the whole batch
    at once on the CPU)."""
    device = torch.device(device)
    step = n
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        step = max(1, min(n, int(free * SLAB_MEMORY_SHARE) // max(per_image_bytes, 1)))
    for i0 in range(0, n, step):
        yield i0, min(n, i0 + step)


class DeviceClock:
    """Seconds spent inside ``with clock:`` blocks, the device synchronized
    at both ends (on the CPU, host time)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds += time.perf_counter() - self._t0


class SegmenterBase:
    """Protocol (reference ``BaseSegmenter``, ``netdissect/segmenter.py:11``)."""

    def get_label_and_category_names(self) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def segment_batch(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 3, H, W] in [0,1] -> integer labels [B, H, W], or
        multi-channel [B, C, H, W] when a pixel carries one label per
        category (object/part/material), as the unified-parsing segmenter
        returns."""
        raise NotImplementedError

    def class_probability(self, images: torch.Tensor,
                          classnum: int) -> torch.Tensor:
        """Differentiable per-pixel probability [B, H, W] of one flat label
        (the ACE objective's signal).  Optional — only segmenters used with
        ACE need it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose class probabilities")

    def _check_classnum(self, classnum: int) -> None:
        """Validate a flat label index against ``self.labels``."""
        if not 1 <= classnum < len(self.labels):
            raise ValueError(
                f"classnum {classnum} out of range (flat label 0 is '-'; "
                f"valid classes are 1..{len(self.labels) - 1})")

    def _check_not_divided(self, classnum: int) -> None:
        """Quadrant-divided pseudo-labels (``segdiv='quad'``) are hard
        label-map constructs with no differentiable probability."""
        div_base = getattr(self, "_div_base", None)
        if div_base is not None and classnum >= div_base:
            raise ValueError(
                f"classnum {classnum} ('{self.labels[classnum]}') is a "
                f"subdivided quadrant label; class probabilities exist only "
                f"for base labels (< {div_base})")


class ColorSegmenter(SegmenterBase):
    """Checkpoint-free segmenter: nearest-anchor color quantization.

    Labels pixels by their nearest anchor in RGB space — enough structure
    for the IoU machinery to find genuinely color-selective units, and fully
    offline.  Swap in a semantic segmenter for concept-level dissection.
    """

    ANCHORS = np.array([
        [0.05, 0.05, 0.05], [0.95, 0.95, 0.95], [0.8, 0.15, 0.15],
        [0.15, 0.8, 0.15], [0.15, 0.15, 0.8], [0.85, 0.85, 0.2],
        [0.8, 0.4, 0.1], [0.55, 0.3, 0.6], [0.5, 0.5, 0.5],
    ], np.float32)
    NAMES = ["black", "white", "red", "green", "blue", "yellow",
             "orange", "purple", "gray"]

    def get_label_and_category_names(self):
        return list(self.NAMES), ["color"] * len(self.NAMES)

    def _distances(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, anchors] squared RGB distances, one channel at a time
        (no [B, H, W, anchors, 3] temporary)."""
        anchors = torch.as_tensor(self.ANCHORS, device=images.device)
        d = None
        for c in range(3):
            t = torch.square(images[:, c, :, :, None] - anchors[:, c])
            d = t if d is None else d + t
        return d

    def segment_batch(self, images):
        return torch.argmin(self._distances(torch.as_tensor(images)), dim=-1)

    def class_probability(self, images, classnum, tau: float = 0.02):
        """Softmax over negative anchor distances — a differentiable
        relaxation of the hard nearest-anchor assignment."""
        d = self._distances(torch.as_tensor(images))
        return torch.softmax(-d / tau, dim=-1)[..., classnum]


def _acts_and_image(inst: InstrumentedModel, layer: str, z) -> Tuple[torch.Tensor, torch.Tensor]:
    inst.retain_layer(layer)
    img = inst.model.forward(z)
    act = inst.retained_features()[layer]
    if act.ndim == 2:
        act = act[:, :, None, None]
    return act.float(), torch.clamp(img.float(), 0.0, 1.0)


def _batches(model, n_samples: int, batch: int, seed: int):
    """(start, latents) of every batch of a pass: the host stream at
    ``seed + start``, reseeded as the JAX package reseeds numpy."""
    model.seed_host_rng(seed)
    for start in range(0, n_samples, batch):
        b = min(batch, n_samples - start)
        yield start, model.sample_latent(b, seed=seed + start)


def _flatten_seg(seg: torch.Tensor) -> torch.Tensor:
    """[B,H,W] or [B,C,H,W] -> [B,C,H,W] (C=1 for single-channel)."""
    return seg[:, None] if seg.ndim == 3 else seg


def label_presence(seg: torch.Tensor, n_labels: int) -> torch.Tensor:
    """[B, C, H, W] integer labels -> bool [B, L, H*W]: whether the pixel
    carries label l in any channel (the max over channels of the one-hots;
    labels outside [0, L) carry none)."""
    b, c = seg.shape[:2]
    flat = seg.reshape(b, c, -1).long()
    out = torch.zeros((b, n_labels, flat.shape[2]), dtype=torch.bool, device=seg.device)
    for ch in range(c):
        lab = flat[:, ch:ch + 1]
        ok = (lab >= 0) & (lab < n_labels)
        hit = torch.zeros_like(out).scatter_(1, torch.where(ok, lab, 0), ok)
        out |= hit
    return out


class _StatsAccum:
    """Per-unit quantile sketch + top-k (value, sample index) accumulator —
    the shared per-batch body of :func:`tally_stats` and the fused pass."""

    def __init__(self, k_top: int, samplesize: int):
        self.k_top = k_top
        self.samplesize = samplesize
        self.rq: Optional[RunningQuantile] = None
        self.topk_val: Optional[torch.Tensor] = None   # [U, k]
        self.topk_idx: Optional[torch.Tensor] = None
        self.clock: Optional[DeviceClock] = None

    def update(self, act: torch.Tensor, start: int) -> None:
        """act [B,U,h,w]; ``start`` = global index of the batch's first
        sample (merged into the top-k index lists)."""
        bsz, units = act.shape[0], act.shape[1]
        if self.rq is None:
            self.rq = RunningQuantile(samplesize=self.samplesize)
            self.topk_val = torch.full((units, self.k_top), -torch.inf, device=act.device)
            self.topk_idx = torch.zeros((units, self.k_top), dtype=torch.int64,
                                        device=act.device)
            self.clock = DeviceClock(act.device)
        with self.clock:
            self.rq.add_columns([act.transpose(0, 1).reshape(units, -1)],
                                act[0, 0].numel() * bsz)
        # merge per-image maxima into the top-k (value, sample index) lists
        per_image_max = torch.amax(act.reshape(bsz, units, -1), dim=2)
        cand_val = torch.cat([self.topk_val, per_image_max.T], dim=1)
        cand_idx = torch.cat(
            [self.topk_idx, torch.arange(start, start + bsz, device=act.device)
             .expand(units, bsz)], dim=1)
        self.topk_val, order = torch.topk(cand_val, self.k_top, dim=1)
        self.topk_idx = torch.gather(cand_idx, 1, order)

    def result(self, *, seed: int, batch: int, n_samples: int) -> Dict:
        return {"quantiles": self.rq, "topk_values": self.topk_val.cpu().numpy(),
                "topk_samples": self.topk_idx.cpu().numpy(),
                "units": self.topk_val.shape[0],
                # RNG geometry, so sample indices regenerate faithfully
                "seed": seed, "batch": batch, "n_samples": n_samples,
                "sketch_seconds": self.clock.seconds}


@torch.no_grad()
def tally_stats(inst: InstrumentedModel, layer: str, *, n_samples: int = 1000,
                batch: int = 16, seed: int = 1, k_top: int = 8,
                samplesize: int = 1024):
    """Stats pass: per-unit quantile sketch + top-k sample indices/values."""
    acc = _StatsAccum(k_top, samplesize)
    for start, z in _batches(inst.model, n_samples, batch, seed):
        act, _ = _acts_and_image(inst, layer, z)
        acc.update(act, start)
    return acc.result(seed=seed, batch=batch, n_samples=n_samples)


def regenerate_sample(model, s: int, *, seed: int, batch: int, n_samples: int):
    """Latent of global sample index ``s``, exactly as the stats passes drew
    it: batches start at multiples of ``batch`` with seed ``seed + start``,
    so ``s`` is row ``s - start`` of its batch.  (Drawing
    ``sample_latent(1, seed=seed + s)`` instead returns an *unrelated*
    latent for any ``s % batch != 0``.)"""
    s = int(s)
    start = (s // batch) * batch
    b = min(batch, n_samples - start)
    z = model.sample_latent(b, seed=seed + start)
    return z[s - start][None]


def label_noise(seed: int, batch_index: int, shape, device) -> torch.Tensor:
    """The label sampler's Gumbel noise for batch ``batch_index`` of a pass
    seeded ``seed``: block ``batch_index`` of the label stream."""
    return gumbel(block_generator(seed, STREAM_LABELS, batch_index, device), shape)


class _CondAccum:
    """Conditional + unconditional sketch accumulator — the shared per-batch
    body of :func:`collect_cond_quantiles` and the fused pass.

    Each batch draws a *fixed* ``pixels_per_label`` pixel sample per present
    label by Gumbel-max over the label mask (the JAX package's static-shape
    formulation of the reference's per-label gathers): the top-P of the
    noise where the label is present, over all pixels of the batch.  Only
    the first min(P, count) are real pixels; the rest are dropped."""

    def __init__(self, labels: List[str], pixels_per_label: int,
                 samplesize: int, seed: int):
        self.labels = labels
        self.n_labels = len(labels)
        self.pixels_per_label = pixels_per_label
        self.seed = seed
        self.cq = RunningConditionalQuantile(samplesize=samplesize)
        self.uncond = RunningQuantile(samplesize=samplesize)
        self.label_px = np.zeros((self.n_labels,), np.float64)
        self.total_px = 0.0
        self.sketch_seconds = 0.0

    def update(self, act: torch.Tensor, img: torch.Tensor,
               segmenter: SegmenterBase, batch_index: int) -> None:
        seg = _flatten_seg(segmenter.segment_batch(img))
        b, u = act.shape[0], act.shape[1]
        size = tuple(seg.shape[-2:])
        hw = size[0] * size[1]
        n_lab, n_pick = self.n_labels, self.pixels_per_label
        present = label_presence(seg, n_lab)                        # [B, L, HW]
        counts = present.sum(dim=(0, 2)).cpu().numpy().astype(np.float64)
        scores = label_noise(self.seed, batch_index, (n_lab, b * hw), act.device)
        scores.masked_fill_(~present.transpose(0, 1).reshape(n_lab, -1), -torch.inf)
        idx = torch.topk(scores, n_pick, dim=1).indices             # [L, P]
        del scores, present
        samples = torch.zeros((n_lab, n_pick, u), device=act.device)
        clock = DeviceClock(act.device)

        def pieces():
            # one slab of upsampled maps feeds the label samples and the
            # unconditional sketch (pixels in (image, row, column) order)
            for i0, i1 in image_slabs(b, 24 * u * hw, act.device):
                up = upsample_grid(act[i0:i1], size).reshape(i1 - i0, u, hw)
                local = idx - i0 * hw
                inside = (local >= 0) & (local < (i1 - i0) * hw)
                local = torch.clamp(local, 0, (i1 - i0) * hw - 1)
                picked = up[local // hw, :, local % hw]             # [L, P, U]
                samples.copy_(torch.where(inside[..., None], picked, samples))
                del picked
                yield up.transpose(0, 1).reshape(u, -1)

        with clock:
            self.uncond.add_columns(pieces(), b * hw)
        self.label_px += counts
        self.total_px += b * hw
        with clock:
            for l in range(n_lab):
                n_px = int(counts[l])
                if n_px == 0:
                    continue
                self.cq.add(l, samples[l, :min(n_pick, n_px)])
        self.sketch_seconds += clock.seconds

    def result(self) -> Dict:
        return {"conditional": self.cq, "unconditional": self.uncond,
                "labels": self.labels,
                "label_fracs": (self.label_px /
                                max(self.total_px, 1.0)).astype(np.float32),
                "sketch_seconds": self.sketch_seconds}


@torch.no_grad()
def collect_cond_quantiles(inst: InstrumentedModel, layer: str,
                           segmenter: SegmenterBase, *, n_samples: int = 256,
                           batch: int = 16, seed: int = 1,
                           pixels_per_label: int = 256,
                           samplesize: int = 1024) -> Dict:
    """Conditional quantile pass (reference ``collect_cond_quantiles``,
    ``dissection.py:878``): per-label sketches of unit activations at pixels
    carrying that label, plus the unconditional sketch."""
    labels, _ = segmenter.get_label_and_category_names()
    acc = _CondAccum(labels, pixels_per_label, samplesize, seed)
    for i, (_, z) in enumerate(_batches(inst.model, n_samples, batch, seed)):
        act, img = _acts_and_image(inst, layer, z)
        acc.update(act, img, segmenter, i)
    return acc.result()


@torch.no_grad()
def collect_stats_and_cond_quantiles(
        inst: InstrumentedModel, layer: str, segmenter: SegmenterBase, *,
        n_samples: int = 256, batch: int = 16, seed: int = 1, k_top: int = 8,
        pixels_per_label: int = 256,
        samplesize: int = 1024) -> Tuple[Dict, Dict]:
    """Fused stats + conditional-quantile pass: ONE synthesis/segmentation
    stream feeds both the per-unit quantile sketch + top-k
    (:func:`tally_stats`) and the per-label conditional sketches
    (:func:`collect_cond_quantiles`), as the JAX package fuses them.

    Returns ``(stats, cond_stats)``, each equal to the separate passes': the
    same per-batch latent seeds, the same flips for each sketch, and the
    same per-batch label noise.
    """
    labels, _ = segmenter.get_label_and_category_names()
    stats_acc = _StatsAccum(k_top, samplesize)
    cond_acc = _CondAccum(labels, pixels_per_label, samplesize, seed)
    for i, (start, z) in enumerate(_batches(inst.model, n_samples, batch, seed)):
        act, img = _acts_and_image(inst, layer, z)
        stats_acc.update(act, start)              # raw-res sketch + top-k
        cond_acc.update(act, img, segmenter, i)   # upsampled sketches
    return (stats_acc.result(seed=seed, batch=batch, n_samples=n_samples),
            cond_acc.result())


def save_stats_cache(path, stats: Optional[Dict] = None,
                     cond: Optional[Dict] = None,
                     provenance: Optional[Dict] = None) -> None:
    """Serialize the stats / conditional-quantile pass results to one npz,
    in the JAX package's layout (``prov_*``, ``rq_*``, ``cond_<l>__*``,
    ``uncond_*``): a cache either package wrote is read by the other.
    :func:`load_stats_cache` reuses it only on an exact provenance match."""
    out = {}
    for k, v in (provenance or {}).items():
        out[f"prov_{k}"] = np.asarray(v)
    if stats is not None:
        for k, v in stats["quantiles"].state_dict().items():
            out[f"rq_{k}"] = v
        out["topk_values"] = stats["topk_values"]
        out["topk_samples"] = stats["topk_samples"]
        for k in ("units", "seed", "batch", "n_samples"):
            out[f"stats_{k}"] = np.int64(stats[k])
    if cond is not None:
        for label_key, sub in cond["conditional"].state_dict().items():
            for k, v in sub.items():
                out[f"cond_{label_key}__{k}"] = v
        for k, v in cond["unconditional"].state_dict().items():
            out[f"uncond_{k}"] = v
        out["labels"] = np.asarray(cond["labels"])
        out["label_fracs"] = cond["label_fracs"]
    _savez_atomic(path, out)


def _savez_atomic(path, arrays: Dict) -> None:
    """np.savez to a sibling temp file, then rename over ``path``: an
    interrupted write never leaves a truncated zip at the cache path."""
    import os
    from pathlib import Path

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # pid-unique, .npz-suffixed (savez appends .npz otherwise) so concurrent
    # writers of the same cache can't interleave into one temp file
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _load_npz_cache(path):
    """np.load a cache file, returning None on ANY unreadable/corrupt file
    (every member read eagerly, so corruption surfaces here)."""
    from pathlib import Path

    path = Path(path)
    if not path.is_file():
        return None
    try:
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files}
    except Exception as e:
        print(f"Warning: ignoring unreadable cache {path} ({e!r}); "
              f"recomputing")
        return None


def load_stats_cache(path, provenance: Dict
                     ) -> Tuple[Optional[Dict], Optional[Dict]]:
    """Inverse of :func:`save_stats_cache`: returns ``(stats, cond)``
    (either may be None) — all None unless every provenance field matches
    the stored one exactly.  The sketches load on the CPU (only read)."""
    data = _load_npz_cache(path)
    if data is None:
        return None, None
    for k, v in provenance.items():
        key = f"prov_{k}"
        if key not in data or str(data[key]) != str(np.asarray(v)):
            return None, None

    try:
        stats = None
        if "topk_values" in data:
            rq = RunningQuantile().set_state_dict(
                {k[len("rq_"):]: data[k] for k in data
                 if k.startswith("rq_")})
            stats = {"quantiles": rq, "topk_values": data["topk_values"],
                     "topk_samples": data["topk_samples"],
                     "units": int(data["stats_units"]),
                     "seed": int(data["stats_seed"]),
                     "batch": int(data["stats_batch"]),
                     "n_samples": int(data["stats_n_samples"])}
        cond = None
        if "label_fracs" in data:
            nested: Dict[str, Dict] = {}
            for k in data:
                if k.startswith("cond_"):
                    label_key, sub = k[len("cond_"):].split("__", 1)
                    nested.setdefault(label_key, {})[sub] = data[k]
            cq = RunningConditionalQuantile().set_state_dict(nested)
            uncond = RunningQuantile().set_state_dict(
                {k[len("uncond_"):]: data[k] for k in data
                 if k.startswith("uncond_")})
            cond = {"conditional": cq, "unconditional": uncond,
                    "labels": [str(l) for l in data["labels"]],
                    "label_fracs": np.asarray(data["label_fracs"])}
    except (KeyError, ValueError) as e:
        print(f"Warning: ignoring malformed stats cache {path} ({e!r}); "
              f"recomputing")
        return None, None
    return stats, cond


def iqr_scores(cond_stats: Dict, quantile: float = 0.5) -> np.ndarray:
    """Median-shift relevance: score[u, l] = (median(act | label l) -
    median(act)) / interquartile-range(act).  A cheap robust effect-size
    ranking; the reference's "IQR" proper is the *information quality ratio*
    — see :func:`iqr_max_scores` and the tally-threshold ``iqr_matrix``
    :func:`dissect` attaches."""
    uncond = cond_stats["unconditional"]
    qs = uncond.quantiles(np.array([0.25, quantile, 0.75]))       # [U, 3]
    iqr = np.maximum(qs[:, 2] - qs[:, 0], 1e-9)
    n_labels = len(cond_stats["labels"])
    units = qs.shape[0]
    out = np.zeros((units, n_labels), np.float32)
    cq = cond_stats["conditional"]
    for l in range(n_labels):
        if not cq.has_conditional(l):
            continue
        med_l = cq.conditional(l).quantiles(quantile)[:, 0]
        out[:, l] = (med_l - qs[:, 1]) / iqr
    return out


def maxiou_scores(cond_stats: Dict, n_levels: int = 100) -> Dict:
    """Per-unit IoU-maximizing thresholds (reference ``collect_maxiou``,
    ``dissection.py:1008``): search ``n_levels`` log-spaced exceedance
    fractions (1e-3..1) and keep, per (unit, label), the threshold with the
    best IoU.  Pure post-processing on the conditional-quantile sketches:

        isect(u, l, k) = P(act_u > level_k | label l) * P(label l)
        union(u, l, k) = P(label l) + P(act_u > level_k) - isect
        max_iou(u, l)  = max_k isect / union

    Returns {"max_iou" [U, L], "max_iou_level" [U, L],
             "max_iou_quantile" [U, L]} (the npz fields of the reference's
    ``max_iou.npz``).
    """
    uncond = cond_stats["unconditional"]
    cq = cond_stats["conditional"]
    label_fracs = np.asarray(cond_stats["label_fracs"], np.float64)
    n_labels = len(cond_stats["labels"])

    fracs = np.logspace(-3, 0, n_levels)             # exceedance fractions
    levels = uncond.quantiles(1.0 - fracs)           # [U, K]
    units = levels.shape[0]
    denom = 1.0 - uncond.normalize(levels)           # [U, K] = P(act > level)

    max_iou = np.zeros((units, n_labels), np.float32)
    max_level = np.zeros((units, n_labels), np.float32)
    max_quantile = np.zeros((units, n_labels), np.float32)
    for l in range(n_labels):
        if not cq.has_conditional(l) or label_fracs[l] <= 0:
            continue
        isect = (1.0 - cq.conditional(l).normalize(levels)) * label_fracs[l]
        union = label_fracs[l] + denom - isect
        iou = isect / np.maximum(union, 1e-30)       # [U, K]
        best = np.argmax(iou, axis=1)                # [U]
        rows = np.arange(units)
        max_iou[:, l] = iou[rows, best]
        max_level[:, l] = levels[rows, best]
        max_quantile[:, l] = fracs[best]
    return {"max_iou": max_iou, "max_iou_level": max_level,
            "max_iou_quantile": max_quantile}


def _information_quality_ratio(a00, a01, a10, a11):
    """MI, joint entropy, and their ratio for a 2x2 contingency table of
    probabilities, elementwise over the trailing dims (reference
    ``mutual_information``/``joint_entropy``/``information_quality_ratio``,
    ``dissection.py:1161-1185``).  0·log0 terms and 0/0 ratios -> 0."""
    arr = np.clip(np.stack([np.stack([a00, a01]), np.stack([a10, a11])]),
                  0.0, 1.0)
    rows = arr.sum(axis=1, keepdims=True)                    # [2,1,...]
    cols = arr.sum(axis=0, keepdims=True)                    # [1,2,...]
    with np.errstate(divide="ignore", invalid="ignore"):
        mi_terms = arr * np.log(arr / (rows * cols))
        je_terms = arr * np.log(arr)
    mi = np.clip(np.nansum(mi_terms, axis=(0, 1)), 0.0, None)
    je = np.clip(-np.nansum(je_terms, axis=(0, 1)), 0.0, None)
    with np.errstate(divide="ignore", invalid="ignore"):
        iqr = mi / je
    iqr = np.where(np.isfinite(iqr), iqr, 0.0)
    return mi, je, iqr


def iqr_max_scores(cond_stats: Dict, n_levels: int = 100,
                   agreement_min: float = 0.8,
                   min_label_frac: float = 1e-3) -> Dict:
    """Per-unit information-quality-ratio-maximizing thresholds (reference
    ``collect_iqr``, ``dissection.py:1049-1159``): search ``n_levels``
    log-spaced exceedance fractions and keep, per (unit, label), the level
    maximizing IQR = MI(unit fires; label present) / H_joint of the 2x2
    contingency table — zeroing candidates whose raw agreement
    P(both) + P(neither) <= ``agreement_min`` or whose activation level is
    <= 0, and distrusting labels rarer than ``min_label_frac``.  Pure
    post-processing on the conditional-quantile sketches.

    Returns the per-(unit, label) [U, L] fields of the reference's
    ``iqr.npz``: {"max_iqr", "max_iqr_level", "max_iqr_quantile",
    "max_iqr_agreement", "max_iqr_iou"}.
    """
    uncond = cond_stats["unconditional"]
    cq = cond_stats["conditional"]
    label_fracs = np.asarray(cond_stats["label_fracs"], np.float64)
    n_labels = len(cond_stats["labels"])

    fracs = np.logspace(-3, 0, n_levels)             # exceedance fractions
    levels = uncond.quantiles(1.0 - fracs)           # [U, K]
    units = levels.shape[0]
    preds = 1.0 - uncond.normalize(levels)           # [U, K] = P(act > level)

    out = {k: np.zeros((units, n_labels), np.float32)
           for k in ("max_iqr", "max_iqr_level", "max_iqr_quantile",
                     "max_iqr_agreement", "max_iqr_iou")}
    rows = np.arange(units)
    for l in range(n_labels):
        if not cq.has_conditional(l) or label_fracs[l] < min_label_frac:
            continue
        truth = label_fracs[l]
        isect = (1.0 - cq.conditional(l).normalize(levels)) * truth  # [U, K]
        union = truth + preds - isect
        _, _, iqr = _information_quality_ratio(
            isect, preds - isect, truth - isect, 1.0 - union)
        iqr[:, -1] = 0.0          # the 1.0 quantile carries no information
        agreement = np.clip(isect, 0, 1) + np.clip(1.0 - union, 0, 1)
        iqr = np.where(agreement <= agreement_min, 0.0, iqr)
        iqr = np.where(levels <= 0.0, 0.0, iqr)
        best = np.argmax(iqr, axis=1)                # [U]
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = isect / union
        iou = np.where(np.isfinite(iou), iou, 0.0)
        out["max_iqr"][:, l] = iqr[rows, best]
        out["max_iqr_level"][:, l] = levels[rows, best]
        out["max_iqr_quantile"][:, l] = fracs[best]
        out["max_iqr_agreement"][:, l] = agreement[rows, best]
        out["max_iqr_iou"][:, l] = iou[rows, best]
    return out


@torch.no_grad()
def collect_covariance(inst: InstrumentedModel, layer: str,
                       segmenter: SegmenterBase, *, n_samples: int = 256,
                       batch: int = 16, seed: int = 1) -> Dict:
    """Unit-activation / label-fraction cross-covariance pass (reference
    ``dissection.py:1187``): streams per-image mean unit activations against
    per-image label pixel fractions through the Chan-stable accumulator."""
    labels, _ = segmenter.get_label_and_category_names()
    n_labels = len(labels)
    rcc = RunningCrossCovariance()
    for _, z in _batches(inst.model, n_samples, batch, seed):
        act, img = _acts_and_image(inst, layer, z)
        seg = _flatten_seg(segmenter.segment_batch(img))
        unit_mean = torch.mean(act.reshape(act.shape[0], act.shape[1], -1), dim=-1)
        frac = torch.mean(label_presence(seg, n_labels).float(), dim=-1)
        rcc.add(unit_mean, frac)
    return {"cross": rcc, "labels": labels,
            "correlation": rcc.correlation()}


def _save_tally_cache(path, provenance: Optional[Dict], levels: np.ndarray,
                      tally) -> None:
    """Cache the tally contingency counts (reference ``bincounts`` npz,
    ``dissection.py:743-765``), keyed on provenance + exact levels."""
    inter, act, seg, total_px = tally
    out = {f"prov_{k}": np.asarray(v) for k, v in (provenance or {}).items()}
    out.update(levels=np.asarray(levels, np.float32), inter=inter,
               act_count=act, seg_count=seg, total_px=np.int64(total_px))
    _savez_atomic(path, out)


def _load_tally_cache(path, provenance: Optional[Dict], levels: np.ndarray):
    """Inverse of :func:`_save_tally_cache`; None unless provenance AND the
    threshold levels match exactly."""
    data = _load_npz_cache(path)
    if data is None:
        return None
    for k, v in (provenance or {}).items():
        key = f"prov_{k}"
        if key not in data or str(data[key]) != str(np.asarray(v)):
            return None
    if "levels" not in data or not np.array_equal(
            data["levels"], np.asarray(levels, np.float32)):
        return None
    try:
        return (data["inter"], data["act_count"], data["seg_count"],
                int(data["total_px"]))
    except (KeyError, ValueError):
        return None


class Tally:
    """Intersection / activation / label pixel counts of thresholded,
    upsampled unit maps against label maps, on the device, summed in
    float64.  Each slab of images is upsampled, thresholded and contracted
    with its label presence by one batched product."""

    def __init__(self, levels, n_labels: int, device):
        self.levels = torch.as_tensor(np.asarray(levels, np.float32), device=device)
        units = self.levels.shape[0]
        self.n_labels = n_labels
        self.inter = torch.zeros((units, n_labels), dtype=torch.float64, device=device)
        self.act_count = torch.zeros((units,), dtype=torch.float64, device=device)
        self.seg_count = torch.zeros((n_labels,), dtype=torch.float64, device=device)
        self.total_px = 0

    def add(self, act: torch.Tensor, seg: torch.Tensor) -> None:
        """act [B, U, h, w], seg [B, H, W] or [B, C, H, W]."""
        seg = _flatten_seg(seg)
        b, u = act.shape[0], act.shape[1]
        size = tuple(seg.shape[-2:])
        hw = size[0] * size[1]
        present = label_presence(seg, self.n_labels).float()       # [B, L, HW]
        for i0, i1 in image_slabs(b, 12 * u * hw, act.device):
            up = upsample_grid(act[i0:i1], size)
            mask = (up > self.levels[None, :, None, None]).float().reshape(i1 - i0, u, hw)
            del up
            with ieee_f32():
                self.inter += torch.bmm(mask, present[i0:i1].transpose(1, 2)).sum(0)
            self.act_count += mask.sum(dim=(0, 2))
        self.seg_count += present.sum(dim=(0, 2))
        self.total_px += b * hw

    def result(self):
        """(inter [U, L], act [U, 1], seg [1, L]) float32, total pixels."""
        f32 = lambda t: t.float().cpu().numpy()  # noqa: E731
        return (f32(self.inter), f32(self.act_count)[:, None],
                f32(self.seg_count)[None, :], self.total_px)


def score_tally(inter_np, act_np, seg_np, total_px):
    """(iou [U, L], iqr [U, L]) of a tally: IoU, and the information quality
    ratio MI/H_joint of the same contingency table (``score_tally_stats``,
    ``dissection.py:661-679``)."""
    union = act_np + seg_np - inter_np
    iou = inter_np / np.maximum(union, 1e-9)
    tp = float(max(total_px, 1))
    _, _, iqr_mat = _information_quality_ratio(
        inter_np / tp, (act_np - inter_np) / tp,
        (seg_np - inter_np) / tp, (tp - union) / tp)
    return iou, iqr_mat.astype(np.float32)


@torch.no_grad()
def dissect(inst: InstrumentedModel, layer: str, segmenter: SegmenterBase, *,
            n_samples: int = 1000, batch: int = 16, seed: int = 1,
            level_quantile: float = 0.995, k_top: int = 8,
            stats: Optional[dict] = None,
            levels: Optional[np.ndarray] = None,
            cache_path=None, cache_provenance: Optional[Dict] = None) -> Dict:
    """Full dissection of one layer; returns the report dict
    (units ranked by best-concept IoU).

    ``levels`` overrides the fixed-quantile unit thresholds with a per-unit
    [U] array — e.g. the IoU-maximizing levels from :func:`maxiou_scores`.

    ``cache_path`` caches the tally counts (the reference's per-pass
    ``bincounts`` npz, ``dissection.py:743-765``), reused only when
    ``cache_provenance`` AND the exact threshold levels match.
    """
    model = inst.model
    stats = stats or tally_stats(inst, layer, n_samples=n_samples, batch=batch,
                                 seed=seed, k_top=k_top)
    units = stats["units"]
    if levels is None:
        levels = stats["quantiles"].quantiles(level_quantile)[:, 0]
        level_desc = level_quantile
    else:
        levels = np.asarray(levels, np.float32).reshape(-1)
        assert levels.shape[0] == units, \
            f"per-unit levels [{levels.shape[0]}] != units [{units}]"
        level_desc = "per-unit"

    labels, categories = segmenter.get_label_and_category_names()
    cached = _load_tally_cache(cache_path, cache_provenance, levels) \
        if cache_path is not None else None
    if cached is not None:
        inter_np, act_np, seg_np, total_px = cached
    else:
        tally = Tally(levels, len(labels), model.device)
        for _, z in _batches(model, n_samples, batch, seed):
            act, img = _acts_and_image(inst, layer, z)
            tally.add(act, segmenter.segment_batch(img))
        inter_np, act_np, seg_np, total_px = tally.result()
        if cache_path is not None:
            _save_tally_cache(cache_path, cache_provenance, levels,
                              (inter_np, act_np, seg_np, total_px))
    iou, iqr_mat = score_tally(inter_np, act_np, seg_np, total_px)

    best = np.argmax(iou, axis=1)
    report_units = []
    for u in range(units):
        report_units.append({
            "unit": int(u),
            "label": labels[int(best[u])],
            "category": categories[int(best[u])],
            "iou": float(iou[u, best[u]]),
            "iqr": float(iqr_mat[u, best[u]]),
            "activation_level": float(levels[u]),
            "top_samples": [int(s) for s in stats["topk_samples"][u]],
            "top_values": [float(v) for v in stats["topk_values"][u]],
        })
    report_units.sort(key=lambda r: -r["iou"])
    return {
        "layer": layer,
        "model": getattr(model, "name", model.model_name),
        "n_samples": n_samples,
        "batch": stats.get("batch", batch),
        "seed": stats.get("seed", seed),
        "level_quantile": level_desc,
        "labels": labels,
        "units": report_units,
        "iou_matrix": iou,
        "iqr_matrix": iqr_mat,
    }
