"""Broden (BRoad and DENsely labeled) dataset reader
(reference ``netdissect/broden.py`` + ``segdata.py`` + ``parallelfolder.py``,
~460 LoC): a copy of ``ganspace_tpu/dissection/broden.py``, host code (PIL
and numpy).

Reads the standard broden1_227/327/384 layout:

    broden1_227/
      index.csv          # one row per image: image path + per-category label refs
      category.csv       # category name, label count
      label.csv          # number,name,category list,frequencies
      images/...         # RGB jpg/png images and label pngs

Label maps are PNGs with the Broden code convention ``label = R + 256 * G``.
A cell in index.csv may hold several ';'-separated label files (multiple
annotation passes) and numeric cells encode a full-image label.

The reference wraps this in a torch ``Dataset`` with prefetching worker
*processes* (``--num_workers 24``, fork + pickle per item); here every
``batches()`` prefetches with an in-process thread pool instead — PIL/zlib
decode releases the GIL, so threads scale on multi-core hosts without fork
or serialization overhead, and batches are assembled into numpy arrays
shipped to the device whole.  The reference's downloader
(``ensure_broden_downloaded``) needs network; this loader only reads a
local tree (tests synthesize one).
"""

from __future__ import annotations

import csv
import os
from collections import deque
from itertools import islice
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _loader_workers() -> int:
    """Decode-thread count (the reference DataLoader's ``num_workers``);
    override with ``GANSPACE_LOADER_WORKERS`` (1 = serial)."""
    env = os.environ.get("GANSPACE_LOADER_WORKERS")
    if env is not None:
        return max(1, int(env))
    return min(8, os.cpu_count() or 1)


def _iter_items(dataset, n: int, workers: Optional[int] = None,
                indices=None):
    """Yield ``dataset[0..n)`` (or ``dataset[i] for i in indices[:n]`` when a
    sampler's index sequence is given) in order, decoding up to 2x``workers``
    items ahead on a thread pool (bounded, so huge datasets never pile up in
    RAM).  Worker exceptions surface at the yield point for the failing
    index."""
    idx = list(range(n)) if indices is None else list(indices)[:n]
    n = len(idx)
    w = _loader_workers() if workers is None else max(1, int(workers))
    if w <= 1 or n <= 1:
        for i in idx:
            yield dataset[i]
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(w) as pool:
        depth = min(2 * w, n)
        futures = deque(pool.submit(dataset.__getitem__, i)
                        for i in idx[:depth])
        next_i = depth
        while futures:
            item = futures.popleft().result()
            if next_i < n:
                futures.append(pool.submit(dataset.__getitem__, idx[next_i]))
                next_i += 1
            yield item


def decode_label_png(arr: np.ndarray) -> np.ndarray:
    """RGB label image [H,W,3] uint8 -> label codes [H,W] (R + 256*G)."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        return arr.astype(np.int32)
    return arr[..., 0].astype(np.int32) + 256 * arr[..., 1].astype(np.int32)


def encode_label_png(codes: np.ndarray) -> np.ndarray:
    """Label codes [H,W] -> RGB uint8 [H,W,3] (inverse of decode)."""
    codes = np.asarray(codes, np.int32)
    out = np.zeros(codes.shape + (3,), np.uint8)
    out[..., 0] = codes % 256
    out[..., 1] = codes // 256
    return out


class BrodenDataset:
    """Iterates (image [3,H,W] float in [0,1], seg [C,H,W] int32 labels,
    record dict) over a broden directory."""

    def __init__(self, directory, categories: Optional[Sequence[str]] = None,
                 size: Optional[int] = None):
        self.dir = Path(directory)
        with open(self.dir / "category.csv") as f:
            cats = [row["name"] for row in csv.DictReader(f)]
        self.categories = [c for c in cats
                           if categories is None or c in categories]
        with open(self.dir / "label.csv") as f:
            rows = list(csv.DictReader(f))
        self.labels = [""] * (max(int(r["number"]) for r in rows) + 1) \
            if rows else []
        self.label_category: Dict[int, str] = {}
        for r in rows:
            n = int(r["number"])
            self.labels[n] = r["name"]
            self.label_category[n] = r["category"].split(";")[0]
        with open(self.dir / "index.csv") as f:
            self.index = list(csv.DictReader(f))
        if size is not None:
            self.index = self.index[:size]

    def __len__(self) -> int:
        return len(self.index)

    def _load_image(self, rel: str) -> np.ndarray:
        from PIL import Image
        img = np.asarray(Image.open(self.dir / "images" / rel).convert("RGB"))
        return np.transpose(img, (2, 0, 1)).astype(np.float32) / 255.0

    def _load_label_cell(self, cell: str, hw: Tuple[int, int]) -> np.ndarray:
        """One index.csv cell -> [H,W] label map (0 where unlabeled)."""
        from PIL import Image
        out = np.zeros(hw, np.int32)
        if not cell:
            return out
        for item in cell.split(";"):
            item = item.strip()
            if not item:
                continue
            if item.isdigit():                  # full-image label
                out[:] = np.where(out == 0, int(item), out)
            else:
                arr = np.asarray(Image.open(self.dir / "images" / item))
                codes = decode_label_png(arr)
                out = np.where(out == 0, codes.astype(np.int32), out)
        return out

    def __getitem__(self, i: int):
        rec = self.index[i]
        img = self._load_image(rec["image"])
        hw = img.shape[1:]
        seg = np.stack([self._load_label_cell(rec.get(c, ""), hw)
                        for c in self.categories])
        return img, seg, rec

    def batches(self, batch_size: int, limit: Optional[int] = None,
                workers: Optional[int] = None, sampler=None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield stacked (images [B,3,H,W], segs [B,C,H,W]) batches; images
        in a batch must share a resolution (broden is fixed-size per split).
        Items decode on a prefetching thread pool (see :func:`_iter_items`).
        ``sampler``: an index sequence (e.g. ``FixedRandomSubsetSampler``)
        selecting WHICH items, in which order; ``limit`` then caps it."""
        avail = len(self) if sampler is None else len(sampler)
        n = avail if limit is None else min(limit, avail)
        it = _iter_items(self, n, workers, indices=sampler)
        while items := list(islice(it, batch_size)):
            yield (np.stack([it_[0] for it_ in items]),
                   np.stack([it_[1] for it_ in items]))

    def primary_categories_per_index(self) -> List[int]:
        """Category index per label number (reference
        ``primary_categories_per_index``)."""
        cat_idx = {c: i for i, c in enumerate(self.categories)}
        return [cat_idx.get(self.label_category.get(n, ""), -1)
                for n in range(len(self.labels))]


def write_synthetic_broden(directory, n_images: int = 4, size: int = 32,
                           categories: Sequence[str] = ("object", "part"),
                           n_labels: int = 8, seed: int = 0) -> Path:
    """Create a tiny valid broden tree (for tests and offline demos)."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    directory = Path(directory)
    (directory / "images").mkdir(parents=True, exist_ok=True)
    with open(directory / "category.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["name", "frequency"])
        w.writeheader()
        for c in categories:
            w.writerow({"name": c, "frequency": n_images})
    with open(directory / "label.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["number", "name", "category", "frequency"])
        w.writeheader()
        for i in range(n_labels):
            w.writerow({"number": i, "name": f"label-{i}",
                        "category": categories[i % len(categories)],
                        "frequency": 1})
    rows = []
    for i in range(n_images):
        img = (rs.rand(size, size, 3) * 255).astype(np.uint8)
        img_rel = f"img_{i}.png"
        Image.fromarray(img).save(directory / "images" / img_rel)
        rec = {"image": img_rel}
        for ci, c in enumerate(categories):
            codes = rs.randint(0, n_labels, (size, size))
            rel = f"seg_{c}_{i}.png"
            Image.fromarray(encode_label_png(codes)).save(
                directory / "images" / rel)
            rec[c] = rel
        rows.append(rec)
    with open(directory / "index.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["image"] + list(categories))
        w.writeheader()
        w.writerows(rows)
    return directory


# ---------------------------------------------------------------------------
# Parallel image folders (reference ``netdissect/parallelfolder.py``)
# ---------------------------------------------------------------------------

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".npy")


def _index_folder(root: Path) -> Dict[str, Path]:
    """{relative-path-sans-extension: file} for every image under root.
    Two files differing only by extension would pair ambiguously — raise
    instead of silently dropping one."""
    out: Dict[str, Path] = {}
    for p in sorted(root.rglob("*")):
        if p.suffix.lower() in _IMAGE_EXTS and p.is_file():
            key = str(p.relative_to(root).with_suffix(""))
            if key in out:
                raise RuntimeError(
                    f"Ambiguous image key '{key}' under {root}: "
                    f"{out[key].name} vs {p.name}")
            out[key] = p
    return out


def _load_any(path: Path) -> np.ndarray:
    if path.suffix.lower() == ".npy":
        return np.load(path)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ParallelImageFolders:
    """Paired samples from parallel directory trees keyed by filename
    (reference ``ParallelImageFolders``, ``parallelfolder.py:19-68``): e.g.
    ``photos/park/0042.jpg`` pairs with ``segs/park/0042.png``.

    ``intersection=False`` demands identical keys in every root (mismatches
    raise, like the reference); ``True`` silently keeps the common subset.
    ``transforms`` is one callable per root (or one shared), applied to the
    loaded numpy arrays.  Iteration yields tuples; ``batches`` stacks them.
    """

    def __init__(self, image_roots: Sequence, transforms=None,
                 intersection: bool = False, size: Optional[int] = None):
        self.roots = [Path(r) for r in image_roots]
        indexes = [_index_folder(r) for r in self.roots]
        keys = set(indexes[0])
        for idx in indexes[1:]:
            keys = keys & set(idx)
        if not intersection:
            for root, idx in zip(self.roots, indexes):
                extra = set(idx) - keys
                if extra:
                    raise RuntimeError(
                        f"Images not found in all folders: {sorted(extra)[:5]}"
                        f" (e.g. under {root})")
        self.keys = sorted(keys)[:size]
        if not self.keys:
            raise RuntimeError(f"Found 0 images within: {image_roots}")
        self.paths = [[idx[k] for idx in indexes] for k in self.keys]
        if transforms is not None and not isinstance(transforms, (list, tuple)):
            transforms = [transforms] * len(self.roots)
        if transforms is not None and len(transforms) != len(self.roots):
            raise ValueError(
                f"{len(transforms)} transforms for {len(self.roots)} roots")
        self.transforms = transforms

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, ...]:
        arrs = [_load_any(p) for p in self.paths[i]]
        if self.transforms is not None:
            arrs = [t(a) if t is not None else a
                    for a, t in zip(arrs, self.transforms)]
        return tuple(arrs)

    def batches(self, batch_size: int, limit: Optional[int] = None,
                workers: Optional[int] = None, sampler=None
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        avail = len(self) if sampler is None else len(sampler)
        n = avail if limit is None else min(limit, avail)
        it = _iter_items(self, n, workers, indices=sampler)
        while items := list(islice(it, batch_size)):
            yield tuple(np.stack([it_[j] for it_ in items])
                        for j in range(len(items[0])))


class FieldDef:
    """One bitfield of a packed segmentation PNG (reference ``segdata.py:6``):
    channel ``index`` of the RGB png, shifted/masked, indexes ``labels``."""

    def __init__(self, field: str, index: int, bitshift: int, bitmask: int,
                 labels: Sequence[str]):
        self.field = field
        self.index = index
        self.bitshift = bitshift
        self.bitmask = bitmask
        self.labels = list(labels)
        self.firstchannel = 0    # assigned by MultiSegmentDataset
        self.channels = len(self.labels) - 1


class MultiSegmentDataset:
    """Images + bitfield-packed multi-category segmentations
    (reference ``segdata.py:14-68``, the CLEVR-seg style layout):

        directory/
          labelnames.json    # [{"field","index","bitshift","bitmask","label"}]
          img/... seg/...    # filename-paired RGB images and packed seg PNGs

    Each field decodes one bit-range of one PNG channel into a per-category
    label plane; planes use a GLOBAL label numbering where 0 = '-' (no
    label) and each field's labels[1:] get consecutive indices.  A field's
    raw value 0 decodes to global 0 (the reference's ``firstchannel + v - 1``
    arithmetic aliases field N's zero onto field N-1's last label; here zero
    uniformly means unlabeled).  The last 25% of the pairs are the
    validation split (``val=True``), like the reference.

    ``__getitem__`` -> (image [3,H,W] float32 in [0,1],
                        seg [n_categories,H,W] int64,
                        bincount [n_labels] int64).
    """

    def __init__(self, directory, imgdir: str = "img", segdir: str = "seg",
                 val: bool = False, size: Optional[int] = None):
        import json

        d = Path(directory)
        self.segdataset = ParallelImageFolders(
            [d / imgdir, d / segdir])
        self.fields: List[FieldDef] = []
        with open(d / "labelnames.json") as f:
            for defn in json.load(f):
                self.fields.append(FieldDef(
                    defn["field"], defn["index"], defn["bitshift"],
                    defn["bitmask"], defn["label"]))
        self.labels = ["-"]              # global label 0 = "no label"
        self.categories: List[str] = []
        self.label_category = [0]
        for fieldnum, fd in enumerate(self.fields):
            self.categories.append(fd.field)
            fd.firstchannel = len(self.labels)
            for lab in fd.labels[1:]:
                self.labels.append(lab)
                self.label_category.append(fieldnum)
        first_val = int(len(self.segdataset) * 0.75)
        self.first = first_val if val else 0
        self.length = (len(self.segdataset) - first_val) if val else first_val
        if size:
            self.length = min(size, self.length)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        img, segimg = self.segdataset[index + self.first]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if img.ndim == 3:
            # CHW, like BrodenDataset (and the reference's tensor transforms)
            # — one image layout across every dataset the runners consume.
            img = np.transpose(img, (2, 0, 1))
        segin = np.asarray(segimg, np.uint8)
        if segin.ndim == 2:
            segin = segin[:, :, None]
        segout = np.zeros((len(self.categories), *segin.shape[:2]), np.int64)
        for i, fd in enumerate(self.fields):
            v = (segin[:, :, fd.index].astype(np.int64)
                 >> fd.bitshift) & fd.bitmask
            # The bitmask covers the channel width, not the label table —
            # decoded values beyond the field's labels (corrupt pixels or a
            # short labelnames.json) are unlabeled, never out-of-table
            # global ids (those would make per-item bincount lengths vary
            # and corrupt the one-hot tallies downstream).
            v = np.where(v >= len(fd.labels), 0, v)
            segout[i] = np.where(v > 0, fd.firstchannel + v - 1, 0)
        bincount = np.bincount(segout.ravel(), minlength=len(self.labels))
        return img, segout, bincount

    def batches(self, batch_size: int, limit: Optional[int] = None,
                workers: Optional[int] = None, sampler=None):
        avail = len(self) if sampler is None else len(sampler)
        n = avail if limit is None else min(limit, avail)
        it = _iter_items(self, n, workers, indices=sampler)
        while items := list(islice(it, batch_size)):
            yield tuple(np.stack([it_[j] for it_ in items]) for j in range(3))
