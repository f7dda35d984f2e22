"""The unified-parsing and ADE segmenters (reference ``netdissect/segmenter.py``).

Counterpart of ``ganspace_tpu/dissection/segmenter.py``: the UPerNet net
(``segmodel.py``) behind the ``SegmenterBase`` protocol, with a flat label
space spanning the object / part / material categories, inference at each
of ``segsizes`` with the softmax probabilities averaged, the per-class
probability that ACE differentiates, and the reference's ``segdiv='quad'``
quadrant subdivision (host numpy and scipy, :func:`expand_segment_quad`);
and :class:`SemanticSegmenter` over the ADE20K scene-parsing nets.

Weights are located, never downloaded: ``params`` is the JAX package's
flat dict (an imported torch checkpoint, or ``--seg-params``); without it
the nets take the JAX package's seeded random initialisation, value for
value.  The nets run on the segmenter's device (the card unless the caller
names another) in IEEE float32; images stay there from the generator to the
label maps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.dissection.dissect import SegmenterBase
from ganspace_tpu_torch.dissection.segmodel import (
    Params, UPerNet, UPerNetConfig, _np, adaptive_avg_pool, build_segmodel, fold_bn,
    import_torch_resnet, init_upernet_params, resize_bilinear,
)
from ganspace_tpu_torch.ops.precision import ieee_f32

# The reference feeds the net 0-255 BGR images minus the Caffe-era channel
# means (``segmenter.py:146-150``).
_BGR_MEAN = (102.9801, 115.9465, 122.7717)

CATEGORIES = ("object", "part", "material")


def default_label_data(cfg: UPerNetConfig) -> Dict[str, List[str]]:
    """Generic label names used when no labeldata is supplied."""
    return {
        "object": ["-"] + [f"object-{i}" for i in range(1, cfg.n_objects)],
        "part": ["-"] + [f"part-{i}" for i in range(1, cfg.n_parts)],
        "material": ["-"] + [f"material-{i}" for i in range(1, cfg.n_materials)],
        "scene": [f"scene-{i}" for i in range(cfg.n_scenes)],
    }


def _fit_size(x: torch.Tensor, size: int) -> torch.Tensor:
    """The reference's image resize to the eval ``size``: adaptive average
    pooling when the image is at least that large, else bilinear."""
    h, w = x.shape[2:]
    if (h, w) == (size, size):
        return x
    if h >= size and w >= size:
        return adaptive_avg_pool(x, (size, size))
    return resize_bilinear(x, (size, size))


class UnifiedParsingSegmenter(SegmenterBase):
    """Object+part+material segmentation in one flat label space.

    Flat indexing: 0 = '-' (background/unlabeled); object labels follow,
    then part labels, then material labels (each category's own 0 maps to
    flat 0).  ``segment_batch`` returns one label map per category,
    [B, n_categories, H, W]; under ``segdiv='quad'`` two more channels carry
    the quadrant pseudo-labels, appended to the flat space after the
    materials (blocks t, l, b, r)."""

    def __init__(self, cfg: Optional[UPerNetConfig] = None,
                 params: Optional[Params] = None,
                 label_data: Optional[Dict[str, List[str]]] = None,
                 segsizes: Sequence[int] = (256,), seed: int = 0,
                 segdiv: str = "undivided", device="cuda"):
        self.cfg = cfg or UPerNetConfig()
        self.device = require_device(device)
        self.net = UPerNet(self.cfg).params_from_jax(
            params if params is not None else init_upernet_params(self.cfg, seed))
        self.net.to(self.device)
        self.segsizes = tuple(segsizes)
        assert segdiv in ("undivided", "quad")
        self.segdiv = segdiv
        ld = label_data or default_label_data(self.cfg)
        self._cat_labels = {c: list(ld[c]) for c in CATEGORIES}
        self.scene_names = list(ld.get("scene", []))

        self.labels: List[str] = ["-"]
        self.categories: List[str] = ["-"]
        self._flat_offset: Dict[str, int] = {}
        for c in CATEGORIES:
            self._flat_offset[c] = len(self.labels) - 1
            self.labels.extend(self._cat_labels[c][1:])
            self.categories.extend([c] * (len(self._cat_labels[c]) - 1))

        self._div_base = len(self.labels)
        self._n_obj = len(self._cat_labels["object"]) - 1
        if segdiv == "quad":
            for suffix in ("t", "l", "b", "r"):
                self.labels.extend(
                    f"{lab}-{suffix}" for lab in self._cat_labels["object"][1:])
                self.categories.extend(["part"] * self._n_obj)

    def get_label_and_category_names(self) -> Tuple[List[str], List[str]]:
        return list(self.labels), list(self.categories)

    def _probs(self, images: torch.Tensor, size: int,
               channels: Optional[Tuple[str, int]] = None) -> Dict[str, torch.Tensor]:
        """Softmax probabilities per category at eval ``size``, resized back
        to the input resolution.  With ``channels = (category, local)`` only
        that category is returned, as that one channel (the resize works
        channel by channel, so the values are those of the whole map)."""
        h, w = images.shape[2:]
        with ieee_f32():
            x = images.flip(1) * 255.0 - torch.tensor(
                _BGR_MEAN, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
            logits = self.net(_fit_size(x, size))
            if channels is not None:
                cat, local = channels
                p = torch.softmax(logits[cat], dim=1)[:, local:local + 1]
                return {cat: resize_bilinear(p, (h, w))}
            out = {c: resize_bilinear(torch.softmax(logits[c], dim=1), (h, w))
                   for c in CATEGORIES}
            out["scene"] = torch.softmax(logits["scene"], dim=-1)
        return out

    def _averaged(self, images, channels=None) -> Dict[str, torch.Tensor]:
        images = torch.as_tensor(images).to(self.device, torch.float32)
        acc: Dict[str, torch.Tensor] = {}
        for s in self.segsizes:
            for k, v in self._probs(images, int(s), channels).items():
                acc[k] = acc.get(k, 0) + v
        return {k: v / len(self.segsizes) for k, v in acc.items()}

    def category_probabilities(self, images) -> Dict[str, torch.Tensor]:
        """Multi-resolution averaged per-category probabilities
        [B, L_c, H, W] (the reference averages over ``segsizes``)."""
        return self._averaged(images)

    def _flat(self, probs: torch.Tensor, cat: str) -> torch.Tensor:
        lab = torch.argmax(probs, dim=1)
        return torch.where(lab == 0, 0, lab + self._flat_offset[cat])

    def segment_batch(self, images, downsample: int = 1) -> torch.Tensor:
        """images [B,3,H,W] in [0,1] -> flat labels [B, C, H', W'] with
        C = n_categories (+2 quadrant channels under ``segdiv='quad'``)."""
        with torch.no_grad():
            probs = self.category_probabilities(images)
        segs = torch.stack([self._flat(probs[c][:, :, ::downsample, ::downsample], c)
                            for c in CATEGORIES], dim=1)
        if self.segdiv == "quad":
            obj = segs[:, 0].cpu().numpy()
            obj_local = np.where(obj == 0, 0, obj - self._flat_offset["object"])
            div = expand_segment_quad(obj_local, self._n_obj)
            div = np.where(div > 0, div - self._n_obj - 1 + self._div_base, 0)
            segs = torch.cat([segs, torch.from_numpy(div).to(segs)], dim=1)
        return segs

    def _local(self, classnum: int) -> Tuple[str, int]:
        self._check_classnum(classnum)
        self._check_not_divided(classnum)
        cat = self.categories[classnum]
        return cat, classnum - self._flat_offset[cat]

    def class_probability(self, images, classnum: int) -> torch.Tensor:
        """Differentiable per-pixel probability [B, H, W] of one flat label
        (the ACE objective's signal)."""
        cat, local = self._local(classnum)
        return self._averaged(images, (cat, local))[cat][:, 0]

    def predict_single_class(self, images, classnum: int,
                             downsample: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """(probability, mask) for one flat label, from one network pass."""
        cat, local = self._local(classnum)
        probs = self.category_probabilities(images)[cat][:, :, ::downsample, ::downsample]
        return probs[:, local], self._flat(probs, cat) == classnum


def component_masks(seg_map: np.ndarray):
    """Yield boolean masks of the connected same-valued regions of a 2-D
    integer label map (background 0 excluded), 8-connected.  Unlike the
    reference (``range(1, num)`` over 1..num ids), the last component of an
    image is yielded too, as in the JAX package."""
    from scipy import ndimage
    eight = np.ones((3, 3), dtype=bool)
    for value in np.unique(seg_map):
        if value == 0:
            continue
        labeled, num = ndimage.label(seg_map == value, structure=eight)
        for comp in range(1, num + 1):
            yield labeled == comp


def expand_segment_quad(obj_maps: np.ndarray, num_labels: int) -> np.ndarray:
    """The reference's quad subdivision (``netdissect/segmenter.py:257-285``)
    on a batch of LOCAL object maps [B, H, W] (labels 1..num_labels, 0 =
    none): every connected component is split at its bounding-box
    midlines; channel 0 carries top (+1*N) / bottom (+3*N), channel 1
    left (+2*N) / right (+4*N), i.e. value ``o + q*N``; pixels that
    received no offset are zeroed.  Host numpy, as in the JAX package."""
    b, h, w = obj_maps.shape
    out = np.repeat(obj_maps[:, None].astype(np.int64), 2, axis=1)
    for i in range(b):
        for mask in component_masks(obj_maps[i]):
            rows = np.flatnonzero(mask.any(axis=1))
            cols = np.flatnonzero(mask.any(axis=0))
            top, bottom = rows[0], rows[-1]
            left, right = cols[0], cols[-1]
            vmid = (top + bottom + 1) // 2
            hmid = (left + right + 1) // 2
            quad = np.repeat(mask[None], 4, axis=0)
            quad[0, vmid:, :] = False   # keeps rows < vmid: top    (+1*N)
            quad[1, :, hmid:] = False   # keeps cols < hmid: left   (+2*N)
            quad[2, :vmid, :] = False   # keeps rows >= vmid: bottom (+3*N)
            quad[3, :, :hmid] = False   # keeps cols >= hmid: right  (+4*N)
            out[i, 0] += quad[0] * num_labels + quad[2] * (3 * num_labels)
            out[i, 1] += quad[1] * (2 * num_labels) + quad[3] * (4 * num_labels)
    out[out <= num_labels] = 0          # never-offset pixels carry no concept
    return out


def import_torch_upernet(encoder_state, decoder_state, cfg: UPerNetConfig) -> Params:
    """Params from the reference's two torch checkpoints
    (``encoder_epoch_40.pth`` / ``decoder_epoch_40.pth``): the encoder by
    :func:`segmodel.import_torch_resnet`, the decoder tensors by position;
    missing decoder keys keep the seeded init (and are printed)."""
    params = init_upernet_params(cfg)
    for k, v in import_torch_resnet(encoder_state, cfg.resnet).items():
        params[f"encoder.{k}"] = v

    missing = []
    for dst, (conv_key, bn_key) in _decoder_name_map(cfg).items():
        wk = f"{conv_key}.weight"
        if wk not in decoder_state:
            missing.append(wk)
            continue
        params[f"{dst}.weight"] = _np(decoder_state, wk)
        if bn_key is not None:
            s, b = fold_bn(_np(decoder_state, f"{bn_key}.weight"),
                           _np(decoder_state, f"{bn_key}.bias"),
                           _np(decoder_state, f"{bn_key}.running_mean"),
                           _np(decoder_state, f"{bn_key}.running_var"))
            params[f"{dst}.bn.scale"] = s
            params[f"{dst}.bn.bias"] = b
        elif f"{conv_key}.bias" in decoder_state:
            params[f"{dst}.bias"] = _np(decoder_state, f"{conv_key}.bias")
    if missing:
        print(f"import_torch_upernet: {len(missing)} decoder tensors not "
              f"found (kept random init): {missing[:5]}...")
    return params


def _decoder_name_map(cfg: UPerNetConfig):
    """dst-param -> (torch conv key, torch bn key or None), following the
    reference decoder's layout (``upsegmodel/models.py``)."""
    m = {}
    for i in range(len(cfg.ppm_scales)):
        m[f"ppm.conv{i}"] = (f"ppm_conv.{i}.0", f"ppm_conv.{i}.1")
    m["ppm.fusion"] = ("ppm_last_conv.0", "ppm_last_conv.1")
    for i in range(3):
        m[f"fpn.lateral{i}"] = (f"fpn_in.{i}.0", f"fpn_in.{i}.1")
        m[f"fpn.smooth{i}"] = (f"fpn_out.{i}.0.0", f"fpn_out.{i}.0.1")
    m["fuse"] = ("conv_fusion.0", "conv_fusion.1")
    for head in ("object", "part", "material"):
        m[f"head.{head}.conv"] = (f"{head}_head.0.0", f"{head}_head.0.1")
        m[f"head.{head}"] = (f"{head}_head.1", None)
    m["head.scene.conv"] = ("scene_head.0.0", "scene_head.0.1")
    m["head.scene"] = ("scene_head.2", None)
    return m


# torchvision-standard normalization the reference applies after mapping
# its [-1,1] inputs to [0,1] (``segmenter.py:404-408``).
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class SemanticSegmenter(SegmenterBase):
    """Flat single-category semantic segmentation (ADE150-style) over a
    ``segmodel.build_segmodel`` net (dilated ResNet + PPM/C1 bilinear
    decoder): inference at each of ``segsizes`` with the probabilities
    averaged, imagenet input normalization.  Flat label 0 is '-'
    (unlabeled); net class k maps to flat label k+1."""

    def __init__(self, arch_encoder: str = "resnet50_dilated8",
                 arch_decoder: str = "ppm_bilinear",
                 params=None, labels: Optional[List[str]] = None,
                 num_class: Optional[int] = None,
                 segsizes: Sequence[int] = (256,), category: str = "object",
                 seed: int = 0, segdiv: str = "undivided", device="cuda"):
        if num_class is None:
            num_class = len(labels) if labels else 150
        init, net_class, cfg = build_segmodel(arch_encoder, arch_decoder,
                                              num_class=num_class, seed=seed)
        self.cfg = cfg
        self.device = require_device(device)
        self.net = net_class(cfg).params_from_jax(params if params is not None else init)
        self.net.to(self.device)
        self.segsizes = tuple(segsizes)
        assert segdiv in ("undivided", "quad")
        self.segdiv = segdiv
        names = list(labels) if labels else [f"class-{i}" for i in range(num_class)]
        self.labels = ["-"] + names
        self.categories = ["-"] + [category] * num_class
        # naive quad subdivision (reference segmenter.py:348-361): divided
        # pseudo-labels appended per quadrant block t/l/b/r
        self._div_base = len(self.labels)
        self._n_base = num_class
        if segdiv == "quad":
            for suffix in ("t", "l", "b", "r"):
                self.labels.extend(f"{n}-{suffix}" for n in names)
                self.categories.extend([category] * num_class)

    def get_label_and_category_names(self) -> Tuple[List[str], List[str]]:
        return list(self.labels), list(self.categories)

    def _probs(self, images: torch.Tensor, size: int) -> torch.Tensor:
        h, w = images.shape[2:]
        mean = torch.tensor(_IMAGENET_MEAN, dtype=images.dtype, device=images.device)
        std = torch.tensor(_IMAGENET_STD, dtype=images.dtype, device=images.device)
        x = (images - mean.reshape(1, 3, 1, 1)) / std.reshape(1, 3, 1, 1)
        with ieee_f32():
            return torch.softmax(self.net(_fit_size(x, size), seg_size=(h, w)), dim=1)

    def class_probabilities(self, images) -> torch.Tensor:
        """Multi-size averaged class probabilities [B, num_class, H, W]."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        acc = 0
        for s in self.segsizes:
            acc = acc + self._probs(images, int(s))
        return acc / len(self.segsizes)

    def segment_batch(self, images, downsample: int = 1) -> torch.Tensor:
        """images [B,3,H,W] in [0,1] -> flat labels [B, 1(+2 quad), H', W']."""
        with torch.no_grad():
            p = self.class_probabilities(images)[:, :, ::downsample, ::downsample]
        segs = (torch.argmax(p, dim=1) + 1)[:, None]
        if self.segdiv == "quad":
            div = expand_segment_quad(segs[:, 0].cpu().numpy(), self._n_base)
            div = np.where(div > 0, div - self._n_base - 1 + self._div_base, 0)
            segs = torch.cat([segs, torch.from_numpy(div).to(segs)], dim=1)
        return segs

    def class_probability(self, images, classnum: int) -> torch.Tensor:
        self._check_classnum(classnum)
        self._check_not_divided(classnum)
        return self.class_probabilities(images)[:, classnum - 1]

    def predict_single_class(self, images, classnum: int,
                             downsample: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        self._check_classnum(classnum)
        self._check_not_divided(classnum)
        probs = self.class_probabilities(images)[:, :, ::downsample, ::downsample]
        return probs[:, classnum - 1], torch.argmax(probs, dim=1) + 1 == classnum
