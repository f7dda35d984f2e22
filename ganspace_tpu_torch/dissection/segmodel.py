"""Semantic-segmentation networks: ResNet encoders, the UPerNet decoder and
the ADE20K scene-parsing decoders.

Counterpart of ``ganspace_tpu/dissection/segmodel.py`` (the reference's
``netdissect/upsegmodel`` and ``segmodel`` nets).  The nets are
``nn.Module``s in NCHW whose parameter names are the JAX package's flat
``{name: ndarray}`` keys, so a parameter dict built by the ``init_*``
functions below (copies of the JAX package's numpy initialisers, seed for
seed) or by the torch importers loads with ``params_from_jax``.  Batch
norm is folded to a per-channel scale and bias at import (:func:`fold_bn`).
The convolutions are ``F.conv2d`` in IEEE float32 (``ops/precision.ieee_f32``),
as the JAX package runs them at HIGHEST outside any Pallas kernel.

* stem: three 3x3 convs 3->w->w->2w, the first strided;
* bottleneck stages with 1x1 strided downsample projections, or dilated
  stride-1 convs in the late stages (``dilate_scale`` 8 or 16);
* UPerNet's PPM: PrRoI pooling of c5 over the whole image at scales
  (1, 2, 3, 6), bilinear resize back to c5's size, then 1x1 conv + BN +
  ReLU; the FPN top-down path; the object, part, material and scene heads;
* the ADE decoders: ``PPMBilinear`` (adaptive average pooling, conv, resize)
  and ``C1Bilinear``.

Resizes follow ``jax.image.resize``'s bilinear: half-pixel centres,
antialiased where it shrinks (``viz.resize``); adaptive average pooling is
the JAX package's own definition (:func:`adaptive_avg_pool`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganspace_tpu_torch.dissection.viz import resize
from ganspace_tpu_torch.ops.precision import ieee_f32
from ganspace_tpu_torch.ops.prroi import prroi_pool2d

Params = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """Fold BN running stats into (scale, bias)."""
    scale = gamma / np.sqrt(var + eps)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    return resize(x, hw, "bilinear")


def adaptive_avg_pool(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` as the JAX package defines it: exact mean
    pooling when the target divides the input, integral-image fractional
    bins otherwise (bin p covers [floor(p*h/th), ceil((p+1)*h/th)))."""
    h, w = x.shape[2], x.shape[3]
    th, tw = hw
    if h == th and w == tw:
        return x
    if h % th == 0 and w % tw == 0:
        kh, kw = h // th, w // tw
        y = F.avg_pool2d(x, (kh, kw), divisor_override=1)
        return y / (kh * kw)
    integ = F.pad(torch.cumsum(torch.cumsum(x, 2), 3), (1, 0, 1, 0))
    ys = np.floor(np.arange(th) * h / th).astype(int)
    ye = np.ceil((np.arange(th) + 1) * h / th).astype(int)
    xs = np.floor(np.arange(tw) * w / tw).astype(int)
    xe = np.ceil((np.arange(tw) + 1) * w / tw).astype(int)
    area = (ye - ys)[:, None] * (xe - xs)[None, :]

    def at(r, c):
        return integ[:, :, torch.as_tensor(r)][:, :, :, torch.as_tensor(c)]
    out = at(ye, xe) - at(ys, xe) - at(ye, xs) + at(ys, xs)
    return out / torch.as_tensor(area, dtype=x.dtype, device=x.device)


def _he(rs: np.random.RandomState, *shape) -> np.ndarray:
    fan_in = int(np.prod(shape[1:]))
    return (rs.randn(*shape) * np.sqrt(2.0 / max(fan_in, 1))).astype(np.float32)


def _init_conv_bn(p: Params, rs, name: str, cin: int, cout: int, k: int):
    p[f"{name}.weight"] = _he(rs, cout, cin, k, k)
    p[f"{name}.bn.scale"] = np.ones((cout,), np.float32)
    p[f"{name}.bn.bias"] = np.zeros((cout,), np.float32)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class _Affine(nn.Module):
    """Folded-BN affine: y = x * scale + bias (per channel)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = _param(c)
        self.bias = _param(c)

    def forward(self, x):
        return x * self.scale.reshape(1, -1, 1, 1) + self.bias.reshape(1, -1, 1, 1)


class ConvBN(nn.Module):
    """conv (padding ``dilation * (k - 1) // 2``) + folded BN, ReLU optional."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = _param(cout, cin, k, k)
        self.bn = _Affine(cout)

    def forward(self, x, stride: int = 1, dilation: int = 1, relu: bool = True):
        k = self.weight.shape[-1]
        y = F.conv2d(x, self.weight, stride=stride, padding=dilation * (k - 1) // 2,
                     dilation=dilation)
        y = self.bn(y)
        return F.relu(y) if relu else y


class _Classifier(nn.Module):
    """A 1x1 conv with a bias."""

    def __init__(self, cin: int, n: int):
        super().__init__()
        self.weight = _param(n, cin, 1, 1)
        self.bias = _param(n)

    def forward(self, x):
        return F.conv2d(x, self.weight) + self.bias.reshape(1, -1, 1, 1)


class _Net(nn.Module):
    """Loading of the JAX package's flat parameter dicts."""

    def params_from_jax(self, flat: Params) -> "_Net":
        self.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                              for k, v in flat.items()}, strict=True)
        return self


# ---------------------------------------------------------------------------
# ResNet encoder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ResNetConfig:
    """ResNet-v1 with the 3-conv deep stem (3->64->64->128, first conv
    strided).  ``blocks=(3,4,6,3), width=64`` is the reference's resnet50.
    ``dilate_scale`` (0/8/16): strided 3x3 convs in the late stages become
    stride-1 dilated convs (output stride 8/16 instead of 32)."""
    blocks: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    expansion: int = 4
    dilate_scale: int = 0

    def stage_dilation(self, si: int) -> int:
        """_nostride_dilate's per-stage dilate factor (0 = stride normally)."""
        if self.dilate_scale == 8:
            return {2: 2, 3: 4}.get(si, 0)
        if self.dilate_scale == 16:
            return {3: 2}.get(si, 0)
        return 0

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        return tuple(self.width * (2 ** i) * self.expansion
                     for i in range(len(self.blocks)))


def init_resnet_params(cfg: ResNetConfig, seed: int = 0) -> Params:
    """The JAX package's seeded He initialisation, value for value."""
    rs = np.random.RandomState(seed)
    p: Params = {}
    w = cfg.width
    _init_conv_bn(p, rs, "stem.conv1", 3, w, 3)
    _init_conv_bn(p, rs, "stem.conv2", w, w, 3)
    _init_conv_bn(p, rs, "stem.conv3", w, 2 * w, 3)
    cin = 2 * w
    for si, n in enumerate(cfg.blocks):
        planes = w * (2 ** si)
        cout = planes * cfg.expansion
        for bi in range(n):
            base = f"layer{si + 1}.{bi}"
            _init_conv_bn(p, rs, f"{base}.conv1", cin, planes, 1)
            _init_conv_bn(p, rs, f"{base}.conv2", planes, planes, 3)
            _init_conv_bn(p, rs, f"{base}.conv3", planes, cout, 1)
            if cin != cout:
                _init_conv_bn(p, rs, f"{base}.downsample", cin, cout, 1)
            cin = cout
    return p


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, cout: int):
        super().__init__()
        self.conv1 = ConvBN(cin, planes, 1)
        self.conv2 = ConvBN(planes, planes, 3)
        self.conv3 = ConvBN(planes, cout, 1)
        self.downsample = ConvBN(cin, cout, 1) if cin != cout else None

    def forward(self, x, stride: int, dilation: int = 1):
        y = self.conv1(x)
        y = self.conv2(y, stride=stride, dilation=dilation)
        y = self.conv3(y, relu=False)
        if self.downsample is not None:
            x = self.downsample(x, stride=stride, relu=False)
        elif stride != 1:
            x = x[:, :, ::stride, ::stride]
        return F.relu(x + y)


class _Stem(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.conv1 = ConvBN(3, w, 3)
        self.conv2 = ConvBN(w, w, 3)
        self.conv3 = ConvBN(w, 2 * w, 3)


class ResNet(_Net):
    """x [B,3,H,W] -> {'c2': /4, 'c3': /8, 'c4': /16, 'c5': /32} (late
    stages keep their resolution when ``dilate_scale`` is set)."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.stem = _Stem(w)
        cin = 2 * w
        for si, n in enumerate(cfg.blocks):
            planes = w * (2 ** si)
            cout = planes * cfg.expansion
            blocks = []
            for _ in range(n):
                blocks.append(Bottleneck(cin, planes, cout))
                cin = cout
            self.add_module(f"layer{si + 1}", nn.ModuleList(blocks))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = self.stem.conv1(x, stride=2)
        y = self.stem.conv2(y)
        y = self.stem.conv3(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        feats = {}
        for si in range(len(self.cfg.blocks)):
            stride = 1 if si == 0 else 2
            dil = self.cfg.stage_dilation(si)
            for bi, block in enumerate(getattr(self, f"layer{si + 1}")):
                if dil:
                    # _nostride_dilate: the formerly-strided conv gets
                    # dilation d/2, the rest d
                    y = block(y, 1, max(dil // 2, 1) if bi == 0 else dil)
                else:
                    y = block(y, stride if bi == 0 else 1)
            feats[f"c{si + 2}"] = y
        return feats


# ---------------------------------------------------------------------------
# UPerNet decoder (PPM + FPN) with unified-parsing heads
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class UPerNetConfig:
    resnet: ResNetConfig = field(default_factory=ResNetConfig)
    fpn_dim: int = 512
    ppm_dim: int = 512         # the PPM branch width (fixed in the reference)
    ppm_scales: Tuple[int, ...] = (1, 2, 3, 6)
    n_objects: int = 336       # unified-parsing label counts
    n_parts: int = 153
    n_materials: int = 26
    n_scenes: int = 365


def init_upernet_params(cfg: UPerNetConfig, seed: int = 0) -> Params:
    """The JAX package's seeded initialisation, value for value."""
    rs = np.random.RandomState(seed + 1)
    p = {f"encoder.{k}": v
         for k, v in init_resnet_params(cfg.resnet, seed).items()}
    chans = cfg.resnet.stage_channels
    d = cfg.fpn_dim
    for i in range(len(cfg.ppm_scales)):
        _init_conv_bn(p, rs, f"ppm.conv{i}", chans[-1], cfg.ppm_dim, 1)
    _init_conv_bn(p, rs, "ppm.fusion",
                  chans[-1] + cfg.ppm_dim * len(cfg.ppm_scales), d, 3)
    for i, c in enumerate(chans[:-1]):
        _init_conv_bn(p, rs, f"fpn.lateral{i}", c, d, 1)
        _init_conv_bn(p, rs, f"fpn.smooth{i}", d, d, 3)
    _init_conv_bn(p, rs, "fuse", d * len(chans), d, 3)
    for head, n in (("object", cfg.n_objects), ("part", cfg.n_parts),
                    ("material", cfg.n_materials)):
        _init_conv_bn(p, rs, f"head.{head}.conv", d, d, 3)
        p[f"head.{head}.weight"] = _he(rs, n, d, 1, 1)
        p[f"head.{head}.bias"] = np.zeros((n,), np.float32)
    _init_conv_bn(p, rs, "head.scene.conv", d, d, 3)
    p["head.scene.weight"] = _he(rs, cfg.n_scenes, d, 1, 1)
    p["head.scene.bias"] = np.zeros((cfg.n_scenes,), np.float32)
    return p


class _Head(_Classifier):
    """conv3x3 + BN + ReLU, then a 1x1 classifier."""

    def __init__(self, d: int, n: int):
        super().__init__(d, n)
        self.conv = ConvBN(d, d, 3)

    def forward(self, x):
        return super().forward(self.conv(x))


class UPerNet(_Net):
    """x [B,3,H,W] (reference-normalized) -> logits dict: object / part
    [B,L,H/4,W/4] on the fusion, material on P2, scene [B,n_scenes] on the
    PPM output."""

    def __init__(self, cfg: UPerNetConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.resnet.stage_channels
        d = cfg.fpn_dim
        self.encoder = ResNet(cfg.resnet)
        self.ppm = nn.Module()
        for i in range(len(cfg.ppm_scales)):
            self.ppm.add_module(f"conv{i}", ConvBN(chans[-1], cfg.ppm_dim, 1))
        self.ppm.fusion = ConvBN(chans[-1] + cfg.ppm_dim * len(cfg.ppm_scales), d, 3)
        self.fpn = nn.Module()
        for i, c in enumerate(chans[:-1]):
            self.fpn.add_module(f"lateral{i}", ConvBN(c, d, 1))
            self.fpn.add_module(f"smooth{i}", ConvBN(d, d, 3))
        self.fuse = ConvBN(d * len(chans), d, 3)
        self.head = nn.Module()
        for name, n in (("object", cfg.n_objects), ("part", cfg.n_parts),
                        ("material", cfg.n_materials)):
            self.head.add_module(name, _Head(d, n))
        self.head.scene = _Head(d, cfg.n_scenes)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        with ieee_f32():
            return self._forward(x)

    def _forward(self, x):
        feats = self.encoder(x)
        c2, c3, c4, c5 = feats["c2"], feats["c3"], feats["c4"], feats["c5"]

        # Pyramid pooling on c5: PrRoI whole-image pool -> resize -> conv
        # (the conv at c5's resolution, after the interpolation).
        b, _, h5, w5 = c5.shape
        roi = torch.cat([
            torch.arange(b, dtype=c5.dtype, device=c5.device)[:, None],
            torch.tensor([0.0, 0.0, w5, h5], dtype=c5.dtype, device=c5.device).expand(b, 4),
        ], dim=1)
        ppm_out = [c5]
        for i, s in enumerate(self.cfg.ppm_scales):
            pooled = prroi_pool2d(c5, roi, s, s)
            up = resize_bilinear(pooled, (h5, w5))
            ppm_out.append(getattr(self.ppm, f"conv{i}")(up))
        f5 = self.ppm.fusion(torch.cat(ppm_out, dim=1))

        out: Dict[str, torch.Tensor] = {}
        # The scene head reads the PPM output: conv, global pool, product.
        y = self.head.scene.conv(f5)
        pooled = torch.mean(y, dim=(2, 3))
        w_s = self.head.scene.weight
        out["scene"] = pooled @ w_s.reshape(w_s.shape[0], -1).T + self.head.scene.bias

        # FPN top-down: the raw sum propagates; smoothed copies are collected.
        laterals = [getattr(self.fpn, f"lateral{i}")(c) for i, c in enumerate((c2, c3, c4))]
        fpn = [f5]
        top = f5
        for i in (2, 1, 0):
            top = laterals[i] + resize_bilinear(top, laterals[i].shape[2:])
            fpn.insert(0, getattr(self.fpn, f"smooth{i}")(top))

        out["material"] = self.head.material(fpn[0])
        hw = fpn[0].shape[2:]
        fused = torch.cat([fpn[0]] + [resize_bilinear(f, hw) for f in fpn[1:]], dim=1)
        pix = self.fuse(fused)
        out["object"] = self.head.object(pix)
        out["part"] = self.head.part(pix)
        return out


# ---------------------------------------------------------------------------
# Torch checkpoint import (host numpy, copies of the JAX package's)
# ---------------------------------------------------------------------------

def _np(state, k) -> np.ndarray:
    v = state[k]
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def import_torch_resnet(state: Dict[str, "np.ndarray"], cfg: ResNetConfig) -> Params:
    """Translate a torch deep-stem ResNet ``state_dict`` (the reference
    encoder's naming, ``upsegmodel/resnet.py``) into folded params."""
    p: Params = {}

    def put(dst: str, conv_key: str, bn_key: str):
        p[f"{dst}.weight"] = _np(state, f"{conv_key}.weight")
        s, b = fold_bn(_np(state, f"{bn_key}.weight"), _np(state, f"{bn_key}.bias"),
                       _np(state, f"{bn_key}.running_mean"),
                       _np(state, f"{bn_key}.running_var"))
        p[f"{dst}.bn.scale"] = s
        p[f"{dst}.bn.bias"] = b

    put("stem.conv1", "conv1", "bn1")
    put("stem.conv2", "conv2", "bn2")
    put("stem.conv3", "conv3", "bn3")
    for si, n in enumerate(cfg.blocks):
        for bi in range(n):
            base = f"layer{si + 1}.{bi}"
            for ci in (1, 2, 3):
                put(f"{base}.conv{ci}", f"{base}.conv{ci}", f"{base}.bn{ci}")
            if f"{base}.downsample.0.weight" in state:
                put(f"{base}.downsample", f"{base}.downsample.0", f"{base}.downsample.1")
    return p


# ---------------------------------------------------------------------------
# ADE20K scene-parsing decoders (dilated encoder + PPM / C1 bilinear; the
# deep-supervision branches are training-only and omitted)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PPMBilinearConfig:
    """``PPMBilinear`` (``segmodel/models.py:355-403``)."""
    resnet: ResNetConfig = field(
        default_factory=lambda: ResNetConfig(dilate_scale=8))
    num_class: int = 150
    ppm_dim: int = 512
    pool_scales: Tuple[int, ...] = (1, 2, 3, 6)

    @property
    def fc_dim(self) -> int:
        return self.resnet.stage_channels[-1]


def init_ppm_params(cfg: PPMBilinearConfig, seed: int = 0) -> Params:
    rs = np.random.RandomState(seed)
    p: Params = {f"encoder.{k}": v
                 for k, v in init_resnet_params(cfg.resnet, seed).items()}
    for i in range(len(cfg.pool_scales)):
        _init_conv_bn(p, rs, f"decoder.ppm.{i}", cfg.fc_dim, cfg.ppm_dim, 1)
    cat = cfg.fc_dim + len(cfg.pool_scales) * cfg.ppm_dim
    _init_conv_bn(p, rs, "decoder.conv_last", cat, cfg.ppm_dim, 3)
    p["decoder.classifier.weight"] = _he(rs, cfg.num_class, cfg.ppm_dim, 1, 1)
    p["decoder.classifier.bias"] = np.zeros((cfg.num_class,), np.float32)
    return p


class PPMBilinear(_Net):
    """x [B,3,H,W] -> class logits [B,num_class,h,w] (h = H/dilate_scale);
    with ``seg_size`` the logits are bilinearly resized first (softmax is
    left to the caller)."""

    def __init__(self, cfg: PPMBilinearConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ResNet(cfg.resnet)
        self.decoder = nn.Module()
        self.decoder.ppm = nn.ModuleList(ConvBN(cfg.fc_dim, cfg.ppm_dim, 1)
                                         for _ in cfg.pool_scales)
        self.decoder.conv_last = ConvBN(cfg.fc_dim + len(cfg.pool_scales) * cfg.ppm_dim,
                                        cfg.ppm_dim, 3)
        self.decoder.classifier = _Classifier(cfg.ppm_dim, cfg.num_class)

    def forward(self, x, seg_size: Tuple[int, int] | None = None) -> torch.Tensor:
        with ieee_f32():
            c5 = self.encoder(x)["c5"]
            hw = c5.shape[2:]
            outs = [c5]
            for conv, scale in zip(self.decoder.ppm, self.cfg.pool_scales):
                y = conv(adaptive_avg_pool(c5, (scale, scale)))
                outs.append(resize_bilinear(y, hw))
            y = self.decoder.conv_last(torch.cat(outs, dim=1))
            y = self.decoder.classifier(y)
        return y if seg_size is None else resize_bilinear(y, seg_size)


@dataclass(frozen=True)
class C1BilinearConfig:
    """``C1Bilinear`` (``segmodel/models.py:327-352``): one conv-bn-relu at
    fc_dim/4 then a 1x1 classifier."""
    resnet: ResNetConfig = field(
        default_factory=lambda: ResNetConfig(dilate_scale=8))
    num_class: int = 150

    @property
    def fc_dim(self) -> int:
        return self.resnet.stage_channels[-1]


def init_c1_params(cfg: C1BilinearConfig, seed: int = 0) -> Params:
    rs = np.random.RandomState(seed)
    p: Params = {f"encoder.{k}": v
                 for k, v in init_resnet_params(cfg.resnet, seed).items()}
    _init_conv_bn(p, rs, "decoder.cbr", cfg.fc_dim, cfg.fc_dim // 4, 3)
    p["decoder.classifier.weight"] = _he(rs, cfg.num_class, cfg.fc_dim // 4, 1, 1)
    p["decoder.classifier.bias"] = np.zeros((cfg.num_class,), np.float32)
    return p


class C1Bilinear(_Net):
    def __init__(self, cfg: C1BilinearConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ResNet(cfg.resnet)
        self.decoder = nn.Module()
        self.decoder.cbr = ConvBN(cfg.fc_dim, cfg.fc_dim // 4, 3)
        self.decoder.classifier = _Classifier(cfg.fc_dim // 4, cfg.num_class)

    def forward(self, x, seg_size: Tuple[int, int] | None = None) -> torch.Tensor:
        with ieee_f32():
            y = self.decoder.classifier(self.decoder.cbr(self.encoder(x)["c5"]))
        return y if seg_size is None else resize_bilinear(y, seg_size)


def import_torch_segmodel(encoder_state, decoder_state, cfg) -> Params:
    """Translate reference ``ModelBuilder`` encoder/decoder ``state_dict``s
    (``segmodel/models.py``) into folded params for the nets above."""
    p: Params = {f"encoder.{k}": v
                 for k, v in import_torch_resnet(encoder_state, cfg.resnet).items()}

    def put(dst, conv_key, bn_key):
        p[f"decoder.{dst}.weight"] = _np(decoder_state, f"{conv_key}.weight")
        s, b = fold_bn(_np(decoder_state, f"{bn_key}.weight"),
                       _np(decoder_state, f"{bn_key}.bias"),
                       _np(decoder_state, f"{bn_key}.running_mean"),
                       _np(decoder_state, f"{bn_key}.running_var"))
        p[f"decoder.{dst}.bn.scale"] = s
        p[f"decoder.{dst}.bn.bias"] = b

    if isinstance(cfg, PPMBilinearConfig):
        # torch Sequential indices: ppm.{i} = [pool, conv, bn, relu];
        # conv_last = [conv, bn, relu, dropout, classifier].
        for i in range(len(cfg.pool_scales)):
            put(f"ppm.{i}", f"ppm.{i}.1", f"ppm.{i}.2")
        put("conv_last", "conv_last.0", "conv_last.1")
        p["decoder.classifier.weight"] = _np(decoder_state, "conv_last.4.weight")
        p["decoder.classifier.bias"] = _np(decoder_state, "conv_last.4.bias")
    else:
        # C1Bilinear: cbr = conv3x3_bn_relu Sequential [conv, bn, relu].
        put("cbr", "cbr.0", "cbr.1")
        p["decoder.classifier.weight"] = _np(decoder_state, "conv_last.weight")
        p["decoder.classifier.bias"] = _np(decoder_state, "conv_last.bias")
    return p


def build_segmodel(arch_encoder: str = "resnet50_dilated8",
                   arch_decoder: str = "ppm_bilinear",
                   num_class: int = 150, seed: int = 0):
    """The reference ``ModelBuilder`` arch-name surface: ``(init params,
    net class, cfg)``; ``net_class(cfg).params_from_jax(params)`` builds the
    net.  Deepsup arch names map to the same inference nets."""
    blocks = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
    name = arch_encoder.replace("_dilated8", "").replace("_dilated16", "")
    dilate = 8 if arch_encoder.endswith("dilated8") else (
        16 if arch_encoder.endswith("dilated16") else 0)
    if name not in blocks:
        raise ValueError(f"Unknown encoder arch {arch_encoder}")
    rn = ResNetConfig(blocks=blocks[name], dilate_scale=dilate)
    dec = arch_decoder.replace("_deepsup", "")
    if dec == "ppm_bilinear":
        cfg = PPMBilinearConfig(resnet=rn, num_class=num_class)
        return init_ppm_params(cfg, seed), PPMBilinear, cfg
    if dec == "c1_bilinear":
        cfg = C1BilinearConfig(resnet=rn, num_class=num_class)
        return init_c1_params(cfg, seed), C1Bilinear, cfg
    raise ValueError(f"Unknown decoder arch {arch_decoder}")
