"""BigGAN-deep generator as a PyTorch module.

Counterpart of ``ganspace_tpu/models/biggan.py`` and, through it, of the
HuggingFace BigGAN-deep port the reference vendors
(``models/biggan/pytorch_biggan/``), with Härkönen's per-layer latents: every
GenBlock receives its own ``cond = cat(z_i, embed_i)``, so a model has
``len(layers) + 1`` editable latent slots (one more for ``gen_z``; 15 at
512 px).  Covered as in the JAX package:

* batch-norm statistics interpolated by truncation from 51 stored points
  (``model.py:126-135``), with the reference's "backwards" weights;
* the bottleneck GenBlock with its channel-drop skip (``model.py:152-202``);
* SAGAN self-attention at 64 px (``model.py:57-96``), stock PyTorch
  (``bmm``, ``softmax``), as the JAX package leaves it to XLA;
* spectral norm baked into the imported weights (``models/torch_import.py``,
  ``models/tf_import.py``);
* truncated-normal latents: scipy's on the host, bit for bit the JAX
  package's (``sampling.truncated_latents``), and a per-block draw on the
  card (``sampling.device_truncated``).

The module tree follows the checkpoint key names, so ``state_dict`` keys are
the JAX package's flat parameter keys and :meth:`BigGAN.params_from_jax`
loads one without renaming.  Built without ``params``, the model loads the
HuggingFace ``.bin`` or the TF-Hub dump that ``models/checkpoints.py``
finds, and keeps seeded random weights when there is neither.

Synthesis runs NCHW at every stage; the JAX package's space-to-depth tail is
TPU-only and is not ported.  The 3x3 convs go through kernel B
(``ops/modconv.py``): ``conv_1`` of the blocks that keep their size,
``conv_2`` and ``conv_to_rgb`` through the plain mode, :func:`conv3x3`;
``conv_1`` of an up-block, nearest 2x then 3x3, through the stride-2 mode,
:func:`upsample_conv`, as the one transposed conv it equals (a 4x4 composite
kernel, padding 1).  The 1x1 convs, ``gen_z``, the batch norms and the
attention stay stock PyTorch ops under the policy of ``ops/precision.py``.

Under the preview policy the generator follows the JAX package's rules
(``ganspace_tpu/models/biggan.py:400-473``), rounding order included: the
class embedding, ``gen_z`` and the conditional scales and offsets run on
float32 latents at the policy's precision; the map is cast to the storage
dtype after ``gen_z``'s reshape; every conv takes its weight in x's dtype,
its bias added in it; the batch-norm statistics, the conditional scale and
offset and the attention's gamma are cast to x's dtype and applied as
``((x - mean) * inv) * scale + offset``; an up-conv's composite kernel is
formed from the storage-dtype weight (``ganspace_tpu/ops/s2d.py:370-380``)
in the blocks the JAX package runs in its space-to-depth tail, while the
earlier up-blocks run nearest 2x then the 3x3 conv on the rounded weight,
as its pixel layout does (``ops/modconv.S2D_MAX_CH``); ``tanh`` returns
float32.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.models import checkpoints, imagenet_classes
from ganspace_tpu_torch.models.base import BaseGenerator, TapState, grad_while_edit_override
from ganspace_tpu_torch.models.tf_import import import_biggan_tf
from ganspace_tpu_torch.models.torch_import import import_biggan
from ganspace_tpu_torch.ops import precision
from ganspace_tpu_torch.ops.modconv import (
    S2D_MAX_CH, LayerWeights, conv3x3, nearest_up2x, nearest_up_kernel, upsample_conv)
from ganspace_tpu_torch.ops.precision import (
    StorageCopies, bf16_operands, bf16_values, get_precision, ieee_f32, round_bf16,
    synth_dtype_name)
from ganspace_tpu_torch.sampling import device_truncated, truncated_latents
from ganspace_tpu_torch.utils.tracing import annotate

# (up-sample?, in-width-mult, out-width-mult), reference biggan config.py:21-31
LAYERS_128 = ((False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
              (False, 8, 8), (True, 8, 4), (False, 4, 4), (True, 4, 2),
              (False, 2, 2), (True, 2, 1))
LAYERS_256 = ((False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
              (False, 8, 8), (True, 8, 8), (False, 8, 8), (True, 8, 4),
              (False, 4, 4), (True, 4, 2), (False, 2, 2), (True, 2, 1))
LAYERS_512 = ((False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
              (False, 8, 8), (True, 8, 8), (False, 8, 8), (True, 8, 4),
              (False, 4, 4), (True, 4, 2), (False, 2, 2), (True, 2, 1),
              (False, 1, 1), (True, 1, 1))

# ImageNet ids for class names used in the reference README, notebooks and
# shipped caches (reference resolves these via WordNet at runtime).
CLASS_ALIASES = {
    "husky": 250, "siberian_husky": 250, "golden_retriever": 207,
    "lighthouse": 437, "beacon": 437, "church": 497, "castle": 483,
    "barn": 425, "library": 624, "bookshop": 454, "restaurant": 762,
    "coffee_shop": 762, "volcano": 980, "alp": 970, "cliff": 972,
    "lakeside": 975, "seashore": 978, "valley": 979, "daisy": 985,
    "rose_hip": 989, "acorn": 988, "mushroom": 947, "pizza": 963,
    "cheeseburger": 933, "goldfish": 1, "tabby": 281, "tiger": 292,
    "lion": 291, "zebra": 340, "badger": 362, "panda": 388,
    "giant_panda": 388, "monarch": 323, "jellyfish": 107, "flamingo": 130,
    "pelican": 144, "king_penguin": 145, "duck": 97, "drake": 97,
    "bald_eagle": 22, "ostrich": 9, "cock": 7, "hen": 8,
    "sports_car": 817, "convertible": 511, "jeep": 609, "minibus": 654,
    "pickup": 717, "fire_engine": 555, "airliner": 404, "warplane": 895,
    "speedboat": 814, "canoe": 472, "container_ship": 510, "trailer_truck": 867,
    "steam_locomotive": 820, "egyptian_cat": 285, "samoyed": 258,
    "irish_setter": 213, "scottish_terrier": 199, "wood_rabbit": 330,
    "brown_bear": 294, "ice_bear": 296, "hamster": 333,
}


@dataclass(frozen=True)
class BigGANConfig:
    output_dim: int = 128
    z_dim: int = 128
    class_embed_dim: int = 128
    channel_width: int = 128
    num_classes: int = 1000
    layers: Tuple[Tuple[bool, int, int], ...] = LAYERS_128
    attention_layer_position: int = 8
    eps: float = 1e-4
    n_stats: int = 51

    @classmethod
    def for_resolution(cls, resolution: int, **kw) -> "BigGANConfig":
        layers = {128: LAYERS_128, 256: LAYERS_256, 512: LAYERS_512}[resolution]
        return cls(output_dim=resolution, layers=layers, **kw)

    def module_plan(self):
        """Ordered module list: ('attn', ch) or ('gen', up, cin, cout)."""
        plan = []
        ch = self.channel_width
        for i, (up, cin, cout) in enumerate(self.layers):
            if i == self.attention_layer_position:
                plan.append(("attn", ch * cin))
            plan.append(("gen", up, ch * cin, ch * cout))
        return plan

    def tail_entry(self) -> Optional[int]:
        """The module where the JAX package's space-to-depth tail starts
        (``ganspace_tpu/models/biggan.py:426-437``): the first up-block after
        the last attention whose bottleneck is at most ``S2D_MAX_CH`` wide;
        None when there is none."""
        plan = self.module_plan()
        attn = max((mi for mi, mod in enumerate(plan) if mod[0] == "attn"), default=-1)
        return next((mi for mi, mod in enumerate(plan) if mi > attn and mod[0] == "gen"
                     and mod[1] and mod[2] // 4 <= S2D_MAX_CH), None)

    @property
    def n_latents(self) -> int:
        return len(self.layers) + 1  # one for gen_z + one per GenBlock


def init_params(cfg: BigGANConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters, drawn exactly as ``ganspace_tpu``'s ``init_params``
    (same keys, same numpy draws in the same order: bit-identical)."""
    rs = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}
    # condition_vector_dim = z_dim * 2 (reference biggan model.py:209): the
    # class embedding projects to z_dim and is concatenated with z.
    cond_dim = cfg.z_dim * 2

    def conv(name, cin, cout, k, bias=True, std=None):
        std = std if std is not None else 1.0 / math.sqrt(cin * k * k)
        p[f"{name}.weight"] = (std * rs.randn(cout, cin, k, k)).astype(np.float32)
        if bias:
            p[f"{name}.bias"] = np.zeros((cout,), np.float32)

    def cond_bn(name, ch):
        p[f"{name}.running_means"] = (0.1 * rs.randn(cfg.n_stats, ch)).astype(np.float32)
        p[f"{name}.running_vars"] = (1.0 + 0.1 * rs.rand(cfg.n_stats, ch)).astype(np.float32)
        p[f"{name}.scale.weight"] = (0.02 * rs.randn(ch, cond_dim)).astype(np.float32)
        p[f"{name}.offset.weight"] = (0.02 * rs.randn(ch, cond_dim)).astype(np.float32)

    p["embeddings.weight"] = (0.1 * rs.randn(cfg.z_dim, cfg.num_classes)).astype(np.float32)
    ch16 = 16 * cfg.channel_width
    std = 1.0 / math.sqrt(cond_dim)
    p["generator.gen_z.weight"] = (std * rs.randn(4 * 4 * ch16, cond_dim)).astype(np.float32)
    p["generator.gen_z.bias"] = np.zeros((4 * 4 * ch16,), np.float32)

    gi = 0
    for mod in cfg.module_plan():
        if mod[0] == "attn":
            ch = mod[1]
            base = f"generator.layers.{gi}"
            conv(f"{base}.snconv1x1_theta", ch, ch // 8, 1, bias=False)
            conv(f"{base}.snconv1x1_phi", ch, ch // 8, 1, bias=False)
            conv(f"{base}.snconv1x1_g", ch, ch // 2, 1, bias=False)
            conv(f"{base}.snconv1x1_o_conv", ch // 2, ch, 1, bias=False)
            p[f"{base}.gamma"] = np.zeros((1,), np.float32) + 0.1
        else:
            _, up, cin, cout = mod
            mid = cin // 4
            base = f"generator.layers.{gi}"
            cond_bn(f"{base}.bn_0", cin)
            conv(f"{base}.conv_0", cin, mid, 1)
            cond_bn(f"{base}.bn_1", mid)
            conv(f"{base}.conv_1", mid, mid, 3)
            cond_bn(f"{base}.bn_2", mid)
            conv(f"{base}.conv_2", mid, mid, 3)
            cond_bn(f"{base}.bn_3", mid)
            conv(f"{base}.conv_3", mid, cout, 1)
        gi += 1

    # Real configs end at width-mult 1 so this equals channel_width
    # (reference model.py:226-228); sized from the last layer for generality.
    ch = cfg.channel_width * cfg.layers[-1][2]
    p["generator.bn.running_means"] = (0.1 * rs.randn(cfg.n_stats, ch)).astype(np.float32)
    p["generator.bn.running_vars"] = (1.0 + 0.1 * rs.rand(cfg.n_stats, ch)).astype(np.float32)
    p["generator.bn.weight"] = np.ones((ch,), np.float32)
    p["generator.bn.bias"] = np.zeros((ch,), np.float32)
    conv("generator.conv_to_rgb", ch, ch, 3)
    return p


# ---------------------------------------------------------------------------
# Modules (checkpoint key layout; weights are filled by load_state_dict)
# ---------------------------------------------------------------------------

def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class _Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = _param(out_dim, in_dim)
        self.bias = _param(out_dim) if bias else None
        self.copies = StorageCopies()

    def operand(self) -> torch.Tensor:
        """The weight as the product takes it under the policy: rounded to
        bf16 at ``default``, made once."""
        if get_precision() != "default":
            return self.weight
        return self.copies(self.weight, None, "bf16", round_bf16)

    def forward(self, x):
        """``x @ weight^T + bias`` at the policy's precision, as the JAX
        package's ``jnp.matmul(x, w.T, precision=get_precision())``: at
        ``default`` bf16 operands with float32 sums, then the bias."""
        if get_precision() != "default":
            return F.linear(x, self.weight, self.bias)
        y = F.linear(bf16_values(x), self.operand())
        return y if self.bias is None else y + self.bias


class _Conv(nn.Module):
    """A conv's weight [out, in, k, k] and optional bias; 1x1 convs run here,
    3x3 ones through kernel B in the callers."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__()
        self.weight = _param(cout, cin, k, k)
        self.bias = _param(cout) if bias else None
        self.copies = StorageCopies()

    def forward(self, x):
        if not bf16_operands(x):
            return F.conv2d(x, self.weight, self.bias)
        return self.add_bias(precision.conv2d(x, self.copies(self.weight, x.dtype)))

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        """y + bias, the bias in y's dtype."""
        if self.bias is None:
            return y
        return y + self.copies(self.bias, y.dtype).reshape(1, -1, 1, 1)


class _Stats(nn.Module):
    """The 51 stored batch-norm statistics and their interpolation by
    truncation, computed once per (truncation, weights) and kept."""

    def __init__(self, ch: int, n_stats: int):
        super().__init__()
        self.running_means = _param(n_stats, ch)
        self.running_vars = _param(n_stats, ch)
        self._key = None
        self._value = None
        self.copies = StorageCopies()

    def mean_inv(self, truncation: float, eps: float):
        """(mean, rsqrt(var + eps)) at ``truncation`` (``model.py:126-135``)."""
        key = (truncation, eps) + tuple((t.data_ptr(), t._version)
                                        for t in (self.running_means, self.running_vars))
        if key != self._key:
            mean, var = _trunc_stats(self.running_means, self.running_vars, truncation)
            self._value = mean, torch.rsqrt(var + eps)
            self._key = key
        return self._value


def _trunc_stats(means, variances, truncation: float):
    """Interpolated running stats for a truncation (model.py:126-135)."""
    n_stats = means.shape[0]
    step = 1.0 / (n_stats - 1)
    coef, start = math.modf(truncation / step)
    start = int(start)
    if coef != 0.0:
        # NB: the reference interpolates "backwards" (coef weights the lower
        # index); replicated verbatim for checkpoint parity.
        mean = means[start] * coef + means[start + 1] * (1 - coef)
        var = variances[start] * coef + variances[start + 1] * (1 - coef)
    else:
        mean = means[start]
        var = variances[start]
    return mean, var


class CondBatchNorm(_Stats):
    """Class- and latent-conditional batch norm: per-sample scale
    ``1 + cond @ scale^T`` and offset ``cond @ offset^T``."""

    def __init__(self, ch: int, cond_dim: int, n_stats: int):
        super().__init__(ch, n_stats)
        self.scale = _Linear(cond_dim, ch, bias=False)
        self.offset = _Linear(cond_dim, ch, bias=False)

    def forward(self, x, cond, truncation: float, eps: float):
        mean, inv = self.mean_inv(truncation, eps)
        if bf16_operands(x):
            # JAX's order in x's dtype (ganspace_tpu/models/biggan.py:205-224)
            # (cond arrives rounded to bf16 at ``default``: GenBlock)
            dt = x.dtype
            scale = (1.0 + F.linear(cond, self.scale.operand())).to(dt)
            offset = F.linear(cond, self.offset.operand()).to(dt)
            x = ((x - self.copies(mean, dt)[:, None, None])
                 * self.copies(inv, dt)[:, None, None])
            return x * scale[:, :, None, None] + offset[:, :, None, None]
        scale = inv * (1.0 + self.scale(cond))                 # [B, C]
        shift = self.offset(cond) - mean * scale
        return torch.addcmul(shift[:, :, None, None], x, scale[:, :, None, None])


class PlainBatchNorm(_Stats):
    def __init__(self, ch: int, n_stats: int):
        super().__init__(ch, n_stats)
        self.weight = _param(ch)
        self.bias = _param(ch)

    def forward(self, x, truncation: float, eps: float):
        mean, inv = self.mean_inv(truncation, eps)
        scale = inv * self.weight
        shift = self.bias - mean * scale
        if bf16_operands(x):
            # x * scale + shift in x's dtype (ganspace_tpu/models/biggan.py:275-281)
            dt = x.dtype
            return x * scale.to(dt)[None, :, None, None] + shift.to(dt)[None, :, None, None]
        return torch.addcmul(shift[None, :, None, None], x, scale[None, :, None, None])


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim; in bf16 op by op as ``jax.nn.softmax``
    computes it there (each step rounded, the sum in float32)."""
    if s.dtype == torch.float32:
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class SelfAttention(nn.Module):
    """SAGAN self-attention (reference ``model.py:57-96``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.snconv1x1_theta = _Conv(ch, ch // 8, 1, bias=False)
        self.snconv1x1_phi = _Conv(ch, ch // 8, 1, bias=False)
        self.snconv1x1_g = _Conv(ch, ch // 2, 1, bias=False)
        self.snconv1x1_o_conv = _Conv(ch // 2, ch, 1, bias=False)
        self.gamma = _param(1)
        self.copies = StorageCopies()

    def forward(self, base: str, x, ts: TapState):
        n, ch, h, w = x.shape
        theta = self.snconv1x1_theta(x).reshape(n, ch // 8, h * w)
        phi = F.max_pool2d(self.snconv1x1_phi(x), 2).reshape(n, ch // 8, h * w // 4)
        attn = _softmax(precision.bmm(theta.transpose(1, 2), phi))   # [n, p, q]
        g = F.max_pool2d(self.snconv1x1_g(x), 2).reshape(n, ch // 2, h * w // 4)
        attn_g = precision.bmm(g, attn.transpose(1, 2)).reshape(n, ch // 2, h, w)
        out = x + self.copies(self.gamma, x.dtype)[0] * self.snconv1x1_o_conv(attn_g)
        return ts.tap(base, out)


class GenBlock(nn.Module):
    """The bottleneck GenBlock (reference ``model.py:152-202``): four
    conditional batch norms, 1x1 -> 3x3 -> 3x3 -> 1x1 convs, nearest 2x in
    up-blocks, the channel-drop skip.  ``pixel_up``: an up-block the JAX
    package runs in pixel layout, where the preview policy takes nearest 2x
    then the 3x3 conv (the composite kernel of a bf16 weight is not bf16)."""

    def __init__(self, cin: int, cout: int, up: bool, cond_dim: int, n_stats: int):
        super().__init__()
        mid = cin // 4
        self.bn_0 = CondBatchNorm(cin, cond_dim, n_stats)
        self.conv_0 = _Conv(cin, mid, 1)
        self.bn_1 = CondBatchNorm(mid, cond_dim, n_stats)
        self.conv_1 = _Conv(mid, mid, 3)
        self.bn_2 = CondBatchNorm(mid, cond_dim, n_stats)
        self.conv_2 = _Conv(mid, mid, 3)
        self.bn_3 = CondBatchNorm(mid, cond_dim, n_stats)
        self.conv_3 = _Conv(mid, cout, 1)
        self.up = up
        # the kernels' weights of conv_1 (an up-block's composite kernel
        # among them) and of conv_2
        self.w1 = LayerWeights(self.conv_1.weight, self.conv_1.copies)
        self.w2 = LayerWeights(self.conv_2.weight, self.conv_2.copies)
        self.pixel_up = False

    def forward(self, base: str, x, cond, truncation: float, eps: float, ts: TapState):
        if get_precision() == "default":
            cond = round_bf16(cond)      # the operand of the four batch norms' products
        x0 = x
        x = ts.tap(f"{base}.bn_0", self.bn_0(x, cond, truncation, eps))
        x = ts.tap(f"{base}.relu", F.relu(x))
        x = ts.tap(f"{base}.conv_0", self.conv_0(x))
        if ts.stopped:
            return x
        x = ts.tap(f"{base}.bn_1", self.bn_1(x, cond, truncation, eps))
        x = ts.tap(f"{base}.relu", F.relu(x))
        if ts.stopped:
            return x
        if self.up and self.pixel_up and bf16_operands(x):
            y = conv3x3(nearest_up2x(x), self.conv_1.weight, cache=self.w1)
        elif self.up:
            kernel, cache = self.w1.nearest_up(x.dtype)
            y = upsample_conv(x, kernel, pad=1, cache=cache)
        else:
            y = conv3x3(x, self.conv_1.weight, cache=self.w1)
        x = ts.tap(f"{base}.conv_1", self.conv_1.add_bias(y))
        if ts.stopped:
            return x
        x = ts.tap(f"{base}.bn_2", self.bn_2(x, cond, truncation, eps))
        x = ts.tap(f"{base}.relu", F.relu(x))
        x = ts.tap(f"{base}.conv_2",
                   self.conv_2.add_bias(conv3x3(x, self.conv_2.weight, cache=self.w2)))
        if ts.stopped:
            return x
        x = ts.tap(f"{base}.bn_3", self.bn_3(x, cond, truncation, eps))
        x = ts.tap(f"{base}.relu", F.relu(x))
        x = ts.tap(f"{base}.conv_3", self.conv_3(x))
        if ts.stopped:
            return x
        if x.shape[1] != x0.shape[1]:
            x0 = x0[:, :x0.shape[1] // 2]  # channel-drop skip (model.py:195-197)
        if self.up:
            if not self.pixel_up and x0.dtype == torch.float32 and bf16_operands(x0):
                # the JAX package's tail upsamples the skip as a conv at the
                # policy's precision, which rounds it (ganspace_tpu/ops/s2d.py:328-342)
                x0 = round_bf16(x0)
            x0 = nearest_up2x(x0)
        return ts.tap(base, x + x0)


class Generator(nn.Module):
    def __init__(self, cfg: BigGANConfig):
        super().__init__()
        cond_dim = 2 * cfg.z_dim
        self.gen_z = _Linear(cond_dim, 4 * 4 * 16 * cfg.channel_width)
        self.layers = nn.ModuleList(
            SelfAttention(mod[1]) if mod[0] == "attn" else
            GenBlock(mod[2], mod[3], mod[1], cond_dim, cfg.n_stats)
            for mod in cfg.module_plan())
        ch = cfg.channel_width * cfg.layers[-1][2]
        self.bn = PlainBatchNorm(ch, cfg.n_stats)
        self.conv_to_rgb = _Conv(ch, ch, 3)
        # conv_to_rgb's kernel weights, for all its rows (the tap) and the
        # image's three, which the shape tells apart
        self.rgb_weights = LayerWeights(self.conv_to_rgb.weight, self.conv_to_rgb.copies)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

class BigGAN(BaseGenerator):
    """Drop-in equivalent of the reference ``BigGAN`` wrapper
    (``models/wrappers.py:525-648``) on one torch device, the card unless
    ``device`` says otherwise."""

    def __init__(self, resolution: int = 512, class_name=None, truncation: float = 1.0,
                 cfg: Optional[BigGANConfig] = None,
                 params: Optional[Dict[str, np.ndarray]] = None, init_seed: int = 0,
                 device="cuda"):
        resolution = int(resolution)
        super().__init__(f"BigGAN-{resolution}", class_name)
        device = require_device(device)
        self.cfg = cfg or BigGANConfig.for_resolution(resolution)
        self.resolution = self.cfg.output_dim
        self.truncation = truncation
        self.embeddings = _Linear(self.cfg.num_classes, self.cfg.z_dim, bias=False)
        self.generator = Generator(self.cfg)
        entry = self.cfg.tail_entry()
        for mi, layer in enumerate(self.generator.layers):
            if isinstance(layer, GenBlock):
                layer.pixel_up = layer.up and (entry is None or mi < entry)
        if params is None:
            # The local HuggingFace .bin, else a local TF-Hub dump, as the JAX
            # package reads them; seeded random weights when neither is there.
            found, tf_found, rel = checkpoints.locate_biggan(resolution)
            if found is not None:
                params = import_biggan(found)
            elif tf_found is not None:
                params = import_biggan_tf(tf_found, cfg=self.cfg)
            else:
                checkpoints.note_random_init(f"BigGAN-{resolution}", rel)
                params = init_params(self.cfg, init_seed)
        self.params_from_jax(params)
        self.to(device)
        self.v_class: Optional[torch.Tensor] = None
        self.set_output_class(class_name if class_name is not None else "husky")
        self.name = f"BigGAN-{resolution}-{self.outclass}-t{self.truncation}"
        self.has_latent_residual = True

    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> None:
        """Load the JAX package's flat parameter dict (the HuggingFace key
        layout ``init_params`` and the importers produce).  Every weight of
        the model must be there; other keys are ignored, as the JAX package
        ignores them."""
        keys = set(self.state_dict())
        self.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                              for k, v in flat.items() if k in keys}, strict=True)

    # -- class conditioning --------------------------------------------------
    def _one_hot(self, class_id: int) -> torch.Tensor:
        v = np.zeros((1, self.cfg.num_classes), np.float32)
        v[0, class_id] = 1.0
        return torch.from_numpy(v).to(self.device)

    def is_valid_class(self, class_id) -> bool:
        """Any of the 1000 ImageNet classes by index, name or WNID (JAX
        ``models/biggan.py:527-537``): the viewer's class box."""
        if isinstance(class_id, int):
            return class_id < self.cfg.num_classes
        if isinstance(class_id, str):
            return imagenet_classes.is_valid(class_id, aliases=CLASS_ALIASES)
        raise RuntimeError(f"Unknown class identifier {class_id}")

    def set_output_class(self, class_id):
        if class_id is None:          # "no preference": keep the current class
            return
        if isinstance(class_id, (int, np.integer)):
            self.v_class = self._one_hot(int(class_id))
            self.outclass = f"class{class_id}"
        elif isinstance(class_id, str):
            key = class_id.replace(" ", "_").lower()
            try:
                idx = imagenet_classes.resolve(key, aliases=CLASS_ALIASES)
            except KeyError as e:
                raise RuntimeError(str(e)) from None
            self.outclass = key
            self.v_class = self._one_hot(idx)
        else:
            raise RuntimeError(f"Unknown class identifier {class_id}")

    def get_conditional_state(self, z):
        return self.v_class

    def set_conditional_state(self, z, c):
        self.v_class = torch.as_tensor(c, dtype=torch.float32, device=self.device)

    # -- reference API -------------------------------------------------------
    def get_max_latents(self):
        return self.cfg.n_latents

    def sample_latent(self, n_samples=1, truncation=None, seed=None):
        with annotate("model.sample_latent"):
            if seed is None:
                seed = self.host_rng.next_seed()
            z = truncated_latents(n_samples, self.cfg.z_dim, truncation or self.truncation,
                                  seed)
            return torch.from_numpy(z).to(self.device)

    @torch.no_grad()
    def sample_latents_prefetched(self, n_batches: int, batch_size: int, keep_on=None):
        """``n_batches`` seedless ``sample_latent(batch_size)`` calls (the
        host stream): the seeds in the same order, each batch kept on
        ``keep_on`` (default: the model's device)."""
        seeds = [self.host_rng.next_seed() for _ in range(n_batches)]
        return [torch.from_numpy(truncated_latents(batch_size, self.cfg.z_dim,
                                                   self.truncation, s)).to(keep_on or self.device)
                for s in seeds]

    def _gaussian_latent_dim(self):
        return None           # truncated latents: no gaussian pre-sampler

    def _latents_from_gaussian(self, z):
        return z

    def device_latents_fn(self):
        """``fn(gen, n)``: ``truncation * TruncNormal(-2, 2)`` [n, z_dim] on
        ``gen``, which the fused streams and ``sample_latents_device`` draw
        (scipy's ``truncnorm(-2, 2)`` distributionally, reference
        ``utils.py:21-33``)."""
        dim, trunc = self.cfg.z_dim, float(self.truncation)
        return lambda gen, n: device_truncated(gen, n, dim, trunc)

    def tap_names(self):
        names = ["embeddings", "generator.gen_z"]
        for mi, mod in enumerate(self.cfg.module_plan()):
            base = f"generator.layers.{mi}"
            if mod[0] == "attn":
                names.append(base)
            else:
                names += [f"{base}.bn_0", f"{base}.relu", f"{base}.conv_0",
                          f"{base}.bn_1", f"{base}.conv_1", f"{base}.bn_2",
                          f"{base}.conv_2", f"{base}.bn_3", f"{base}.conv_3", base]
        names += ["generator.bn", "generator.relu", "generator.conv_to_rgb"]
        return tuple(names)

    def _n_layers_for(self, layer_name: Optional[str]) -> int:
        n_modules = len(self.cfg.module_plan())
        if layer_name is None:
            return n_modules
        if layer_name in ("embeddings", "generator.gen_z"):
            return 0
        m = re.match(r"^generator\.layers\.([0-9]+)", layer_name)
        if m:
            return int(m.group(1)) + 1
        return n_modules

    @staticmethod
    def _stop_point(tap: str) -> str:
        # The shared ``relu`` module fires 4x per GenBlock; the reference runs
        # the whole block and its hook keeps the LAST call's output
        # (wrappers.py:609-648 + nethook overwrite semantics), so the stop
        # point is the block boundary while retention stays on the relu tap.
        if tap.endswith(".relu") and tap.startswith("generator.layers"):
            return tap.rsplit(".", 1)[0]
        return tap

    # -- execution ----------------------------------------------------------
    def synthesize(self, zs, ts: TapState, n_layers_to_run: int,
                   act_dtype: Optional[str] = None):
        """One call of the reference's synthesis on ``n_latents`` [B, z_dim]
        latents; returns the raw [-1, 1] image in float32, or None when
        ``ts`` stopped at a tap or ``n_layers_to_run`` modules ran.
        ``act_dtype`` (``'bfloat16'`` or None): the activation storage from
        ``gen_z``'s reshape on."""
        cfg, gen = self.cfg, self.generator
        onehot = self.v_class.expand(zs[0].shape[0], cfg.num_classes)
        e = self.embeddings(onehot)
        embeds = [ts.tap("embeddings", e) for _ in zs]
        if ts.stop_at == "embeddings":
            return None

        def cond(i):
            return torch.cat([zs[i], embeds[i]], dim=1)

        z = ts.tap("generator.gen_z", gen.gen_z(cond(0)))
        if ts.stopped:
            return None
        x = z.reshape(-1, 4, 4, 16 * cfg.channel_width).permute(0, 3, 1, 2)
        if act_dtype is not None:
            x = x.to(getattr(torch, act_dtype))

        trunc, eps = float(self.truncation), cfg.eps
        cond_idx = 1
        for mi, layer in enumerate(gen.layers):
            if mi >= n_layers_to_run:
                return None
            base = f"generator.layers.{mi}"
            if isinstance(layer, SelfAttention):
                x = layer(base, x, ts)
            else:
                x = layer(base, x, cond(cond_idx), trunc, eps, ts)
                cond_idx += 1
            if ts.stopped:
                return None

        x = ts.tap("generator.bn", gen.bn(x, trunc, eps))
        x = ts.tap("generator.relu", F.relu(x))
        rgb = gen.conv_to_rgb
        name = "generator.conv_to_rgb"
        if name in ts.retain or name in ts.edits or ts.stop_at == name:
            # the tap sees all of conv_to_rgb's channels
            x = ts.tap(name, rgb.add_bias(conv3x3(x, rgb.weight, cache=gen.rgb_weights)))
            if ts.stopped:
                return None
            x = x[:, :3]
        else:
            # only the image's three channels are kept (biggan.py:471-472)
            x = (conv3x3(x, rgb.weight[:3], cache=gen.rgb_weights)
                 + rgb.copies(rgb.bias, x.dtype)[:3].reshape(1, 3, 1, 1))
        return torch.tanh(x).float()

    @grad_while_edit_override
    def _run(self, x, stop_at: Optional[str], layer_name: Optional[str] = None):
        zs = x if isinstance(x, list) else self.cfg.n_latents * [x]
        if len(zs) != self.cfg.n_latents:
            raise ValueError(f"Expected {self.cfg.n_latents} latents, got {len(zs)}")
        zs = [torch.as_tensor(z, dtype=torch.float32, device=self.device) for z in zs]
        retain, edits, store = self._instrumentation()
        n_run = (self._n_layers_for(layer_name) if stop_at is not None
                 else len(self.cfg.module_plan()))
        ts = TapState(retain, edits, stop_at)
        with ieee_f32():
            img = self.synthesize(zs, ts, n_run, synth_dtype_name())
        if store is not None:
            store(ts.retained)
        return img

    def forward(self, x):
        return 0.5 * (self._run(x, stop_at=None) + 1)

    def partial_forward(self, x, layer_name: str):
        self._run(x, stop_at=self._stop_point(self.resolve_tap(layer_name)),
                  layer_name=layer_name)
        return None

    def pure_acts_fn(self, layer_name: str):
        """``fn(z [n, z_dim]) -> activations [n, -1]`` at the tap, one z in
        every latent slot (the fused stream's block): ``synthesize`` with a
        ``TapState`` that retains only the tap and stops where
        ``partial_forward`` stops, the current class, the kernels exactly as
        in ``partial_forward``, in the activation storage the policy names
        when it is built."""
        tap = self.resolve_tap(layer_name)
        stop_at = self._stop_point(tap)
        n_run = self._n_layers_for(layer_name)
        act_dtype = synth_dtype_name()

        @torch.no_grad()
        def fn(z):
            ts = TapState((tap,), None, stop_at)
            with ieee_f32():
                self.synthesize(self.cfg.n_latents * [z], ts, n_run, act_dtype)
            return ts.retained[tap].reshape(z.shape[0], -1)
        return fn
