"""Progressive GAN generator as a PyTorch module.

Counterpart of ``ganspace_tpu/models/proggan.py`` and, through it, of the
GANDissect ``ProgressiveGenerator`` the reference wraps
(``netdissect/proggan.py``, ``models/wrappers.py:469-522``): a column of
pixel norm, equalized-lr conv (the WScale layer) and leaky ReLU 0.2, with a
nearest 2x upsample in every other layer, on the resolution -> channel
schedule of ``proggan.py:61-69``, and the LSUN checkpoints' layer names
``layer1 .. layerN`` and ``output_KxK``.  Seven LSUN classes.

The module tree follows the checkpoint key names, so ``state_dict`` keys are
the JAX package's flat parameter keys (``layer3.conv.weight``,
``layer3.wscale.b``) and :meth:`ProGAN.params_from_jax` loads one without
renaming.  Built without ``cfg`` and ``params``, the model loads the
GANDissect ``.pth`` or the karras2018 ``.pkl`` that ``models/checkpoints.py``
finds, as the JAX package does, and keeps seeded random weights when there
is neither.

Synthesis runs NCHW at every stage; the JAX package's space-to-depth tail is
TPU-only and is not ported.  Per layer: pixel norm (before every conv, the
1x1 output conv included), the conv, the WScale ``x * gain / sqrt(cin) +
b`` (gain sqrt(2) / k, 1 for the output block), leaky ReLU but after the
output conv.  Where each conv runs:

* ``layer1``, a 4x4 conv with padding 3 on the 1x1 latent, is one dense
  product (cuBLAS), its output read flipped;
* every stride-1 3x3 conv goes through kernel B's plain mode,
  :func:`conv3x3`, with the WScale factor folded into the weight;
* every up layer, nearest 2x then 3x3, goes through the stride-2 kernel,
  :func:`upsample_conv`, as the one transposed conv it equals (the 4x4
  composite kernel of the scaled weight, padding 1).  Nearest upsampling
  commutes with the per-pixel norm, so the norm runs on the small map;
* the 1x1 output conv stays a stock PyTorch conv.

Under the preview policy (``ops/precision.py``) the column follows the JAX
package's rules (``ganspace_tpu/models/proggan.py:89-147``), rounding order
included: the latent is cast to the storage dtype first, every op runs in
it, each conv takes the weight in that dtype on the bf16 datapath, the
WScale factor (rounded to the storage) multiplies the conv's output, as
JAX's ``x * (gain / sqrt(cin)) + b``, where the float32 policy folds it
into the weight; the up layers' composite kernel is formed from the
storage-dtype weight (``ganspace_tpu/ops/s2d.py:370-380``) from the layer
where the JAX package's space-to-depth tail starts, while the earlier up
layers run nearest 2x then the 3x3 conv on the rounded weight, as its pixel
layout does (``ops/modconv.S2D_MAX_CH``); the image returns float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.models import checkpoints
from ganspace_tpu_torch.models.base import BaseGenerator, TapState, grad_while_edit_override
from ganspace_tpu_torch.models.tf_import import import_progan_tf
from ganspace_tpu_torch.models.torch_import import import_progan
from ganspace_tpu_torch.ops import precision
from ganspace_tpu_torch.ops.modconv import (
    S2D_MAX_CH, LayerWeights, conv3x3, nearest_up2x, upsample_conv)
from ganspace_tpu_torch.ops.precision import (
    StorageCopies, bf16_operands, ieee_f32, synth_dtype_name)
from ganspace_tpu_torch.sampling import gaussian_latents

VALID_CLASSES = ["bedroom", "churchoutdoor", "conferenceroom", "diningroom",
                 "kitchen", "livingroom", "restaurant"]

# Resolution -> feature-depth schedule (reference proggan.py:61-69).
SIZES_FOR_RESOLUTION = {
    8: [512, 512, 512],
    16: [512, 512, 512, 512],
    32: [512, 512, 512, 512, 256],
    64: [512, 512, 512, 512, 256, 128],
    128: [512, 512, 512, 512, 256, 128, 64],
    256: [512, 512, 512, 512, 256, 128, 64, 32],
    1024: [512, 512, 512, 512, 512, 256, 128, 64, 32, 16],
}


@dataclass(frozen=True)
class ProGANConfig:
    sizes: Tuple[int, ...]

    @classmethod
    def for_resolution(cls, resolution: int) -> "ProGANConfig":
        return cls(tuple(SIZES_FOR_RESOLUTION[resolution]))

    def layer_plan(self):
        """[(name, cin, cout, kernel, pad, upsample)] mirroring proggan.py:72-87."""
        s = self.sizes
        plan = [("layer1", s[0], s[1], 4, 3, False),
                ("layer2", s[1], s[1], 3, 1, False)]
        idx = 3
        for si, so in zip(s[1:-1], s[2:]):
            plan.append((f"layer{idx}", si, so, 3, 1, True))
            plan.append((f"layer{idx + 1}", so, so, 3, 1, False))
            idx += 2
        dim = 4 * (2 ** (len(plan) // 2 - 1))
        plan.append((f"output_{dim}x{dim}", s[-1], 3, 1, 0, False))
        return plan


def init_params(cfg: ProGANConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters, drawn exactly as ``ganspace_tpu``'s ``init_params``
    (same keys, same numpy draws in the same order: bit-identical)."""
    rs = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}
    for name, cin, cout, k, _, _ in cfg.layer_plan():
        p[f"{name}.conv.weight"] = rs.randn(cout, cin, k, k).astype(np.float32)
        p[f"{name}.wscale.b"] = 0.1 * rs.randn(cout).astype(np.float32)
    return p


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


def _pixel_norm(x: torch.Tensor) -> torch.Tensor:
    # proggan.py:102-103: x / sqrt(mean(x^2, dim=1) + 1e-8)
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


def _pixel_norm_preview(x: torch.Tensor) -> torch.Tensor:
    """The pixel norm in x's dtype as the JAX package computes it, one
    rounding per op: x * reciprocal(sqrt(mean(x^2) + 1e-8))."""
    return x * torch.reciprocal(torch.sqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8))


class _Weight(nn.Module):
    def __init__(self, *shape):
        super().__init__()
        self.weight = _param(*shape)


class _Bias(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.b = _param(ch)


class ProGANLayer(nn.Module):
    """One layer of the column: pixel norm, the conv (nearest 2x first in an
    up layer), the WScale, leaky ReLU 0.2 unless it is the output block.
    ``pixel_up``: an up layer the JAX package runs in pixel layout, where
    the preview policy takes nearest 2x then the 3x3 conv."""

    def __init__(self, cin: int, cout: int, k: int, up: bool, is_output: bool):
        super().__init__()
        self.conv = _Weight(cout, cin, k, k)
        self.wscale = _Bias(cout)
        self.k, self.up, self.is_output = k, up, is_output
        # WScaleLayer (proggan.py:110-121): gain / sqrt(fan_in) with gain
        # sqrt(2) / kernel size for the conv blocks, 1 for the output block
        self.scale = (1.0 if is_output else math.sqrt(2.0) / k) / math.sqrt(cin)
        # storage copies and the kernels' weights: the raw weight's (the
        # preview's 3x3 convs), an up layer's composite kernels
        self.copies = StorageCopies()
        self.weights = LayerWeights(self.conv.weight, self.copies)
        self.pixel_up = False

    def forward_preview(self, x: torch.Tensor) -> torch.Tensor:
        """The layer on the bf16 datapath in x's storage (float32 or bf16),
        in the JAX package's rounding order: the conv on the raw weight,
        then ``* bf16(scale) + b``, leaky ReLU."""
        dt = x.dtype
        x = _pixel_norm_preview(x)
        w = self.conv.weight
        if self.up and self.pixel_up:
            y = conv3x3(nearest_up2x(x), w, cache=self.weights)
        elif self.up:
            kernel, cache = self.weights.nearest_up(dt)
            y = upsample_conv(x, kernel, pad=1, cache=cache)
        elif self.k == 3:
            y = conv3x3(x, w, cache=self.weights)
        elif self.k == 4:
            y = precision.einsum("bc,ocuv->bouv", x.flatten(1), w).flip(2, 3)
        else:
            y = precision.conv2d(x, self.copies(w, dt))
        # the scalars in x's dtype, as JAX's weakly typed constants
        scale, slope = (torch.tensor(v, dtype=dt).item() for v in (self.scale, 0.2))
        y = y * scale + self.copies(self.wscale.b, dt).reshape(1, -1, 1, 1)
        return y if self.is_output else F.leaky_relu(y, slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if bf16_operands(x):
            return self.forward_preview(x)
        x = _pixel_norm(x)
        w = self.conv.weight
        if self.up:
            kernel, cache = self.weights.nearest_up(torch.float32, self.scale)
            y = upsample_conv(x, kernel, pad=1, cache=cache)
        elif self.k == 3:
            y = conv3x3(x, w * self.scale)
        elif self.k == 4:
            # layer1: a 4x4 correlation with padding 3 of the 1x1 latent map
            # reads the kernel flipped, out[o, i, j] = sum_c w[o, c, 3-i, 3-j] z[c]
            y = torch.einsum("bc,ocuv->bouv", x.flatten(1), w).flip(2, 3) * self.scale
        else:
            y = F.conv2d(x, w) * self.scale          # the 1x1 output conv
        y = y + self.wscale.b.reshape(1, -1, 1, 1)
        return y if self.is_output else F.leaky_relu(y, 0.2)


class ProGAN(BaseGenerator):
    """Drop-in equivalent of the reference ``ProGAN`` wrapper
    (``models/wrappers.py:469-522``) on one torch device, the card unless
    ``device`` says otherwise."""

    def __init__(self, lsun_class: Optional[str] = None, resolution: int = 256,
                 cfg: Optional[ProGANConfig] = None,
                 params: Optional[Dict[str, np.ndarray]] = None, init_seed: int = 0,
                 device="cuda"):
        super().__init__("ProGAN", lsun_class)
        device = require_device(device)
        if self.outclass is not None and self.outclass not in VALID_CLASSES:
            raise ValueError(
                f"Invalid LSUN class {self.outclass}, should be one of {VALID_CLASSES}")
        if cfg is None and params is None:
            # The local .pth, else a local TF-era .pkl, as the JAX package
            # reads them; seeded random weights when neither is there.
            found, rel = checkpoints.locate_progan(self.outclass)
            if found is not None:
                importer = import_progan_tf if found.suffix == ".pkl" else import_progan
                params, sizes = importer(found)
                cfg = ProGANConfig(sizes)
            else:
                checkpoints.note_random_init(f"ProGAN-{self.outclass}", rel)
        self.cfg = cfg or ProGANConfig.for_resolution(resolution)
        self.resolution = 4 * 2 ** (len(self.cfg.sizes) - 2)
        self.name = f"ProGAN-{self.outclass}"
        self.has_latent_residual = False
        plan = self.cfg.layer_plan()
        # the JAX package's space-to-depth tail starts at the first up layer
        # of at most S2D_MAX_CH output channels (ganspace_tpu/models/proggan.py:99-100)
        tail = False
        for li, (name, cin, cout, k, _, up) in enumerate(plan):
            layer = ProGANLayer(cin, cout, k, up, li == len(plan) - 1)
            tail = tail or (up and k == 3 and cout <= S2D_MAX_CH)
            layer.pixel_up = up and not tail
            self.add_module(name, layer)
        self.params_from_jax(params if params is not None
                             else init_params(self.cfg, init_seed))
        self.to(device)

    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> None:
        """Load the JAX package's flat parameter dict (the GANDissect key
        layout ``init_params`` and the importers produce)."""
        self.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                              for k, v in flat.items()}, strict=True)

    def tap_names(self):
        return tuple(name for name, *_ in self.cfg.layer_plan())

    def sample_latent(self, n_samples=1, seed=None, truncation=None):
        if seed is None:
            seed = self.host_rng.next_seed()
        # zdataset.z_sample_for_model semantics (netdissect/zdataset.py:26-40)
        z = gaussian_latents(n_samples, self.cfg.sizes[0], seed)
        return torch.from_numpy(z).to(self.device)

    def _gaussian_latent_dim(self):
        return self.cfg.sizes[0]

    def _latents_from_gaussian(self, z):
        return z

    # -- execution ----------------------------------------------------------
    def synthesize(self, z: torch.Tensor, ts: TapState, act_dtype: Optional[str] = None):
        """The column on latents [B, sizes[0]]; returns the raw [-1, 1]-scaled
        image in float32, or None when ``ts`` stopped at a tap.
        ``act_dtype`` (``'bfloat16'`` or None): the activation storage, from
        the latent on."""
        x = z.reshape(z.shape[0], -1, 1, 1)
        if act_dtype is not None:
            x = x.to(getattr(torch, act_dtype))
        for name in self.tap_names():
            x = ts.tap(name, getattr(self, name)(x))
            if ts.stopped:
                return None
        return x.float()

    @grad_while_edit_override
    def _run(self, x, stop_at: Optional[str]):
        if isinstance(x, list):
            if len(x) != 1:
                raise ValueError("ProGAN only supports a single global latent")
            x = x[0]
        z = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        retain, edits, store = self._instrumentation()
        ts = TapState(retain, edits, stop_at)
        with ieee_f32():
            img = self.synthesize(z, ts, synth_dtype_name())
        if store is not None:
            store(ts.retained)
        return img

    def forward(self, x):
        return 0.5 * (self._run(x, None) + 1)

    def partial_forward(self, x, layer_name: str):
        self._run(x, self.resolve_tap(layer_name))
        return None

    def pure_acts_fn(self, layer_name: str):
        """``fn(z [n, sizes[0]]) -> activations [n, -1]`` at the tap:
        ``synthesize`` with a ``TapState`` that retains only the tap and
        stops there, the kernels exactly as in ``partial_forward``, in the
        activation storage the policy names when it is built."""
        tap = self.resolve_tap(layer_name)
        act_dtype = synth_dtype_name()

        @torch.no_grad()
        def fn(z):
            ts = TapState((tap,), None, tap)
            with ieee_f32():
                self.synthesize(z, ts, act_dtype)
            return ts.retained[tap].reshape(z.shape[0], -1)
        return fn
