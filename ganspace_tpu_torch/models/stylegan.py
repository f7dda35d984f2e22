"""StyleGAN (v1) generator as a PyTorch module.

Counterpart of ``ganspace_tpu/models/stylegan.py`` and, through it, of the
lernapparat port the reference consumes (``models/stylegan/model.py``,
``models/wrappers.py:270-436``): equalized-lr dense and conv layers, a
noise layer per epilogue with per-resolution buffers, AdaIN (instance norm
with float32 statistics, then StyleMod), the const-input block, and blocks
``4x4 .. 1024x1024`` at 11 output classes of 256-1024 px.  Z or W primary
latent space; 18 W slots (W+).

The module tree follows the checkpoint key names, so ``state_dict`` keys
are the JAX package's flat parameter keys (``g_mapping.dense0.weight``,
``g_synthesis.blocks.8x8.conv0_up.weight``, ...) and
:meth:`StyleGAN.params_from_jax` loads one without renaming.  Built
without ``params``, the model loads the lernapparat ``.pt`` or an NVlabs pickle that
``models/checkpoints.py`` finds, as the JAX package does, and keeps seeded
random weights when there is none.  Synthesis
runs NCHW at every stage; the JAX package's space-to-depth tail is TPU-only
and is not ported.  Its 3x3 convs go through kernel B (``ops/modconv.py``):

* ``conv`` (4 px), ``conv1`` and ``conv0_up`` below 128 px (nearest 2x
  first) through the plain mode, :func:`conv3x3`;
* ``conv0_up`` from 128 px, the fused upscale (the 3x3 kernel padded and
  summed into 4x4, a stride-2 transposed conv with padding 1), through the
  stride-2 mode, :func:`upsample_conv`.

The [1, 2, 1] blur after each ``conv0_up`` and the 1x1 ``torgb`` stay stock
PyTorch ops.  Under the preview policy (``ops/precision.py``) the
activations are stored in bf16 from the first block of at most 64 channels
at 128 px and up, where the JAX package's storage dtype engages
(``ganspace_tpu/models/stylegan.py:245-307``): the low-resolution blocks
keep float32, since bf16 input rounding there destroys what the instance
norm amplifies.  The instance statistics stay float32, and the image is
float32.
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
from ganspace_tpu_torch.models.tf_import import import_stylegan_tf
from ganspace_tpu_torch.models.torch_import import import_stylegan
from ganspace_tpu_torch.ops import precision
from ganspace_tpu_torch.ops.linear import equal_linear, pixel_norm
from ganspace_tpu_torch.ops.modconv import LayerWeights, conv3x3, upsample_conv
from ganspace_tpu_torch.ops.precision import StorageCopies, ieee_f32, synth_dtype_name
from ganspace_tpu_torch.sampling import gaussian_latents
from ganspace_tpu_torch.utils.tracing import annotate

# Reference wrapper class->resolution table (wrappers.py:276-291).
CONFIGS = {
    "ffhq": 1024,
    "celebahq": 1024,
    "bedrooms": 256,
    "cars": 512,
    "cats": 256,
    "vases": 1024,
    "wikiart": 512,
    "fireworks": 512,
    "abstract": 512,
    "anime": 512,
    "ukiyo-e": 512,
}

N_BROADCAST_LATENTS = 18  # reference hardcodes 18 W slots (wrappers.py:361-362)

#: the fused upscale + transposed conv from this output resolution on
#: (reference model.py:82)
FUSED_MIN_RES = 128

#: the preview storage engages at the blocks of at most this many channels
#: (at FUSED_MIN_RES and up): the JAX package's space-to-depth entry
PREVIEW_MAX_CH = 64


@dataclass(frozen=True)
class SG1Config:
    resolution: int = 1024
    w_dim: int = 512
    fmap_base: int = 8192
    fmap_max: int = 512

    @property
    def log_size(self) -> int:
        return int(math.log2(self.resolution))

    def block_names(self) -> Tuple[str, ...]:
        return tuple(f"{2**r}x{2**r}" for r in range(2, self.log_size + 1))

    def block_channels(self) -> Tuple[int, ...]:
        return tuple(min(int(self.fmap_base / (2.0 ** (r - 1))), self.fmap_max)
                     for r in range(2, self.log_size + 1))


def init_params(cfg: SG1Config, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters, drawn exactly as ``ganspace_tpu``'s ``init_params``
    (same keys, same numpy draws in the same order: bit-identical)."""
    rs = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}

    def lin(name, fan_in, fan_out, lrmul=1.0):
        p[f"{name}.weight"] = rs.randn(fan_out, fan_in).astype(np.float32) / lrmul
        p[f"{name}.bias"] = np.zeros((fan_out,), np.float32)

    def conv(name, cin, cout, k):
        p[f"{name}.weight"] = rs.randn(cout, cin, k, k).astype(np.float32)
        p[f"{name}.bias"] = np.zeros((cout,), np.float32)

    def epilogue(name, ch):
        p[f"{name}.top_epi.noise.weight"] = 0.1 * rs.randn(ch).astype(np.float32)
        lin(f"{name}.style_mod.lin", cfg.w_dim, 2 * ch)

    for i in range(8):
        lin(f"g_mapping.dense{i}", cfg.w_dim, cfg.w_dim, lrmul=0.01)

    names, chans = cfg.block_names(), cfg.block_channels()
    for bi, (bname, ch) in enumerate(zip(names, chans)):
        base = f"g_synthesis.blocks.{bname}"
        if bi == 0:
            p[f"{base}.const"] = np.ones((1, ch, 4, 4), np.float32)
            p[f"{base}.bias"] = np.ones((ch,), np.float32)
        else:
            conv(f"{base}.conv0_up", chans[bi - 1], ch, 3)
        epilogue(f"{base}.epi1", ch)
        conv(f"{base}.conv" if bi == 0 else f"{base}.conv1", ch, ch, 3)
        epilogue(f"{base}.epi2", ch)
    conv("g_synthesis.torgb", chans[-1], 3, 1)
    return p


# ---------------------------------------------------------------------------
# Modules (checkpoint key layout; weights are filled by load_state_dict)
# ---------------------------------------------------------------------------

def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


def blur121_kernel() -> torch.Tensor:
    """The normalized [1, 2, 1] x [1, 2, 1] blur kernel, [1, 1, 3, 3]."""
    k = torch.tensor([1.0, 2.0, 1.0])
    return (torch.outer(k, k) / 16.0).reshape(1, 1, 3, 3)


def _blur121(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise [1, 2, 1] blur with ``k`` from :func:`blur121_kernel`,
    stride 1 (reference model.py:145-169)."""
    c = x.shape[1]
    return precision.conv2d(x, _COPIES(k, x.dtype).expand(c, 1, 3, 3), padding=1, groups=c)


#: the blur kernel in each storage, made once
_COPIES = StorageCopies()


class EqualizedLinear(nn.Module):
    """Equalized-lr dense layer, weight [out, in] (reference model.py:26-49)."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 gain: float = math.sqrt(2.0)):
        super().__init__()
        self.weight = _param(out_dim, in_dim)
        self.bias = _param(out_dim)
        self.lr_mul = lr_mul
        self.gain = gain
        self.copies = StorageCopies()

    def forward(self, x):
        return equal_linear(x, self.weight, self.bias, lr_mul=self.lr_mul, gain=self.gain,
                            copies=self.copies)


class EqualizedConv2d(nn.Module):
    """``MyConv2d``: equalized-lr conv, weight [out, in, k, k] (reference
    model.py:51-104); :meth:`scaled_weight` applies the He constant."""

    def __init__(self, in_ch: int, out_ch: int, k: int, gain: float = math.sqrt(2.0)):
        super().__init__()
        self.weight = _param(out_ch, in_ch, k, k)
        self.bias = _param(out_ch)
        self.gain = gain
        self.copies = StorageCopies()

    def scaled_weight(self) -> torch.Tensor:
        out_ch, in_ch, k, _ = self.weight.shape
        return self.weight * (self.gain * ((in_ch * k * k) ** -0.5))

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y + self.copies(self.bias, y.dtype).reshape(1, -1, 1, 1)


class MappingNetwork(nn.Module):
    """PixelNorm, then 8 x (dense with lr_mul 0.01, leaky ReLU 0.2)."""

    def __init__(self, w_dim: int):
        super().__init__()
        for i in range(8):
            self.add_module(f"dense{i}", EqualizedLinear(w_dim, w_dim, lr_mul=0.01))

    def forward(self, z):
        x = pixel_norm(z)
        for i in range(8):
            x = F.leaky_relu(getattr(self, f"dense{i}")(x), 0.2)
        return x


class _Noise(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.weight = _param(ch)


class _TopEpi(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.noise = _Noise(ch)


class _StyleMod(nn.Module):
    def __init__(self, w_dim: int, ch: int):
        super().__init__()
        self.lin = EqualizedLinear(w_dim, 2 * ch, gain=1.0)


class LayerEpilogue(nn.Module):
    """Noise -> leaky ReLU -> InstanceNorm -> StyleMod (reference model.py:230-253)."""

    def __init__(self, ch: int, w_dim: int):
        super().__init__()
        self.top_epi = _TopEpi(ch)
        self.style_mod = _StyleMod(w_dim, ch)
        self.copies = StorageCopies()

    def forward(self, name: str, x, w_lat, noise, ts: TapState):
        nw = self.copies(self.top_epi.noise.weight, x.dtype).reshape(1, -1, 1, 1)
        x = x + nw * self.copies(noise, x.dtype)
        x = ts.tap(f"{name}.top_epi.noise", x)
        if ts.stopped:
            return x
        x = F.leaky_relu(x, 0.2)
        # InstanceNorm2d, affine=False, eps=1e-5, float32 statistics (also
        # under bf16 storage).
        xf = x.float()
        mu = torch.mean(xf, dim=(2, 3), keepdim=True)
        var = torch.var(xf, dim=(2, 3), keepdim=True, correction=0)
        x = ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)
        style = ts.tap(f"{name}.style_mod.lin", self.style_mod.lin(w_lat))
        if ts.stopped:
            return x
        style = style.reshape(-1, 2, x.shape[1], 1, 1).to(x.dtype)
        x = x * (style[:, 0] + 1.0) + style[:, 1]
        return ts.tap(name, x)


class InputBlock(nn.Module):
    """The 4x4 block: const + bias, epilogue, 3x3 conv, epilogue."""

    def __init__(self, ch: int, w_dim: int):
        super().__init__()
        self.const = _param(1, ch, 4, 4)
        self.bias = _param(ch)
        self.epi1 = LayerEpilogue(ch, w_dim)
        self.conv = EqualizedConv2d(ch, ch, 3)
        self.epi2 = LayerEpilogue(ch, w_dim)
        self.weight_cache = LayerWeights(self.conv.weight, self.conv.copies)

    def forward(self, base: str, batch: int, lat0, lat1, noise, ts: TapState):
        x = self.const.expand(batch, -1, -1, -1) + self.bias.reshape(1, -1, 1, 1)
        x = self.epi1(f"{base}.epi1", x, lat0, noise, ts)
        if ts.stopped:
            return x
        x = ts.tap(f"{base}.conv", self.conv.add_bias(
            conv3x3(x, self.conv.scaled_weight(), cache=self.weight_cache)))
        if ts.stopped:
            return x
        return self.epi2(f"{base}.epi2", x, lat1, noise, ts)


class UpBlock(nn.Module):
    """A 2x block: conv0_up (upscale, 3x3 conv, blur), epilogue, conv1, epilogue."""

    def __init__(self, in_ch: int, ch: int, w_dim: int, res: int):
        super().__init__()
        self.conv0_up = EqualizedConv2d(in_ch, ch, 3)
        self.epi1 = LayerEpilogue(ch, w_dim)
        self.conv1 = EqualizedConv2d(ch, ch, 3)
        self.epi2 = LayerEpilogue(ch, w_dim)
        self.fused = res >= FUSED_MIN_RES
        self.weight_cache = LayerWeights(self.conv0_up.weight, self.conv0_up.copies)
        self.conv1_cache = LayerWeights(self.conv1.weight, self.conv1.copies)
        #: the block takes the preview storage (bf16) under that policy
        self.preview_storage = self.fused and ch <= PREVIEW_MAX_CH

    def upconv(self, x: torch.Tensor) -> torch.Tensor:
        """``conv0_up`` before its blur and bias."""
        wm = self.conv0_up.scaled_weight()
        if self.fused:
            # Pad the 3x3 kernel to 4x4 by summing four shifted copies, then
            # a stride-2 transposed conv with padding 1 (model.py:82-91).
            wp = F.pad(wm, (1, 1, 1, 1))
            w4 = (wp[:, :, 1:, 1:] + wp[:, :, :-1, 1:]
                  + wp[:, :, 1:, :-1] + wp[:, :, :-1, :-1])
            return upsample_conv(x, w4, pad=1, cache=self.weight_cache)
        n, c, h, w = x.shape
        x = x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)
        return conv3x3(x, wm, cache=self.weight_cache)

    def forward(self, base: str, x, lat0, lat1, noise, blur_k, ts: TapState):
        x = ts.tap(f"{base}.conv0_up",
                   self.conv0_up.add_bias(_blur121(self.upconv(x), blur_k)))
        if ts.stopped:
            return x
        x = self.epi1(f"{base}.epi1", x, lat0, noise, ts)
        if ts.stopped:
            return x
        x = ts.tap(f"{base}.conv1",
                   self.conv1.add_bias(conv3x3(x, self.conv1.scaled_weight(),
                                               cache=self.conv1_cache)))
        if ts.stopped:
            return x
        return self.epi2(f"{base}.epi2", x, lat1, noise, ts)


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: SG1Config):
        super().__init__()
        names, chans = cfg.block_names(), cfg.block_channels()
        self.blocks = nn.ModuleDict()
        for bi, (bname, ch) in enumerate(zip(names, chans)):
            self.blocks[bname] = (InputBlock(ch, cfg.w_dim) if bi == 0 else
                                  UpBlock(chans[bi - 1], ch, cfg.w_dim, 2 ** (bi + 2)))
        self.torgb = EqualizedConv2d(chans[-1], 3, 1, gain=1.0)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

class StyleGAN(BaseGenerator):
    """Drop-in equivalent of the reference ``StyleGAN`` wrapper
    (``models/wrappers.py:270-436``) on one torch device, the card unless
    ``device`` says otherwise."""

    def __init__(self, class_name: Optional[str] = None, truncation: float = 1.0,
                 use_w: bool = False, cfg: Optional[SG1Config] = None,
                 params: Optional[Dict[str, np.ndarray]] = None, init_seed: int = 0,
                 device="cuda"):
        super().__init__("StyleGAN", class_name or "ffhq")
        device = require_device(device)
        if cfg is None:
            if self.outclass not in CONFIGS:
                raise ValueError(
                    f"Invalid StyleGAN class {self.outclass}, should be one of "
                    f"[{', '.join(CONFIGS)}]")
            cfg = SG1Config(resolution=CONFIGS[self.outclass])
        self.cfg = cfg
        self.resolution = cfg.resolution
        self.truncation = truncation   # accepted and unused, as in the reference
        self.w_primary = use_w
        self.name = f"StyleGAN-{self.outclass}"
        self.has_latent_residual = True

        self.g_mapping = MappingNetwork(cfg.w_dim)
        self.g_synthesis = SynthesisNetwork(cfg)
        if params is None:
            # The local .pt, else a local NVlabs pickle, as the JAX package
            # reads them; seeded random weights when neither is there.
            found, rel = checkpoints.locate_stylegan(self.outclass, self.resolution)
            if found is not None and found.suffix == ".pkl":
                params = import_stylegan_tf(found)
            elif found is not None:
                params = import_stylegan(found)
            else:
                checkpoints.note_random_init(self.name, rel)
                params = init_params(cfg, init_seed)
        self.params_from_jax(params)
        self.register_buffer("blur_kernel", blur121_kernel(), persistent=False)
        self.to(device)
        self.set_noise_seed(0)

    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> None:
        """Load the JAX package's flat parameter dict (the lernapparat key
        layout ``init_params`` produces)."""
        self.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                              for k, v in flat.items()}, strict=True)

    # -- reference API -------------------------------------------------------
    def latent_space_name(self):
        return "W" if self.w_primary else "Z"

    def use_w(self):
        self.w_primary = True

    def use_z(self):
        self.w_primary = False

    def get_max_latents(self):
        return N_BROADCAST_LATENTS

    def set_output_class(self, new_class):
        if new_class is not None and self.outclass != new_class:
            raise RuntimeError("StyleGAN: cannot change output class without reloading")

    def set_noise_seed(self, seed: int):
        # One noise buffer per resolution; BOTH epilogues of a block reuse it
        # (the reference reseeds torch per NoiseLayer with the same seed, so
        # same-shape buffers are identical: wrappers.py:420-436).
        for i, r in enumerate(range(2, self.cfg.log_size + 1)):
            rs = np.random.RandomState(seed)
            noise = rs.randn(1, 1, 2 ** r, 2 ** r).astype(np.float32)
            self.register_buffer(f"noise_{i}", torch.from_numpy(noise).to(self.device),
                                 persistent=False)

    def tap_names(self):
        names = ["g_mapping", "truncation"]
        for bi, bname in enumerate(self.cfg.block_names()):
            base = f"g_synthesis.blocks.{bname}"
            first = [f"{base}.conv"] if bi == 0 else [f"{base}.conv0_up"]
            epi1 = [f"{base}.epi1.top_epi.noise", f"{base}.epi1.style_mod.lin", f"{base}.epi1"]
            epi2 = [f"{base}.epi2.top_epi.noise", f"{base}.epi2.style_mod.lin", f"{base}.epi2"]
            if bi == 0:
                names += epi1 + first + epi2 + [base]
            else:
                names += first + epi1 + [f"{base}.conv1"] + epi2 + [base]
        names.append("g_synthesis.torgb")
        return tuple(names)

    def sample_latent(self, n_samples=1, seed=None, truncation=None):
        # ``truncation`` is BigGAN's; StyleGAN truncates in synthesis
        with annotate("model.sample_latent"):
            if seed is None:
                seed = self.host_rng.next_seed()
            z = torch.from_numpy(gaussian_latents(n_samples, self.cfg.w_dim, seed))
            return self._latents_from_gaussian(z.to(self.device))

    def _gaussian_latent_dim(self):
        return self.cfg.w_dim

    @torch.no_grad()
    def _latents_from_gaussian(self, z):
        if not self.w_primary:
            return z
        with ieee_f32():
            return self.g_mapping(z)

    # -- execution ----------------------------------------------------------
    def synthesize(self, styles, ts: TapState, act_dtype: Optional[str] = None):
        """One call of the reference's synthesis; returns the raw [-1, 1]
        image in float32, or None when ``ts`` stopped at a tap.
        ``act_dtype`` (``'bfloat16'`` or None): the activation storage of the
        blocks that take it (``UpBlock.preview_storage``)."""
        if self.w_primary:
            # The mapping does not run, so its tap never fires.
            ws = list(styles)
        else:
            # The 'g_mapping' tap holds the [B, 512] output before the
            # broadcast (wrappers.py:373-379).
            ws = [ts.tap("g_mapping", self.g_mapping(s)) for s in styles]
        if len(ws) == 1:
            latent = ws[0][:, None, :].expand(-1, N_BROADCAST_LATENTS, -1)
        elif len(ws) == N_BROADCAST_LATENTS:
            latent = torch.stack(ws, dim=1)
        else:
            raise ValueError(f"Must provide 1 or {N_BROADCAST_LATENTS} latents")
        if ts.stop_at == "g_mapping":
            return None
        latent = ts.tap("truncation", latent)  # identity: no truncation module
        if ts.stopped:
            return None

        x = None
        for bi, (bname, block) in enumerate(self.g_synthesis.blocks.items()):
            base = f"g_synthesis.blocks.{bname}"
            noise = getattr(self, f"noise_{bi}")
            lat0, lat1 = latent[:, 2 * bi], latent[:, 2 * bi + 1]
            if bi == 0:
                x = block(base, latent.shape[0], lat0, lat1, noise, ts)
            else:
                if act_dtype is not None and block.preview_storage:
                    x = x.to(getattr(torch, act_dtype))
                x = block(base, x, lat0, lat1, noise, self.blur_kernel, ts)
            if ts.stopped:
                return None
            x = ts.tap(base, x)
            if ts.stopped:
                return None
        torgb = self.g_synthesis.torgb
        rgb = torgb.add_bias(precision.conv2d(x, torgb.scaled_weight()))
        return ts.tap("g_synthesis.torgb", rgb.float())

    @grad_while_edit_override
    def _run(self, x, stop_at: Optional[str]):
        styles = [torch.as_tensor(s, dtype=torch.float32, device=self.device)
                  for s in (x if isinstance(x, list) else [x])]
        retain, edits, store = self._instrumentation()
        ts = TapState(retain, edits, stop_at)
        with ieee_f32():
            img = self.synthesize(styles, ts, synth_dtype_name())
        if store is not None:
            store(ts.retained)
        return img

    def forward(self, x):
        return 0.5 * (self._run(x, stop_at=None) + 1)

    def partial_forward(self, x, layer_name: str):
        self._run(x, stop_at=self.resolve_tap(layer_name))
        return None

    def pure_acts_fn(self, layer_name: str):
        """``fn(latents [n, w_dim]) -> activations [n, -1]`` at the tap:
        ``synthesize`` with a ``TapState`` that retains only the tap and
        stops there, the kernels exactly as in ``partial_forward``, in the
        activation storage the policy names when it is built."""
        tap = self.resolve_tap(layer_name)
        act_dtype = synth_dtype_name()

        @torch.no_grad()
        def fn(lat):
            ts = TapState((tap,), None, tap)
            with ieee_f32():
                self.synthesize([lat], ts, act_dtype)
            return ts.retained[tap].reshape(lat.shape[0], -1)
        return fn
