"""StyleGAN2 generator as a PyTorch module.

Counterpart of ``ganspace_tpu/models/stylegan2.py`` and, through it, of the
rosinality ``stylegan2-pytorch`` generator the reference consumes
(``models/wrappers.py:97-267``): 8 output classes at 256-1024 px, Z or W
primary latent space, per-layer style injection (W+), fixed seeded noise,
truncation toward ``latent_avg``, and early exit at the wrapper's tap
names (``style``, ``input``, ``conv1``, ``to_rgb1``, ``convs.i``,
``to_rgbs.i``).

The module tree follows the rosinality checkpoint layout, so its
``state_dict`` keys are the keys of the JAX package's flat parameter dict
(``style.1.weight``, ``convs.0.conv.weight``, ...) and
:meth:`StyleGAN2.params_from_jax` loads one without renaming.  Built
without ``params``, the model loads the rosinality ``.pt`` that
``models/checkpoints.py`` finds, as the JAX package does, and keeps seeded
random weights when there is none.  Synthesis
runs NCHW at every stage; the JAX package's space-to-depth tail
(``ops/s2d.py``) exists only for TPU lanes and is not ported.  Every
non-upsampling 3x3 StyledConv goes through kernel B's modulated mode and
every upsampling one through its stride-2 mode (``ops/modconv.py``).
Under the preview policy (``ops/precision.py``) synthesis stores its
activations in bf16 from the latent on, as the JAX package does
(``ganspace_tpu/models/stylegan2.py:270-285``), and returns a float32
image.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.models import checkpoints
from ganspace_tpu_torch.models.base import BaseGenerator, TapState, grad_while_edit_override
from ganspace_tpu_torch.models.torch_import import import_stylegan2
from ganspace_tpu_torch.ops.linear import equal_linear, fused_leaky_relu, pixel_norm
from ganspace_tpu_torch.ops.modconv import LayerWeights, modulated_conv2d
from ganspace_tpu_torch.ops.precision import StorageCopies, ieee_f32, synth_dtype_name
from ganspace_tpu_torch.ops.upfirdn import make_fir_kernel, upsample2x
from ganspace_tpu_torch.sampling import gaussian_latents

# Reference wrapper class->resolution table (wrappers.py:106-117).
CONFIGS = {
    "ffhq": 1024,
    "car": 512,
    "cat": 256,
    "church": 256,
    "horse": 256,
    "bedrooms": 256,
    "kitchen": 256,
    "places": 256,
}


# Channels per resolution at channel multiplier 2 (the published configs).
DEFAULT_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 512, 128: 256,
                    256: 128, 512: 64, 1024: 32}


@dataclass(frozen=True)
class SG2Config:
    resolution: int = 1024
    w_dim: int = 512
    n_mlp: int = 8
    channels: Tuple[Tuple[int, int], ...] = ()  # ((res, ch), ...); empty -> default
    blur_taps: Tuple[int, ...] = (1, 3, 3, 1)

    def channel_map(self) -> Dict[int, int]:
        return dict(self.channels) if self.channels else dict(DEFAULT_CHANNELS)

    @property
    def log_size(self) -> int:
        return int(math.log2(self.resolution))

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2


def init_params(cfg: SG2Config, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters, drawn exactly as ``ganspace_tpu``'s ``init_params``
    (same keys, same numpy draws in the same order: bit-identical)."""
    rs = np.random.RandomState(seed)
    ch = cfg.channel_map()
    p: Dict[str, np.ndarray] = {}

    def lin(name, fan_in, fan_out, lr_mul=1.0, bias_val=0.0):
        p[f"{name}.weight"] = rs.randn(fan_out, fan_in).astype(np.float32) / lr_mul
        p[f"{name}.bias"] = np.full((fan_out,), bias_val, dtype=np.float32)

    def modconv(name, in_ch, out_ch, k):
        p[f"{name}.weight"] = rs.randn(out_ch, in_ch, k, k).astype(np.float32)
        lin(f"{name}.modulation", cfg.w_dim, in_ch, bias_val=1.0)

    def styled_conv(name, in_ch, out_ch):
        modconv(f"{name}.conv", in_ch, out_ch, 3)
        p[f"{name}.noise.weight"] = 0.1 * rs.randn(1).astype(np.float32)
        p[f"{name}.activate.bias"] = np.zeros((out_ch,), dtype=np.float32)

    def to_rgb(name, in_ch):
        modconv(f"{name}.conv", in_ch, 3, 1)
        p[f"{name}.bias"] = np.zeros((1, 3, 1, 1), dtype=np.float32)

    for i in range(1, cfg.n_mlp + 1):
        lin(f"style.{i}", cfg.w_dim, cfg.w_dim, lr_mul=0.01)

    p["input.input"] = rs.randn(1, ch[4], 4, 4).astype(np.float32)
    styled_conv("conv1", ch[4], ch[4])
    to_rgb("to_rgb1", ch[4])

    in_ch = ch[4]
    ci = 0
    for res_log in range(3, cfg.log_size + 1):
        out_ch = ch[2 ** res_log]
        styled_conv(f"convs.{ci}", in_ch, out_ch)      # upsampling conv
        styled_conv(f"convs.{ci + 1}", out_ch, out_ch)
        to_rgb(f"to_rgbs.{res_log - 3}", out_ch)
        in_ch = out_ch
        ci += 2
    return p


def make_noise(cfg: SG2Config, seed: int = 0) -> Tuple[np.ndarray, ...]:
    """Fixed per-resolution noise buffers, the same numpy draws as
    ``ganspace_tpu``'s ``make_noise`` (reference ``wrappers.py:261-267``)."""
    rs = np.random.RandomState(seed)
    noise = [rs.randn(1, 1, 4, 4).astype(np.float32)]
    for i in range(3, cfg.log_size + 1):
        for _ in range(2):
            noise.append(rs.randn(1, 1, 2 ** i, 2 ** i).astype(np.float32))
    return tuple(noise)


# ---------------------------------------------------------------------------
# Modules (rosinality layout; weights are filled by load_state_dict)
# ---------------------------------------------------------------------------

def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class EqualLinear(nn.Module):
    """``EqualLinear``: He-scaled weight [out, in] at run time, bias * lr_mul;
    with ``activate`` the bias goes through the fused leaky ReLU instead."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 activate: bool = False):
        super().__init__()
        self.weight = _param(out_dim, in_dim)
        self.bias = _param(out_dim)
        self.lr_mul = lr_mul
        self.activate = activate
        self.copies = StorageCopies()

    def forward(self, x):
        if self.activate:
            x = equal_linear(x, self.weight, None, lr_mul=self.lr_mul, copies=self.copies)
            return fused_leaky_relu(x, self.bias * self.lr_mul, channel_dim=-1)
        return equal_linear(x, self.weight, self.bias, lr_mul=self.lr_mul, copies=self.copies)


class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class ModulatedConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int, w_dim: int):
        super().__init__()
        self.weight = _param(out_ch, in_ch, k, k)
        self.modulation = EqualLinear(w_dim, in_ch)


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = _param(1)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bias = _param(channels)


class StyledConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, w_dim: int, upsample: bool = False):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, 3, w_dim)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)
        self.upsample = upsample
        self.copies = StorageCopies()
        self.weight_cache = LayerWeights(self.conv.weight, self.copies)

    def forward(self, name: str, x, w_lat, noise, blur_k, ts: TapState):
        s = self.conv.modulation(w_lat)
        x = modulated_conv2d(x, self.conv.weight, s, demodulate=True,
                             upsample=self.upsample, blur_kernel=blur_k,
                             weight_cache=self.weight_cache)
        x = ts.tap(f"{name}.conv", x)
        if ts.stopped:
            return x
        dt = x.dtype
        x = x + self.copies(self.noise.weight, dt)[0] * self.copies(noise, dt)
        x = fused_leaky_relu(x, self.copies(self.activate.bias, dt), channel_dim=1)
        return ts.tap(name, x)


class ToRGB(nn.Module):
    def __init__(self, in_ch: int, w_dim: int):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, w_dim)
        self.bias = _param(1, 3, 1, 1)
        self.copies = StorageCopies()
        self.weight_cache = LayerWeights(self.conv.weight, self.copies)

    def forward(self, name: str, x, w_lat, skip, blur_k, ts: TapState):
        s = self.conv.modulation(w_lat)
        out = modulated_conv2d(x, self.conv.weight, s, demodulate=False,
                               weight_cache=self.weight_cache)
        out = out + self.copies(self.bias, out.dtype)
        if skip is not None:
            out = out + upsample2x(skip, blur_k)
        return ts.tap(name, out)


class ConstantInput(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.input = _param(1, channels, 4, 4)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

class StyleGAN2(BaseGenerator):
    """Drop-in equivalent of the reference ``StyleGAN2`` wrapper
    (``models/wrappers.py:97-267``) on one torch device, the card unless
    ``device`` says otherwise."""

    def __init__(self, class_name: Optional[str] = None, truncation: float = 1.0,
                 use_w: bool = False, cfg: Optional[SG2Config] = None,
                 params: Optional[Dict[str, np.ndarray]] = None,
                 latent_avg: Optional[np.ndarray] = None, init_seed: int = 0,
                 device="cuda"):
        super().__init__("StyleGAN2", class_name or "ffhq")
        device = require_device(device)
        if cfg is None:
            if self.outclass not in CONFIGS:
                raise ValueError(
                    f"Invalid StyleGAN2 class {self.outclass}, should be one of "
                    f"[{', '.join(CONFIGS)}]")
            cfg = SG2Config(resolution=CONFIGS[self.outclass])
        self.cfg = cfg
        self.resolution = cfg.resolution
        self.truncation = truncation
        self.w_primary = use_w
        self.name = f"StyleGAN2-{self.outclass}"

        ch = cfg.channel_map()
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(cfg.w_dim, cfg.w_dim, lr_mul=0.01, activate=True)
            for _ in range(cfg.n_mlp)])
        self.input = ConstantInput(ch[4])
        self.conv1 = StyledConv(ch[4], ch[4], cfg.w_dim)
        self.to_rgb1 = ToRGB(ch[4], cfg.w_dim)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[4]
        for res_log in range(3, cfg.log_size + 1):
            out_ch = ch[2 ** res_log]
            self.convs.append(StyledConv(in_ch, out_ch, cfg.w_dim, upsample=True))
            self.convs.append(StyledConv(out_ch, out_ch, cfg.w_dim))
            self.to_rgbs.append(ToRGB(out_ch, cfg.w_dim))
            in_ch = out_ch

        if params is None:
            # The reference checkpoint layout, as the JAX package reads it;
            # seeded random weights when the file is absent.
            found, rel = checkpoints.locate_stylegan2(self.outclass, self.resolution)
            if found is not None:
                params, latent_avg = import_stylegan2(found)
            else:
                checkpoints.note_random_init(self.name, rel)
                params = init_params(cfg, seed=init_seed)
        self.params_from_jax(params)
        avg = latent_avg if latent_avg is not None else np.zeros((cfg.w_dim,), np.float32)
        self.register_buffer("latent_avg", torch.as_tensor(avg, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("blur_kernel", make_fir_kernel(cfg.blur_taps),
                             persistent=False)
        self.to(device)
        self.set_noise_seed(0)
        self.copies = StorageCopies()

    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> None:
        """Load the JAX package's flat parameter dict (the rosinality key
        layout ``init_params`` and ``models/torch_import.py`` produce)."""
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
        return self.cfg.n_latent

    def set_output_class(self, new_class):
        if new_class is not None and self.outclass != new_class:
            raise RuntimeError("StyleGAN2: cannot change output class without reloading")

    def set_noise_seed(self, seed: int):
        for i, n in enumerate(make_noise(self.cfg, seed)):
            self.register_buffer(f"noise_{i}", torch.from_numpy(n).to(self.device),
                                 persistent=False)

    def tap_names(self):
        names = ["style", "input", "conv1.conv", "conv1", "to_rgb1"]
        i = 1
        for _ in range(self.cfg.log_size - 2):
            names += [f"convs.{i-1}.conv", f"convs.{i-1}",
                      f"convs.{i}.conv", f"convs.{i}", f"to_rgbs.{i//2}"]
            i += 2
        return tuple(names)

    def sample_latent(self, n_samples=1, seed=None, truncation=None):
        # ``truncation`` is BigGAN's; StyleGAN truncates in synthesis
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
            return self.style(z)

    # -- execution ----------------------------------------------------------
    def synthesize(self, styles, ts: TapState, inject_index: Optional[int],
                   act_dtype: Optional[str] = None):
        """The staged walk of ``wrappers.py:194-259`` for one call; returns
        the raw [-1, 1] image in float32, or None when ``ts`` stopped at a
        tap.  ``act_dtype`` (``'bfloat16'`` or None): the activation
        storage, from the latent on."""
        cfg = self.cfg
        n_latent = cfg.n_latent
        if self.w_primary:
            ws = list(styles)
        else:
            ws = [ts.tap("style", self.style(s)) for s in styles]
        if self.truncation < 1.0:
            ws = [self.latent_avg + self.truncation * (w - self.latent_avg) for w in ws]

        if len(ws) == 1:
            latent = ws[0][:, None, :].expand(-1, n_latent, -1)
        elif len(ws) == 2:
            idx = inject_index if inject_index is not None else n_latent // 2
            latent = torch.cat([ws[0][:, None, :].expand(-1, idx, -1),
                                ws[1][:, None, :].expand(-1, n_latent - idx, -1)], dim=1)
        else:
            if len(ws) != n_latent:
                raise ValueError(f"Expected {n_latent} latents, got {len(ws)}")
            latent = torch.stack(ws, dim=1)
        if ts.stop_at == "style":
            return None
        dt = getattr(torch, act_dtype) if act_dtype is not None else torch.float32
        latent = latent.to(dt)

        blur_k = self.blur_kernel
        batch = latent.shape[0]
        const = self.copies(self.input.input, dt)
        out = ts.tap("input", const.expand(batch, -1, -1, -1))
        if ts.stopped:
            return None
        out = self.conv1("conv1", out, latent[:, 0], self.noise_0, blur_k, ts)
        if ts.stopped:
            return None
        skip = self.to_rgb1("to_rgb1", out, latent[:, 1], None, blur_k, ts)
        if ts.stopped:
            return None

        i = 1
        for pair in range(cfg.log_size - 2):
            for j in range(2):
                out = self.convs[i - 1 + j](
                    f"convs.{i - 1 + j}", out, latent[:, i + j],
                    getattr(self, f"noise_{i + j}"), blur_k, ts)
                if ts.stopped:
                    return None
            skip = self.to_rgbs[pair](f"to_rgbs.{pair}", out, latent[:, i + 2],
                                      skip, blur_k, ts)
            if ts.stopped:
                return None
            i += 2
        return skip.float()

    @grad_while_edit_override
    def _run(self, x, stop_at: Optional[str]):
        styles = [torch.as_tensor(s, dtype=torch.float32, device=self.device)
                  for s in (x if isinstance(x, list) else [x])]
        inject_index = None
        if len(styles) == 2:
            # The reference picks a random mix point per call (wrappers.py:207-214).
            inject_index = self.host_rng.randint(1, self.cfg.n_latent)
        retain, edits, store = self._instrumentation()
        ts = TapState(retain, edits, stop_at)
        with ieee_f32():
            img = self.synthesize(styles, ts, inject_index, synth_dtype_name())
        if store is not None:
            store(ts.retained)
        return img

    def forward(self, x):
        img = self._run(x, stop_at=None)
        return 0.5 * (img + 1)

    def partial_forward(self, x, layer_name: str):
        self._run(x, stop_at=self.resolve_tap(layer_name))
        return None

    def pure_acts_fn(self, layer_name: str):
        """``fn(latents [n, w_dim]) -> activations [n, -1]`` at the tap:
        ``synthesize`` with a ``TapState`` that retains only the tap and
        stops there (kernel B exactly as in ``partial_forward``), in the
        activation storage the policy names when it is built (its
        activations then in that dtype)."""
        tap = self.resolve_tap(layer_name)
        act_dtype = synth_dtype_name()

        @torch.no_grad()
        def fn(lat):
            ts = TapState((tap,), None, tap)
            with ieee_f32():
                self.synthesize([lat], ts, None, act_dtype)
            return ts.retained[tap].reshape(lat.shape[0], -1)
        return fn
