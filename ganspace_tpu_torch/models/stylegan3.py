"""StyleGAN3-T generator as a PyTorch module.

The alias-free generator of Karras et al., "Alias-Free Generative
Adversarial Networks" (NeurIPS 2021; ``training/networks_stylegan3.py`` of
github.com/NVlabs/stylegan3, configuration ``stylegan3-t``):

* **mapping**: z normalized, then 2 equalized-lr linear layers (lr 0.01,
  leaky ReLU 0.2 times sqrt 2: StyleGAN2's ``EqualLinear``), broadcast to
  16 W latents; truncation toward ``mapping.w_avg``;
* **input**: 512 Fourier features at learned frequencies, rotated and
  translated per sample by an affine of w, sampled on a 36 x 36 grid (a
  10-pixel margin around 16 px) and mixed by a 512 x 512 weight;
* **14 layers and ToRGB**, whose cutoffs, stopbands, sampling rates, sizes
  (36 to 1044 px) and channels (512 to 32) follow from
  :func:`layer_schedule`: each a modulated 3x3 conv with the output
  ``in_size + 2`` (kernel B's modulated mode on the input padded by one
  pixel, ``ops/modconv.py``), the layer's input gain ``rsqrt(magnitude_ema)``
  folded into the style scale, then the filtered leaky ReLU
  (``ops/filtered_lrelu.py``: bias, x2 or x4 upsampling through a Kaiser
  low-pass, leaky ReLU with gain sqrt 2 clamped at 256, low-pass and x2
  downsampling); ToRGB a 1x1 conv with no demodulation; the image is its
  output times 0.25.  There are no noise inputs.

The parameter keys are the official ``state_dict``'s (``mapping.fc0.weight``,
``synthesis.L5_148_512.affine.weight``, ...); the Kaiser filters and the
input's sampling grid are derived from the configuration once per model,
on its device.  Taps: ``style`` (W), ``input`` and the layer names
(``L0_36_512`` ... ``L14_1024_3``).  No importer of the official pickle
exists yet, so a model built without ``params`` takes the official
initialization from ``init_params``.  Synthesis stores float32 activations
under every policy; the ``default`` matmul precision still selects kernel
B's and the stock convolutions' bf16-operand datapath.
"""

from __future__ import annotations

import functools
import math
import sys
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.models.base import BaseGenerator, TapState, grad_while_edit_override
from ganspace_tpu_torch.models.stylegan2 import EqualLinear, PixelNorm
from ganspace_tpu_torch.ops import filtered_lrelu as flrelu
from ganspace_tpu_torch.ops import modconv
from ganspace_tpu_torch.ops.precision import (
    StorageCopies, bf16_operands, conv2d, ieee_f32, round_bf16)
from ganspace_tpu_torch.sampling import gaussian_latents
from ganspace_tpu_torch.utils.tracing import annotate

#: output class -> resolution of the published ``stylegan3-t`` networks this port names
CONFIGS = {"ffhq": 1024}


@dataclass(frozen=True)
class SG3Config:
    """The published ``stylegan3-t`` configuration; the layer schedule is
    computed from it (:func:`layer_schedule`)."""
    resolution: int = 1024
    z_dim: int = 512
    w_dim: int = 512
    mapping_layers: int = 2
    lr_mul: float = 0.01
    num_layers: int = 14
    num_critical: int = 2
    first_cutoff: float = 2.0
    first_stopband: float = 2 ** 2.1
    last_stopband_rel: float = 2 ** 0.3
    margin: int = 10
    channel_base: int = 32768
    channel_max: int = 512
    conv_kernel: int = 3
    filter_size: int = 6
    lrelu_upsampling: int = 2
    conv_clamp: float = 256.0
    output_scale: float = 0.25
    img_channels: int = 3

    @property
    def n_latent(self) -> int:
        return self.num_layers + 2


class Layer(NamedTuple):
    """One layer of :func:`layer_schedule` (the input layer first)."""
    name: str
    cin: int
    cout: int
    in_size: int
    out_size: int
    in_rate: int
    out_rate: int
    tmp_rate: int              # the rate between the two filters
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float
    up: int
    down: int
    up_taps: int
    down_taps: int
    pad: Tuple[int, int]
    kernel: int
    torgb: bool


@functools.lru_cache(maxsize=None)
def layer_schedule(cfg: SG3Config) -> Tuple[Layer, ...]:
    """The input layer (first) and the ``num_layers + 1`` synthesis layers,
    from the published formulas (``SynthesisNetwork.__init__`` and
    ``SynthesisLayer.__init__``)."""
    n = cfg.num_layers
    last_cutoff = cfg.resolution / 2
    last_stopband = last_cutoff * cfg.last_stopband_rel
    e = np.minimum(np.arange(n + 1) / (n - cfg.num_critical), 1)
    cutoffs = cfg.first_cutoff * (last_cutoff / cfg.first_cutoff) ** e
    stopbands = cfg.first_stopband * (last_stopband / cfg.first_stopband) ** e
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, cfg.resolution))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + cfg.margin * 2
    sizes[-2:] = cfg.resolution
    channels = np.rint(np.minimum((cfg.channel_base / 2) / cutoffs, cfg.channel_max))
    channels[-1] = cfg.img_channels
    out = [Layer("input", int(channels[0]), int(channels[0]), int(sizes[0]), int(sizes[0]),
                 int(rates[0]), int(rates[0]), int(rates[0]), float(cutoffs[0]), float(cutoffs[0]),
                 float(half_widths[0]), float(half_widths[0]), 1, 1, 1, 1, (0, 0), 0, False)]
    for i in range(n + 1):
        p = max(i - 1, 0)
        torgb = i == n
        tmp = max(rates[p], rates[i]) * (1 if torgb else cfg.lrelu_upsampling)
        up, down = int(np.rint(tmp / rates[p])), int(np.rint(tmp / rates[i]))
        up_taps = cfg.filter_size * up if up > 1 and not torgb else 1
        down_taps = cfg.filter_size * down if down > 1 and not torgb else 1
        k = 1 if torgb else cfg.conv_kernel
        total = (int(sizes[i]) - 1) * down + 1 - (int(sizes[p]) + k - 1) * up
        total += up_taps + down_taps - 2
        lo = (total + up) // 2
        out.append(Layer(f"L{i}_{int(sizes[i])}_{int(channels[i])}", int(channels[p]),
                         int(channels[i]), int(sizes[p]), int(sizes[i]), int(rates[p]),
                         int(rates[i]), int(tmp), float(cutoffs[p]), float(cutoffs[i]),
                         float(half_widths[p]), float(half_widths[i]), up, down, up_taps,
                         down_taps, (lo, total - lo), k, torgb))
    return tuple(out)


def kaiser_lowpass(numtaps: int, cutoff: float, width: float, fs: float) -> Optional[np.ndarray]:
    """``scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)`` in numpy
    (a Kaiser-windowed sinc low-pass summing to 1), float64; None for one
    tap (the identity)."""
    if numtaps == 1:
        return None
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    c = cutoff / nyq
    m = np.arange(numtaps) - (numtaps - 1) / 2
    h = c * np.sinc(c * m) * np.kaiser(numtaps, beta)
    return h / h.sum()


def init_params(cfg: SG3Config, seed: int = 0) -> Dict[str, np.ndarray]:
    """The official initialization, drawn by ``RandomState(seed)``: linear
    and conv weights standard normal (the mapping's over ``lr_mul``),
    biases 0 (the style affines' 1, the input affine's [1, 0, 0, 0] with a
    zero weight), frequencies uniform on the disc of the input's bandwidth,
    phases uniform in [-0.5, 0.5), ``magnitude_ema`` 1."""
    rs = np.random.RandomState(seed)
    layers = layer_schedule(cfg)
    f32 = np.float32
    p: Dict[str, np.ndarray] = {}
    for i in range(cfg.mapping_layers):
        p[f"mapping.fc{i}.weight"] = (rs.randn(cfg.w_dim, cfg.z_dim if i == 0 else cfg.w_dim)
                                      / cfg.lr_mul).astype(f32)
        p[f"mapping.fc{i}.bias"] = np.zeros(cfg.w_dim, f32)
    p["mapping.w_avg"] = np.zeros(cfg.w_dim, f32)
    inp = layers[0]
    freqs = rs.randn(inp.cout, 2)
    radii = np.sqrt(np.sum(freqs ** 2, axis=1, keepdims=True))
    freqs = freqs / (radii * np.exp(radii ** 2) ** 0.25) * inp.out_cutoff
    p["synthesis.input.freqs"] = freqs.astype(f32)
    p["synthesis.input.phases"] = (rs.rand(inp.cout) - 0.5).astype(f32)
    p["synthesis.input.weight"] = rs.randn(inp.cout, inp.cout).astype(f32)
    p["synthesis.input.affine.weight"] = np.zeros((4, cfg.w_dim), f32)
    p["synthesis.input.affine.bias"] = np.array([1, 0, 0, 0], f32)
    p["synthesis.input.transform"] = np.eye(3, dtype=f32)
    for lay in layers[1:]:
        pre = f"synthesis.{lay.name}"
        p[f"{pre}.affine.weight"] = rs.randn(lay.cin, cfg.w_dim).astype(f32)
        p[f"{pre}.affine.bias"] = np.ones(lay.cin, f32)
        p[f"{pre}.weight"] = rs.randn(lay.cout, lay.cin, lay.kernel, lay.kernel).astype(f32)
        p[f"{pre}.bias"] = np.zeros(lay.cout, f32)
        p[f"{pre}.magnitude_ema"] = np.ones((), f32)
    return p


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class MappingNetwork(nn.Module):
    def __init__(self, cfg: SG3Config):
        super().__init__()
        self.norm = PixelNorm()
        for i in range(cfg.mapping_layers):
            setattr(self, f"fc{i}", EqualLinear(cfg.z_dim if i == 0 else cfg.w_dim, cfg.w_dim,
                                                lr_mul=cfg.lr_mul, activate=True))
        self.n = cfg.mapping_layers
        self.register_buffer("w_avg", torch.zeros(cfg.w_dim))

    def forward(self, z):
        x = self.norm(z)
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
        return x


class SynthesisInput(nn.Module):
    """The Fourier features; the sampling grid is made once."""

    def __init__(self, spec: Layer, w_dim: int):
        super().__init__()
        c, size = spec.cout, spec.out_size
        self.spec = spec
        self.weight = _param(c, c)
        self.affine = EqualLinear(w_dim, 4)
        self.register_buffer("transform", torch.eye(3))
        self.register_buffer("freqs", torch.zeros(c, 2))
        self.register_buffer("phases", torch.zeros(c))
        theta = torch.eye(2, 3)
        theta[0, 0] = theta[1, 1] = 0.5 * size / spec.out_rate
        grid = F.affine_grid(theta[None], [1, 1, size, size], align_corners=False)[0]
        self.register_buffer("grid", grid, persistent=False)       # [H, W, 2]
        self.copies = StorageCopies()

    def forward(self, w):
        spec = self.spec
        t = self.affine(w)                                          # (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        b = w.shape[0]
        m_r = torch.eye(3, device=w.device).repeat(b, 1, 1)
        m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
        m_t = torch.eye(3, device=w.device).repeat(b, 1, 1)
        m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        transforms = m_r @ m_t @ self.transform[None]
        freqs = self.freqs[None]
        phases = self.phases[None] + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]                       # [B, C, 2]
        amp = (1 - (freqs.norm(dim=2) - spec.out_cutoff)
               / (spec.out_rate / 2 - spec.out_cutoff)).clamp(0, 1)
        x = torch.einsum("hwk,bck->bhwc", self.grid, freqs) + phases[:, None, None]
        x = torch.sin(x * (2 * math.pi)) * amp[:, None, None]
        weight = self.copies(self.weight, None, "scaled",
                             lambda v: v / math.sqrt(spec.cout))
        return (x @ weight.T).permute(0, 3, 1, 2).contiguous()


class SynthesisLayer(nn.Module):
    """A modulated conv and the filtered leaky ReLU; the filters are made once."""

    def __init__(self, spec: Layer, w_dim: int, clamp: float):
        super().__init__()
        self.spec = spec
        self.clamp = clamp
        self.affine = EqualLinear(w_dim, spec.cin)
        self.weight = _param(spec.cout, spec.cin, spec.kernel, spec.kernel)
        self.bias = _param(spec.cout)
        self.register_buffer("magnitude_ema", torch.ones(()))
        for name, taps, cutoff, half in (("up_filter", spec.up_taps, spec.in_cutoff,
                                          spec.in_half_width),
                                         ("down_filter", spec.down_taps, spec.out_cutoff,
                                          spec.out_half_width)):
            f = kaiser_lowpass(taps, cutoff, 2 * half, spec.tmp_rate)
            self.register_buffer(name, None if f is None else torch.tensor(f, dtype=torch.float32),
                                 persistent=False)
        self.copies = StorageCopies()

    def forward(self, x, w):
        spec = self.spec
        s = self.affine(w)                                          # [B, C]
        gain = torch.rsqrt(self.magnitude_ema)
        if spec.torgb:
            s = s * (gain / math.sqrt(spec.cin * spec.kernel ** 2))
            y = conv2d(x * s[:, :, None, None], self.weight)
            act_gain, slope = 1.0, 1.0
        else:
            wt = self.copies(self.weight, None, "prenorm",
                             lambda v: v * v.square().mean([1, 2, 3], keepdim=True).rsqrt())
            s = s * s.square().mean().rsqrt()
            d = modconv.demodulation(round_bf16(wt) if bf16_operands(x) else wt, s)
            y = modconv.modconv3x3(F.pad(x, [1, 1, 1, 1]), wt, s * gain, d)
            act_gain, slope = math.sqrt(2.0), 0.2
        return flrelu.filtered_lrelu(y, self.up_filter, self.down_filter, self.bias, spec.up,
                                     spec.down, spec.pad, act_gain, slope, self.clamp)


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: SG3Config):
        super().__init__()
        layers = layer_schedule(cfg)
        self.input = SynthesisInput(layers[0], cfg.w_dim)
        self.layer_names = tuple(spec.name for spec in layers[1:])
        for spec in layers[1:]:
            setattr(self, spec.name, SynthesisLayer(spec, cfg.w_dim, cfg.conv_clamp))


class StyleGAN3(BaseGenerator):
    """StyleGAN3-T with the interface of :class:`~ganspace_tpu_torch.models.
    stylegan2.StyleGAN2` (Z or W primary latent space, W+ per layer, early
    exit at a tap), on one torch device, the card unless ``device`` says
    otherwise."""

    def __init__(self, class_name: Optional[str] = None, truncation: float = 1.0,
                 use_w: bool = False, cfg: Optional[SG3Config] = None,
                 params: Optional[Dict[str, np.ndarray]] = None, init_seed: int = 0,
                 device="cuda"):
        super().__init__("StyleGAN3", class_name or "ffhq")
        device = require_device(device)
        if cfg is None:
            if self.outclass not in CONFIGS:
                raise ValueError(f"Invalid StyleGAN3 class {self.outclass}, should be one of "
                                 f"[{', '.join(CONFIGS)}]")
            cfg = SG3Config(resolution=CONFIGS[self.outclass])
        self.cfg = cfg
        self.resolution = cfg.resolution
        self.truncation = truncation
        self.w_primary = use_w
        self.name = f"StyleGAN3-{self.outclass}"
        self.mapping = MappingNetwork(cfg)
        self.synthesis = SynthesisNetwork(cfg)
        if params is None:
            # stderr: a diagnostic, not program output
            print(f"[{self.name}] no checkpoint importer for this family; using the "
                  f"seeded official initialization", file=sys.stderr)
            params = init_params(cfg, seed=init_seed)
        self.load_params(params)
        self.to(device)

    def load_params(self, flat: Dict[str, np.ndarray]) -> None:
        """Load a flat dict by the official ``state_dict`` keys (:func:`init_params`'s)."""
        self.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
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
            raise RuntimeError("StyleGAN3: cannot change output class without reloading")

    def tap_names(self):
        return ("style", "input") + self.synthesis.layer_names

    def sample_latent(self, n_samples=1, seed=None, truncation=None):
        with annotate("model.sample_latent"):
            if seed is None:
                seed = self.host_rng.next_seed()
            z = torch.from_numpy(gaussian_latents(n_samples, self.cfg.z_dim, seed))
            return self._latents_from_gaussian(z.to(self.device))

    def _gaussian_latent_dim(self):
        return self.cfg.z_dim

    @torch.no_grad()
    def _latents_from_gaussian(self, z):
        if not self.w_primary:
            return z
        with ieee_f32():
            return self.mapping(z)

    # -- execution ----------------------------------------------------------
    def synthesize(self, styles, ts: TapState, inject_index: Optional[int]):
        """Z or W latents (one, two for style mixing, or ``n_latent``) to
        the raw image, float32 NCHW (about [-1, 1]), or None when ``ts``
        stopped at a tap.  The mapping runs in ``synth.mapping``, the input
        layer in ``synth.input``, each layer in ``synth.<name>``."""
        n_latent = self.cfg.n_latent
        if self.w_primary:
            ws = list(styles)
        else:
            with annotate("synth.mapping"):
                ws = [ts.tap("style", self.mapping(s)) for s in styles]
        if self.truncation < 1.0:
            avg = self.mapping.w_avg
            ws = [avg + self.truncation * (w - avg) for w in ws]
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
        syn = self.synthesis
        with annotate("synth.input"):
            x = ts.tap("input", syn.input(latent[:, 0]))
        if ts.stopped:
            return None
        for i, name in enumerate(syn.layer_names):
            with annotate("synth." + name):
                x = ts.tap(name, getattr(syn, name)(x, latent[:, i + 1]))
            if ts.stopped:
                return None
        return x * self.cfg.output_scale

    @grad_while_edit_override
    def _run(self, x, stop_at: Optional[str]):
        styles = [torch.as_tensor(s, dtype=torch.float32, device=self.device)
                  for s in (x if isinstance(x, list) else [x])]
        inject_index = None
        if len(styles) == 2:
            inject_index = self.host_rng.randint(1, self.cfg.n_latent)
        retain, edits, store = self._instrumentation()
        ts = TapState(retain, edits, stop_at)
        with ieee_f32():
            img = self.synthesize(styles, ts, inject_index)
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
        """``fn(latents [n, z_dim or w_dim]) -> activations [n, -1]`` at the
        tap, with no instrumentation and no edits."""
        tap = self.resolve_tap(layer_name)

        @torch.no_grad()
        def fn(lat):
            ts = TapState((tap,), None, tap)
            with ieee_f32():
                self.synthesize([lat], ts, None)
            return ts.retained[tap].reshape(lat.shape[0], -1)
        return fn
