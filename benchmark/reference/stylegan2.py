"""Plain StyleGAN2 generator (NVlabs config-f, in the parameter layout of
rosinality's ``stylegan2-pytorch``), float32, on any device.

    mapping:   z -> pixel norm -> n_mlp x (equalized linear, lr_mul, leaky ReLU 0.2 x sqrt 2)
    styled conv: s = A(w); y = d * conv(x * s, W / sqrt(fan_in)),
                 d[o] = rsqrt(sum_i s_i^2 sum_kk (W[o, i] / sqrt(fan_in))^2 + 1e-8);
                 the upsampling ones a stride-2 transposed conv, then the
                 [1, 3, 3, 1] blur with gain 4, padding (1, 1);
                 + noise_weight * noise, bias, leaky ReLU 0.2 x sqrt 2
    to_rgb:    the 1x1 modulated conv without demodulation, + bias, + the
               skip upsampled by zero insertion and the blur (gain 4, padding (2, 1))

The per-sample modulation is applied to the activations instead of the
weights (StyleGAN2's non-fused form), which is the same function.  Noise
is the fixed per-resolution buffers drawn by ``RandomState(0)`` in the
order of the rosinality wrapper (4 px, then two maps per resolution).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def lrelu(x: torch.Tensor, bias: torch.Tensor, dim: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[dim] = -1
    return F.leaky_relu(x + bias.reshape(shape), 0.2) * SQRT2


def fir_kernel(taps) -> torch.Tensor:
    k = np.outer(taps, taps).astype(np.float64)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def upfirdn(x: torch.Tensor, k: torch.Tensor, up: int, pad: tuple, gain: float) -> torch.Tensor:
    """Zero-insertion upsampling by ``up``, zero padding, then the FIR filter
    (a true convolution; the kernel is symmetric) times ``gain``."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    kk = torch.flip(k * gain, (0, 1)).to(x)
    return F.conv2d(x, kk[None, None].expand(c, 1, *kk.shape), groups=c)


def make_noise(log_size: int) -> List[np.ndarray]:
    rs = np.random.RandomState(0)
    noise = [rs.randn(1, 1, 4, 4).astype(np.float32)]
    for i in range(3, log_size + 1):
        for _ in range(2):
            noise.append(rs.randn(1, 1, 2 ** i, 2 ** i).astype(np.float32))
    return noise


class StyleGAN2:
    """``p``: the parameters by rosinality key on one device; ``cfg``: the
    configuration file's sizes (``resolution``, ``w_dim``, ``n_mlp``,
    ``lr_mul``, ``channels``, ``blur_taps``)."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: dict):
        self.p = p
        self.cfg = cfg
        self.device = next(iter(p.values())).device
        self.log_size = int(math.log2(cfg["resolution"]))
        self.n_latent = 2 * self.log_size - 2
        self.ch = {int(k): v for k, v in cfg["channels"].items()}
        self.noise = [torch.from_numpy(n).to(self.device) for n in make_noise(self.log_size)]
        self.blur = fir_kernel(cfg["blur_taps"]).to(self.device)

    def _lin(self, name: str, x: torch.Tensor, lr_mul: float = 1.0) -> torch.Tensor:
        w = self.p[f"{name}.weight"]
        return x @ (w * (lr_mul / math.sqrt(w.shape[1]))).T + self.p[f"{name}.bias"] * lr_mul

    def mapping(self, z: torch.Tensor) -> torch.Tensor:
        x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
        lr = self.cfg["lr_mul"]
        for i in range(1, self.cfg["n_mlp"] + 1):
            w = self.p[f"style.{i}.weight"]
            x = lrelu(x @ (w * (lr / math.sqrt(w.shape[1]))).T, self.p[f"style.{i}.bias"] * lr, -1)
        return x

    def _modconv(self, name: str, x, w_lat, demod: bool, up: bool = False):
        s = self._lin(f"{name}.modulation", w_lat)
        wt = self.p[f"{name}.weight"]
        co, ci, kh, kw = wt.shape
        wt = wt / math.sqrt(ci * kh * kw)
        xs = x * s[:, :, None, None]
        if up:
            y = F.conv_transpose2d(xs, wt.transpose(0, 1), stride=2)
        else:
            y = F.conv2d(xs, wt, padding=kh // 2)
        if demod:
            d = torch.rsqrt((s * s) @ torch.sum(wt * wt, dim=(2, 3)).T + 1e-8)
            y = y * d[:, :, None, None]
        if up:
            y = upfirdn(y, self.blur, 1, (1, 1), 4.0)
        return y

    def _styled(self, name: str, x, w_lat, noise, up: bool = False):
        y = self._modconv(f"{name}.conv", x, w_lat, True, up)
        y = y + self.p[f"{name}.noise.weight"][0] * noise
        return lrelu(y, self.p[f"{name}.activate.bias"], 1)

    def _to_rgb(self, name: str, x, w_lat, skip):
        y = self._modconv(f"{name}.conv", x, w_lat, False) + self.p[f"{name}.bias"]
        if skip is not None:
            y = y + upfirdn(skip, self.blur, 2, (2, 1), 4.0)
        return y

    def synthesis(self, ws: torch.Tensor, stop_at: Optional[str] = None):
        """``ws`` [B, n_latent, w_dim] -> the image in [-1, 1] [B, 3, H, W];
        with ``stop_at`` (``conv1`` or ``convs.<k>``) the activations of that
        styled conv, flattened [B, C * H * W]."""
        b = ws.shape[0]
        x = self.p["input.input"].expand(b, -1, -1, -1)
        x = self._styled("conv1", x, ws[:, 0], self.noise[0])
        if stop_at == "conv1":
            return x.reshape(b, -1)
        skip = self._to_rgb("to_rgb1", x, ws[:, 1], None)
        i = 1
        for pair in range(self.log_size - 2):
            for j in range(2):
                k = i - 1 + j
                x = self._styled(f"convs.{k}", x, ws[:, i + j], self.noise[i + j], up=(j == 0))
                if stop_at == f"convs.{k}":
                    return x.reshape(b, -1)
            skip = self._to_rgb(f"to_rgbs.{pair}", x, ws[:, i + 2], skip)
            i += 2
        return skip

    def tap(self, z: torch.Tensor, layer: str) -> torch.Tensor:
        """Activations at ``layer`` of Z latents [B, w_dim]."""
        w = self.mapping(z)
        return self.synthesis(w[:, None, :].expand(-1, self.n_latent, -1), stop_at=layer)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> [0, 1] -> uint8 NHWC by clip, x 255, + 0.5, truncate."""
    x = torch.clamp((0.5 * (img + 1.0)).permute(0, 2, 3, 1), 0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8)


def centered_strip_ws(w: torch.Tensor, direction: torch.Tensor, stdev: float,
                      mean: torch.Tensor, sigma: float, frames: int, n_latent: int,
                      start: int, end: int) -> torch.Tensor:
    """The per-layer W latents of a centered latent edit strip
    (GANSpace ``notebook_utils.py``): the sample moved onto the mean along the
    unit direction, then ``linspace(-sigma, sigma, frames) * stdev`` along it
    in the layers [start, end); the other layers keep the sample.
    ``w`` [1, w_dim] -> [frames, n_latent, w_dim]."""
    unit = direction / torch.sqrt(torch.sum(direction * direction) + 1e-8)
    zero = torch.sum((w - mean) * unit) * unit
    sig = torch.from_numpy(np.linspace(-sigma, sigma, frames, dtype=np.float32))
    edited = w - zero + sig.to(w.device)[:, None] * stdev * direction[None]
    ws = w.expand(frames, -1)[:, None, :].repeat(1, n_latent, 1)
    ws[:, start:end] = edited[:, None, :]
    return ws
