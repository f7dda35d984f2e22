"""Plain StyleGAN3-T generator (NVlabs ``training/networks_stylegan3.py``,
configuration ``stylegan3-t``), float32, on any device.

    mapping:   z -> z rsqrt(mean(z^2) + 1e-8) -> 2 x (equalized linear, lr 0.01,
               leaky ReLU 0.2 x sqrt 2), broadcast to num_layers + 2 latents
    input:     t = A(w) / |t[:2]|; T = R(t) T(-t) transform; phases += f T[:2, 2],
               f <- f T[:2, :2]; x = sin(2 pi (grid f + phase)) amplitude (the
               out-of-band frequencies damped), mixed by weight / sqrt(C)
    layer:     s = A(w) (ToRGB: / sqrt(C)); W' = W rsqrt(mean W^2) per output
               channel, s' = s rsqrt(mean s^2) over the whole styles tensor,
               d = rsqrt(sum (W' s')^2 + 1e-8); y = d conv(x s' g, W', padding 2)
               with g = rsqrt(magnitude_ema) (ToRGB: conv(x s g, W), no d);
               then the filtered leaky ReLU: + bias, zero insertion x up,
               padding, the up filter with gain up^2, leaky ReLU x gain
               clamped to +-256, the down filter, every down-th sample
    image:     the last layer's output x 0.25

Each layer's cutoff, stopband, sampling rate, size and channels follow
from the published formulas, and each filter is a Kaiser-windowed sinc
designed here (``scipy.signal.firwin``'s formula), applied as its 2-D
outer product in one depthwise ``conv2d``.  The per-sample modulation is
applied to the activations instead of the weights, which is the same
function.  The filters run one sample at a time, so that the largest map
(81 channels at 2121 px before the up filter) fits beside the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def schedule(cfg: dict) -> List[dict]:
    """The input layer and the synthesis layers: sizes, rates, channels,
    factors, taps, padding, as ``SynthesisNetwork`` and ``SynthesisLayer``
    compute them."""
    n, res = cfg["num_layers"], cfg["resolution"]
    e = np.minimum(np.arange(n + 1) / (n - cfg["num_critical"]), 1)
    cutoffs = cfg["first_cutoff"] * (res / 2 / cfg["first_cutoff"]) ** e
    stop0 = cfg["first_stopband"]
    stopbands = stop0 * (res / 2 * cfg["last_stopband_rel"] / stop0) ** e
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    halves = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + 2 * cfg["margin"]
    sizes[-2:] = res
    ch = np.rint(np.minimum(cfg["channel_base"] / 2 / cutoffs, cfg["channel_max"]))
    ch[-1] = 3
    layers = []
    for i in range(n + 1):
        p, rgb = max(i - 1, 0), i == n
        tmp = max(rates[p], rates[i]) * (1 if rgb else cfg["lrelu_upsampling"])
        up, down = round(tmp / rates[p]), round(tmp / rates[i])
        fs = cfg["filter_size"]
        ut = fs * up if up > 1 and not rgb else 1
        dt = fs * down if down > 1 and not rgb else 1
        k = 1 if rgb else cfg["conv_kernel"]
        total = (int(sizes[i]) - 1) * down + 1 - (int(sizes[p]) + k - 1) * up + ut + dt - 2
        lo = (total + up) // 2
        layers.append({
            "name": f"L{i}_{int(sizes[i])}_{int(ch[i])}", "rgb": rgb, "k": k,
            "cin": int(ch[p]), "cout": int(ch[i]), "up": up, "down": down, "pad": (lo, total - lo),
            "fu": firwin(ut, cutoffs[p], 2 * halves[p], tmp),
            "fd": firwin(dt, cutoffs[i], 2 * halves[i], tmp)})
    first = {"channels": int(ch[0]), "size": int(sizes[0]), "rate": float(rates[0]),
             "bandwidth": float(cutoffs[0])}
    return [first] + layers


def firwin(numtaps: int, cutoff: float, width: float, fs: float) -> Optional[np.ndarray]:
    """A Kaiser-windowed low-pass of ``numtaps`` taps, normalized to sum 1
    (``scipy.signal.firwin`` with ``width`` and ``fs``); None for one tap."""
    if numtaps == 1:
        return None
    nyq = fs / 2.0
    a = 2.285 * (numtaps - 1) * math.pi * (width / nyq) + 7.95
    beta = (0.1102 * (a - 8.7) if a > 50 else
            0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21) if a > 21 else 0.0)
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    h = (cutoff / nyq) * np.sinc((cutoff / nyq) * m) * np.kaiser(numtaps, beta)
    return h / np.sum(h)


def filter2d(x: torch.Tensor, f: Optional[np.ndarray], up: int, down: int, pad: tuple,
             gain: float) -> torch.Tensor:
    """Zero insertion by ``up``, padding (negative crops), the filter's 2-D
    outer product times ``gain`` as one true convolution, every ``down``-th
    sample."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    if f is None:
        return x
    k = torch.from_numpy(np.outer(f, f).astype(np.float32)).to(x) * gain
    k = torch.flip(k, (0, 1))[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, k, stride=down, groups=c)


def filtered_lrelu(x, fu, fd, b, up, down, pad, gain, slope, clamp):
    """Bias, up-filter, leaky ReLU x gain, clamp, down-filter; one sample at a time."""
    out = []
    for xs in x.split(1):
        y = filter2d(xs + b[None, :, None, None], fu, up, 1, pad, float(up * up))
        y = torch.clamp(F.leaky_relu(y, slope) * gain, -clamp, clamp)
        out.append(filter2d(y, fd, 1, down, (0, 0), 1.0))
    return torch.cat(out)


class StyleGAN3:
    """``p``: the parameters by their official keys on one device; ``cfg``:
    the configuration file's numbers."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: dict):
        self.p = p
        self.cfg = cfg
        self.device = next(iter(p.values())).device
        self.first, *self.layers = schedule(cfg)
        self.n_latent = cfg["num_layers"] + 2

    def _fc(self, name: str, x, lr: float = 1.0):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        return x @ (w * (lr / math.sqrt(w.shape[1]))).T + b * lr

    def mapping(self, z: torch.Tensor) -> torch.Tensor:
        x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
        for i in range(self.cfg["mapping_layers"]):
            x = F.leaky_relu(self._fc(f"mapping.fc{i}", x, self.cfg["lr_mul"]), 0.2) * math.sqrt(2)
        return x

    def input_layer(self, w):
        """The Fourier features of W latents [B, w_dim]: [B, C, size, size]."""
        f0, p = self.first, self.p
        t = self._fc("synthesis.input.affine", w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        b = w.shape[0]
        m_r = torch.eye(3, device=w.device).repeat(b, 1, 1)
        m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
        m_t = torch.eye(3, device=w.device).repeat(b, 1, 1)
        m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        tr = m_r @ m_t @ p["synthesis.input.transform"][None]
        freqs = p["synthesis.input.freqs"][None]
        phases = p["synthesis.input.phases"][None] + (freqs @ tr[:, :2, 2:]).squeeze(2)
        freqs = freqs @ tr[:, :2, :2]
        bw, sr = f0["bandwidth"], f0["rate"]
        amp = (1 - (freqs.norm(dim=2) - bw) / (sr / 2 - bw)).clamp(0, 1)
        theta = torch.eye(2, 3, device=w.device)
        theta[0, 0] = theta[1, 1] = 0.5 * f0["size"] / sr
        grid = F.affine_grid(theta[None], [1, 1, f0["size"], f0["size"]], align_corners=False)
        x = (grid.unsqueeze(3) @ freqs.permute(0, 2, 1)[:, None, None]).squeeze(3)
        x = torch.sin((x + phases[:, None, None]) * (2 * math.pi)) * amp[:, None, None]
        wt = p["synthesis.input.weight"] / math.sqrt(f0["channels"])
        return (x @ wt.T).permute(0, 3, 1, 2)

    def layer(self, lay: dict, x, w):
        """Layer ``lay`` (an entry of ``layers``) on its input ``x``, W latents ``w``."""
        pre = "synthesis." + lay["name"]
        s = self._fc(f"{pre}.affine", w)
        wt = self.p[f"{pre}.weight"]
        g = torch.rsqrt(self.p[f"{pre}.magnitude_ema"])
        if lay["rgb"]:
            y = F.conv2d(x * (s * g / math.sqrt(lay["cin"]))[:, :, None, None], wt)
        else:
            wt = wt * torch.rsqrt(torch.mean(wt * wt, dim=(1, 2, 3), keepdim=True))
            s = s * torch.rsqrt(torch.mean(s * s))
            d = torch.rsqrt((s * s) @ torch.sum(wt * wt, dim=(2, 3)).T + 1e-8)
            y = F.conv2d(x * (s * g)[:, :, None, None], wt, padding=lay["k"] - 1)
            y = y * d[:, :, None, None]
        gain, slope = (1.0, 1.0) if lay["rgb"] else (math.sqrt(2), 0.2)
        return filtered_lrelu(y, lay["fu"], lay["fd"], self.p[f"{pre}.bias"], lay["up"],
                              lay["down"], lay["pad"], gain, slope, self.cfg["conv_clamp"])

    def synthesis(self, ws: torch.Tensor, stop_at: Optional[str] = None):
        """``ws`` [B, n_latent, w_dim] -> the image [B, 3, H, W] (about
        [-1, 1]); with ``stop_at`` (``input`` or a layer's name) that
        layer's output, flattened [B, C * H * W]."""
        b = ws.shape[0]
        x = self.input_layer(ws[:, 0])
        if stop_at == "input":
            return x.reshape(b, -1)
        for i, lay in enumerate(self.layers):
            x = self.layer(lay, x, ws[:, i + 1])
            if stop_at == lay["name"]:
                return x.reshape(b, -1)
        return x * self.cfg["output_scale"]

    def tap(self, z: torch.Tensor, layer: str) -> torch.Tensor:
        """Activations at ``layer`` (``style``, ``input`` or a layer's name)
        of Z latents [B, z_dim], flattened."""
        w = self.mapping(z)
        if layer == "style":
            return w
        return self.synthesis(w[:, None, :].expand(-1, self.n_latent, -1), stop_at=layer)
