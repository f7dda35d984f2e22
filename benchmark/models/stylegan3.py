"""StyleGAN3-T in the benchmark: weights from the seed on the device, the
program's model built on them, the plain reference, the work of a unit.

The weights are the official keys at the configuration's sizes, drawn in
one ``randn`` on a generator on the card: linear and conv weights standard
normal (the mapping's over lr_mul), the style affines' biases 1 + 0.1 N(0,
1), the other biases 0.1 N(0, 1); the input's frequencies and phases from
the same draws by the official rule (a radius-damped normal scaled to the
bandwidth; phases uniform in [-0.5, 0.5), here 0.5 erf(n / sqrt 2)); its
affine 0.05 N(0, 1) with the bias [1, 0, 0, 0] (the official weight is 0,
which would leave the input's transform fixed under W edits).  Each
layer's ``magnitude_ema`` is what the official training tracks, the mean
square of the layer's input, here over ``EMA_LATENTS`` latents drawn from
the seed and run through the reference, each layer after the ones before
it are so set, so that every layer sees inputs of mean square about 1;
ToRGB's is the one that gives those latents' images the standard
deviation ``IMAGE_STD``, so that frames are neither saturated nor flat
whatever the random channel mix."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from benchmark import work
from benchmark.metrics._flrelu import filtered_lrelu as flrelu_work
from benchmark.models import weights_from_specs
from benchmark.reference import ieee, sampling
from benchmark.reference.stylegan3 import StyleGAN3 as _Reference
from benchmark.reference.stylegan3 import schedule

#: the latents whose layer inputs set ``magnitude_ema``
EMA_LATENTS = 4
#: the standard deviation of those latents' images (in [-1, 1] units)
IMAGE_STD = 0.5


def param_specs(cfg: dict) -> List[Tuple[str, tuple, float, float]]:
    """(key, shape, scale, offset): the parameter is offset + scale N(0, 1),
    before :func:`make_weights` maps the input's draws."""
    wd, zd = cfg["w_dim"], cfg["z_dim"]
    first, *layers = schedule(cfg)
    c0 = first["channels"]
    specs = []
    for i in range(cfg["mapping_layers"]):
        specs.append((f"mapping.fc{i}.weight", (wd, zd if i == 0 else wd),
                      1.0 / cfg["lr_mul"], 0.0))
        specs.append((f"mapping.fc{i}.bias", (wd,), 0.1, 0.0))
    specs.append(("mapping.w_avg", (wd,), 0.0, 0.0))
    specs += [("synthesis.input.freqs", (c0, 2), 1.0, 0.0),
              ("synthesis.input.phases", (c0,), 1.0, 0.0),
              ("synthesis.input.weight", (c0, c0), 1.0, 0.0),
              ("synthesis.input.affine.weight", (4, wd), 0.05, 0.0),
              ("synthesis.input.affine.bias", (4,), 0.0, 0.0),
              ("synthesis.input.transform", (3, 3), 0.0, 0.0)]
    for lay in layers:
        pre = "synthesis." + lay["name"]
        specs += [(f"{pre}.affine.weight", (lay["cin"], wd), 1.0, 0.0),
                  (f"{pre}.affine.bias", (lay["cin"],), 0.1, 1.0),
                  (f"{pre}.weight", (lay["cout"], lay["cin"], lay["k"], lay["k"]), 1.0, 0.0),
                  (f"{pre}.bias", (lay["cout"],), 0.1, 0.0),
                  (f"{pre}.magnitude_ema", (), 0.0, 1.0)]
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    p = weights_from_specs(param_specs(cfg), seed, device)
    first = schedule(cfg)[0]
    f = p["synthesis.input.freqs"]
    radii = f.norm(dim=1, keepdim=True)
    f.div_(radii * torch.exp(radii * radii) ** 0.25).mul_(first["bandwidth"])
    ph = p["synthesis.input.phases"]
    ph.copy_(0.5 * torch.erf(ph / math.sqrt(2.0)))
    p["synthesis.input.affine.bias"][0] += 1.0
    p["synthesis.input.transform"].add_(torch.eye(3, device=f.device))
    gen = torch.Generator(device=f.device)
    gen.manual_seed((seed + 2) % 2**63)
    z = torch.randn(EMA_LATENTS, cfg["z_dim"], generator=gen, device=f.device)
    ref = _Reference(p, cfg)
    with torch.no_grad(), ieee():
        w = ref.mapping(z)
        x = ref.input_layer(w)
        for lay in ref.layers:
            ema = p[f"synthesis.{lay['name']}.magnitude_ema"]
            if lay["rgb"]:                  # ema is 1 here: the image's mean square
                y = ref.layer(lay, x, w) * cfg["output_scale"]
                ema.fill_(torch.mean(y * y) / IMAGE_STD ** 2)
            else:
                ema.fill_(torch.mean(x * x))
                x = ref.layer(lay, x, w)
    return p


def _port_cfg(cfg: dict):
    """The program's ``SG3Config`` from the configuration file's numbers."""
    from ganspace_tpu_torch.models.stylegan3 import SG3Config
    return SG3Config(**{f.name: cfg[f.name] for f in dataclasses.fields(SG3Config)
                        if f.name in cfg})


def build_port(cfg: dict, weights: Dict[str, torch.Tensor], mix: dict, device):
    """The program's instrumented StyleGAN3 on these weights, its tap the
    mix's layer, in W when the mix says so."""
    from ganspace_tpu_torch.models import get_instrumented_model
    params = {k: v.detach().cpu() for k, v in weights.items()}
    return get_instrumented_model(cfg["port_model"], mix.get("class") or cfg["port_class"],
                                  mix["layer"], str(device), params=params, cfg=_port_cfg(cfg),
                                  truncation=cfg["truncation"],
                                  use_w=bool(mix.get("use_w", False)))


def reference(cfg: dict, weights: Dict[str, torch.Tensor], mix: dict) -> _Reference:
    return _Reference(weights, cfg)


def latent_dim(cfg: dict) -> int:
    return cfg["w_dim"]


def latent_block(cfg: dict, mix: dict, seed: int, i: int, n: int, device) -> torch.Tensor:
    """Block ``i`` of a fit's latents (Z): the program's device stream."""
    return sampling.gaussian_block(seed, i, n, cfg["z_dim"], device)


def tap_dim(cfg: dict, layer: str) -> int:
    """Features at ``style``, ``input`` or a layer ``L<i>_<size>_<channels>``."""
    if layer == "style":
        return cfg["w_dim"]
    first = schedule(cfg)[0]
    if layer == "input":
        return first["channels"] * first["size"] ** 2
    _, size, ch = layer.split("_")
    return int(size) ** 2 * int(ch)


def _flops(cfg: dict, stop_at=None, mapping: bool = True) -> float:
    """Model FLOPs of one sample: the mapping, every affine, the input's
    products (grid by frequencies, the mixing weight), the modulated 3x3
    convs at their output size in + 2, the 1x1 ToRGB and the filtered leaky
    ReLUs' FIR taps (:mod:`benchmark.metrics._flrelu`), up to the tap."""
    wd = cfg["w_dim"]
    total = cfg["mapping_layers"] * work.linear(1, wd, wd) if mapping else 0.0
    if stop_at == "style":
        return total
    first, *layers = schedule(cfg)
    c0, n0 = first["channels"], first["size"] ** 2
    total += work.linear(1, wd, 4) + 2.0 * n0 * c0 * 2 + 2.0 * n0 * c0 * c0
    if stop_at == "input":
        return total
    size = first["size"]
    for lay in layers:
        total += work.linear(1, wd, lay["cin"])
        if lay["rgb"]:
            total += 2.0 * size * size * lay["cin"] * lay["cout"]
            n = size
        else:
            n = size + 2
            total += work.modconv3x3(1, lay["cin"], lay["cout"], n, n)[0]
        taps = [1 if f is None else len(f) for f in (lay["fu"], lay["fd"])]
        total += flrelu_work(1, lay["cout"], n, n, *taps, lay["up"], lay["down"], lay["pad"])[0]
        size = int(lay["name"].split("_")[1])
        if lay["name"] == stop_at:
            break
    return total


def sample_flops(cfg: dict, mix: dict) -> float:
    """A fit's model FLOPs per sample before the estimator: Z -> the tap."""
    return _flops(cfg, stop_at=mix["layer"], mapping=True)


def frame_flops(cfg: dict, mix: dict) -> float:
    """A rendered frame's model FLOPs: the full synthesis from W (the
    strip's one mapping is per strip, not per frame, and left out)."""
    return _flops(cfg, mapping=False)
