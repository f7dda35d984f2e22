"""StyleGAN2 in the benchmark: weights from the seed on the device, the
program's model built on them, the plain reference, the work of a unit.

The weights are the rosinality keys at the configuration's sizes, drawn
in one ``randn`` on a generator on the card: weights standard normal (the
layers scale them by 1 / sqrt(fan_in) at run time, the mapping's by
lr_mul too), the modulations' biases 1 + 0.1 N(0, 1), the other biases and
the noise strengths 0.1 N(0, 1)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import work
from benchmark.models import weights_from_specs
from benchmark.reference import sampling
from benchmark.reference.stylegan2 import StyleGAN2 as _Reference


def _channels(cfg: dict) -> Dict[int, int]:
    return {int(k): int(v) for k, v in cfg["channels"].items()}


def _log_size(cfg: dict) -> int:
    return int(math.log2(cfg["resolution"]))


def param_specs(cfg: dict) -> List[Tuple[str, tuple, float, float]]:
    """(key, shape, scale, offset): the parameter is offset + scale N(0, 1)."""
    wd, ch = cfg["w_dim"], _channels(cfg)
    specs = []

    def modconv(name, cin, cout, k):
        specs.append((f"{name}.weight", (cout, cin, k, k), 1.0, 0.0))
        specs.append((f"{name}.modulation.weight", (cin, wd), 1.0, 0.0))
        specs.append((f"{name}.modulation.bias", (cin,), 0.1, 1.0))

    def styled(name, cin, cout):
        modconv(f"{name}.conv", cin, cout, 3)
        specs.append((f"{name}.noise.weight", (1,), 0.1, 0.0))
        specs.append((f"{name}.activate.bias", (cout,), 0.1, 0.0))

    def to_rgb(name, cin):
        modconv(f"{name}.conv", cin, 3, 1)
        specs.append((f"{name}.bias", (1, 3, 1, 1), 0.1, 0.0))

    for i in range(1, cfg["n_mlp"] + 1):
        specs.append((f"style.{i}.weight", (wd, wd), 1.0 / cfg["lr_mul"], 0.0))
        specs.append((f"style.{i}.bias", (wd,), 0.1, 0.0))
    specs.append(("input.input", (1, ch[4], 4, 4), 1.0, 0.0))
    styled("conv1", ch[4], ch[4])
    to_rgb("to_rgb1", ch[4])
    cin, k = ch[4], 0
    for r in range(3, _log_size(cfg) + 1):
        cout = ch[2 ** r]
        styled(f"convs.{k}", cin, cout)
        styled(f"convs.{k + 1}", cout, cout)
        to_rgb(f"to_rgbs.{r - 3}", cout)
        cin, k = cout, k + 2
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights_from_specs(param_specs(cfg), seed, device)


def build_port(cfg: dict, weights: Dict[str, torch.Tensor], mix: dict, device):
    """The program's instrumented StyleGAN2 on these weights, its tap the
    mix's layer, in W when the mix says so."""
    from ganspace_tpu_torch.models import get_instrumented_model
    from ganspace_tpu_torch.models.stylegan2 import SG2Config
    sg2 = SG2Config(resolution=cfg["resolution"], w_dim=cfg["w_dim"], n_mlp=cfg["n_mlp"],
                    channels=tuple(sorted(_channels(cfg).items())),
                    blur_taps=tuple(cfg["blur_taps"]))
    params = {k: v.detach().cpu() for k, v in weights.items()}
    return get_instrumented_model(cfg["port_model"], mix.get("class") or cfg["port_class"],
                                  mix["layer"], str(device), params=params, cfg=sg2,
                                  truncation=cfg["truncation"],
                                  use_w=bool(mix.get("use_w", False)))


def reference(cfg: dict, weights: Dict[str, torch.Tensor], mix: dict) -> _Reference:
    return _Reference(weights, cfg)


def latent_dim(cfg: dict) -> int:
    return cfg["w_dim"]


def latent_block(cfg: dict, mix: dict, seed: int, i: int, n: int, device) -> torch.Tensor:
    """Block ``i`` of a fit's latents (Z): the program's device stream."""
    return sampling.gaussian_block(seed, i, n, cfg["w_dim"], device)


def tap_dim(cfg: dict, layer: str) -> int:
    """Features at ``conv1`` or ``convs.<k>`` (k = 0, 1 at 8 px; 2, 3 at 16; ...)."""
    res = 4 if layer == "conv1" else 2 ** (3 + int(layer.split(".")[1]) // 2)
    return _channels(cfg)[res] * res * res


def _layers(cfg: dict):
    """The synthesis in order: (kind, name, cin, cout, res_in)."""
    ch = _channels(cfg)
    out = [("conv", "conv1", ch[4], ch[4], 4), ("rgb", "to_rgb1", ch[4], 3, 4)]
    cin, k = ch[4], 0
    for r in range(3, _log_size(cfg) + 1):
        res, cout = 2 ** r, ch[2 ** r]
        out += [("up", f"convs.{k}", cin, cout, res // 2),
                ("conv", f"convs.{k + 1}", cout, cout, res),
                ("rgb", f"to_rgbs.{r - 3}", cout, 3, res)]
        cin, k = cout, k + 2
    return out


def _flops(cfg: dict, stop_at=None, mapping: bool = True) -> float:
    """Model FLOPs of one sample: the mapping, every style affine, the
    modulated 3x3 convs, the stride-2 ones (taps meeting an input pixel)
    and the 1x1 to_rgb convs, up to the tap (the blur, noise and
    activations are not counted)."""
    wd = cfg["w_dim"]
    total = cfg["n_mlp"] * work.linear(1, wd, wd) if mapping else 0.0
    for kind, name, cin, cout, res in _layers(cfg):
        total += work.linear(1, wd, cin)
        if kind == "conv":
            total += work.modconv3x3(1, cin, cout, res, res)[0]
        elif kind == "up":
            total += work.upconv(1, cin, cout, res, res)[0]
        else:
            total += 2.0 * res * res * cin * cout
        if name == stop_at:
            break
    return total


def sample_flops(cfg: dict, mix: dict) -> float:
    """A fit's model FLOPs per sample before the estimator: Z -> the tap."""
    return _flops(cfg, stop_at=mix["layer"], mapping=True)


def frame_flops(cfg: dict, mix: dict) -> float:
    """A rendered frame's model FLOPs: the full synthesis from W (the
    strip's one mapping is per strip, not per frame, and left out)."""
    return _flops(cfg, mapping=False)
