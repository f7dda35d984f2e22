"""BigGAN-deep in the benchmark: weights from the seed on the device, the
program's model built on them, the plain reference of its ``gen_z`` tap,
the work of a unit.

The weights are every key of the ``pytorch-pretrained-BigGAN`` layout at
the configuration's sizes, drawn in one ``randn`` on a generator on the
card: convolutions and linear maps N(0, 1 / fan_in), the class embedding
0.1 N(0, 1), the conditional batch norms' projections 0.02 N(0, 1), their
stored statistics 0.1 N(0, 1) (means) and 1 + 0.05 N(0, 1) (variances),
biases 0.1 N(0, 1), the attention's gamma 0.1 + 0.01 N(0, 1)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import work
from benchmark.models import weights_from_specs
from benchmark.reference import sampling
from benchmark.reference.biggan import BigGANGenZ

# ImageNet indices of the class names a mix may give
CLASSES = {"husky": 250}


def param_specs(cfg: dict) -> List[Tuple[str, tuple, float, float]]:
    """(key, shape, scale, offset): the parameter is offset + scale N(0, 1)."""
    zd, ch, ns = cfg["z_dim"], cfg["channel_width"], cfg["n_stats"]
    cond = 2 * zd
    specs = []

    def conv(name, cin, cout, k, bias=True):
        specs.append((f"{name}.weight", (cout, cin, k, k), 1.0 / math.sqrt(cin * k * k), 0.0))
        if bias:
            specs.append((f"{name}.bias", (cout,), 0.1, 0.0))

    def stats(name, c):
        specs.append((f"{name}.running_means", (ns, c), 0.1, 0.0))
        specs.append((f"{name}.running_vars", (ns, c), 0.05, 1.0))

    def cond_bn(name, c):
        stats(name, c)
        specs.append((f"{name}.scale.weight", (c, cond), 0.02, 0.0))
        specs.append((f"{name}.offset.weight", (c, cond), 0.02, 0.0))

    specs.append(("embeddings.weight", (zd, cfg["num_classes"]), 0.1, 0.0))
    d = 4 * 4 * 16 * ch
    specs.append(("generator.gen_z.weight", (d, cond), 1.0 / math.sqrt(cond), 0.0))
    specs.append(("generator.gen_z.bias", (d,), 0.1, 0.0))
    gi = 0
    for i, (up, cin_m, cout_m) in enumerate(cfg["layers"]):
        if i == cfg["attention_layer_position"]:
            c = ch * cin_m
            base = f"generator.layers.{gi}"
            conv(f"{base}.snconv1x1_theta", c, c // 8, 1, bias=False)
            conv(f"{base}.snconv1x1_phi", c, c // 8, 1, bias=False)
            conv(f"{base}.snconv1x1_g", c, c // 2, 1, bias=False)
            conv(f"{base}.snconv1x1_o_conv", c // 2, c, 1, bias=False)
            specs.append((f"{base}.gamma", (1,), 0.01, 0.1))
            gi += 1
        cin, cout = ch * cin_m, ch * cout_m
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
    c = ch * cfg["layers"][-1][2]
    stats("generator.bn", c)
    specs.append(("generator.bn.weight", (c,), 0.1, 1.0))
    specs.append(("generator.bn.bias", (c,), 0.1, 0.0))
    conv("generator.conv_to_rgb", c, c, 3)
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights_from_specs(param_specs(cfg), seed, device)


def _port_cfg(cfg: dict):
    from ganspace_tpu_torch.models.biggan import BigGANConfig
    return BigGANConfig(output_dim=cfg["resolution"], z_dim=cfg["z_dim"],
                        class_embed_dim=cfg["class_embed_dim"],
                        channel_width=cfg["channel_width"], num_classes=cfg["num_classes"],
                        layers=tuple(tuple(l) for l in cfg["layers"]),
                        attention_layer_position=cfg["attention_layer_position"],
                        eps=cfg["eps"], n_stats=cfg["n_stats"])


def build_port(cfg: dict, weights: Dict[str, torch.Tensor], mix: dict, device):
    from ganspace_tpu_torch.models import get_instrumented_model
    params = {k: v.detach().cpu() for k, v in weights.items()}
    return get_instrumented_model(cfg["port_model"], mix["class"], mix["layer"], str(device),
                                  params=params, cfg=_port_cfg(cfg),
                                  truncation=cfg["truncation"])


def reference(cfg: dict, weights: Dict[str, torch.Tensor], mix: dict) -> BigGANGenZ:
    return BigGANGenZ(weights, CLASSES[mix["class"]])


def latent_dim(cfg: dict) -> int:
    return cfg["z_dim"]


def latent_block(cfg: dict, mix: dict, seed: int, i: int, n: int, device) -> torch.Tensor:
    """Block ``i`` of a fit's latents: truncation x TruncNormal(-2, 2)."""
    return sampling.truncated_block(seed, i, n, cfg["z_dim"], cfg["truncation"], device)


def tap_dim(cfg: dict, layer: str) -> int:
    if layer != "generator.gen_z":
        raise ValueError(f"no BigGAN tap {layer} in the benchmark")
    return 4 * 4 * 16 * cfg["channel_width"]


def sample_flops(cfg: dict, mix: dict) -> float:
    """Model FLOPs per sample to ``gen_z``: the class embedding's product
    and ``gen_z``."""
    zd = cfg["z_dim"]
    return (work.linear(1, cfg["num_classes"], zd)
            + work.linear(1, 2 * zd, tap_dim(cfg, mix["layer"])))
