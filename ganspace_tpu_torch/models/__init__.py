"""Model registry and instrumented-model factory
(``ganspace_tpu/models/__init__.py``, reference ``models/wrappers.py:651-735``).

StyleGAN and StyleGAN2 are the families ported so far; custom generators
can be registered under any name.  Every entry point builds its model on
the card unless ``device`` names another device; it never falls back to
the CPU.
"""

from __future__ import annotations

import torch

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.models.base import BaseGenerator, InstrumentedModel
from ganspace_tpu_torch.models.stylegan import StyleGAN
from ganspace_tpu_torch.models.stylegan2 import StyleGAN2

#: user-registered model factories: name -> callable(output_class, device=, **kwargs)
_CUSTOM_MODELS = {}

_NOT_PORTED = ("ProGAN", "DCGAN")


def register_model(name: str, factory) -> None:
    """Register a custom generator under ``name``.  ``factory(output_class,
    device=..., **kwargs)`` must return a :class:`BaseGenerator`; the
    decomposition and visualize then accept ``--model name``."""
    _CUSTOM_MODELS[name] = factory


def _only(kwargs, keys):
    return {k: v for k, v in kwargs.items() if k in keys}


def get_model(name, output_class=None, device="cuda", **kwargs) -> BaseGenerator:
    """Name -> generator on ``device`` (reference ``wrappers.py:652-684``),
    resolved by :func:`require_device`.  A ``Config`` may be passed as the
    first argument."""
    if isinstance(name, Config):
        cfg = name
        kwargs.setdefault("use_w", cfg.use_w)
        return get_model(cfg.model, cfg.output_class, cfg.device, **kwargs)
    device = require_device(device)
    if name in _CUSTOM_MODELS:
        return _CUSTOM_MODELS[name](output_class, device=device, **kwargs)
    if name == "StyleGAN":
        return StyleGAN(class_name=output_class, device=device,
                        **_only(kwargs, ("truncation", "use_w", "cfg", "params", "init_seed")))
    if name == "StyleGAN2":
        return StyleGAN2(class_name=output_class, device=device,
                         **_only(kwargs, ("truncation", "use_w", "cfg", "params",
                                          "latent_avg", "init_seed")))
    if name in _NOT_PORTED or "BigGAN" in name:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md, queue 1: the other generator families)")
    raise RuntimeError(f"Unknown model {name}")


@torch.no_grad()
def annotate_model_shapes(inst: InstrumentedModel, layers) -> InstrumentedModel:
    """Record the latent and per-tap feature shapes with one batch-1 run up
    to each tap (the reference's zero-latent dry run, ``modelconfig.py:110-144``)."""
    model = inst.model
    z = model.sample_latent(1, seed=0)
    inst.input_shape = tuple(z.shape)
    for layer in layers:
        inst.retain_layer(layer)
        model.partial_forward(z, layer)
        inst.feature_shape[layer] = tuple(inst.retained_layer(layer, clear=True).shape)
    return inst


def get_instrumented_model(name, output_class=None, layers=None, device="cuda",
                           **kwargs) -> InstrumentedModel:
    """Build, wrap, validate and shape-annotate (reference ``wrappers.py:693-735``)."""
    if isinstance(name, Config):
        cfg = name
        kwargs.setdefault("use_w", cfg.use_w)
        return get_instrumented_model(cfg.model, cfg.output_class, cfg.layer,
                                      cfg.device, **kwargs)

    use_w = kwargs.pop("use_w", False)
    model = get_model(name, output_class, device, **kwargs)
    if not isinstance(layers, (list, tuple)):
        layers = [layers]
    for layer_name in layers:
        model.resolve_tap(layer_name)

    # StyleGANs annotate in Z (reference wrappers.py:713-715).
    if hasattr(model, "use_z"):
        model.use_z()
    inst = InstrumentedModel(model)
    annotate_model_shapes(inst, layers)
    if use_w and hasattr(model, "use_w"):
        model.use_w()
    return inst


__all__ = [
    "register_model",
    "get_model",
    "get_instrumented_model",
    "annotate_model_shapes",
    "BaseGenerator",
    "InstrumentedModel",
    "StyleGAN",
    "StyleGAN2",
]
