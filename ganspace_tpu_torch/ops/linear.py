"""Equalized-learning-rate linear layers and fused bias + activation.

Counterparts of ``ganspace_tpu/ops/linear.py``: the StyleGAN2
``EqualLinear`` and ``fused_bias_act`` as plain PyTorch expressions.
Weights are stored [out, in] as in the checkpoints.  The product follows
JAX's ``jnp.matmul``: the operands promote to a common dtype, and the
``default`` precision of ``ops/precision.py`` rounds them to bf16 (the
MXU's one pass) with float32 accumulation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ganspace_tpu_torch.ops.precision import (
    StorageCopies, bf16_values, get_precision, round_bf16)


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    """x / sqrt(mean(x^2) + 1e-8) along the last dim."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)


def equal_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None, *, lr_mul: float = 1.0,
                 gain: float = 1.0, copies: StorageCopies | None = None) -> torch.Tensor:
    """y = x @ (weight * gain * lr_mul / sqrt(fan_in)).T + bias * lr_mul: the
    JAX package's ``equal_linear``; ``gain=1`` is StyleGAN2's ``EqualLinear``
    and StyleGAN's StyleMod, ``sqrt(2)`` StyleGAN's mapping layers.
    ``copies``, the layer's :class:`StorageCopies`, keeps the scaled weight
    (rounded to bf16 at ``default``) between calls."""
    scale = gain * weight.shape[1] ** -0.5 * lr_mul
    prec = get_precision()

    def scaled(t):
        return round_bf16(t * scale) if prec == "default" else t * scale
    w = scaled(weight) if copies is None else copies(weight, weight.dtype, prec, scaled)
    dt = torch.promote_types(x.dtype, w.dtype)
    if prec == "default":
        y = F.linear(bf16_values(x), w).to(dt)
    else:
        y = F.linear(x.to(dt), w.to(dt))
    if bias is not None:
        y = y + bias * lr_mul
    return y


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None, *,
                     channel_dim: int = 1) -> torch.Tensor:
    """bias-add + leaky-relu(0.2) + gain sqrt(2); ``channel_dim`` is where
    the bias broadcasts (1 for NCHW maps, -1 for dense activations)."""
    if bias is not None:
        shape = [1] * x.ndim
        shape[channel_dim] = bias.shape[0]
        x = x + bias.reshape(shape).to(x.dtype)
    return F.leaky_relu(x, 0.2) * math.sqrt(2.0)
