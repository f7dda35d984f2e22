"""Precision policy: IEEE float32 by default, the bf16 preview on request.

Counterpart of ``ganspace_tpu/ops/precision.py``, with its two orthogonal
switches under the same names:

* **matmul precision** (:func:`get_precision`, :func:`set_precision`,
  :func:`precision`): ``highest`` (the default) or ``default``.  In the
  JAX package ``default`` runs the contractions through the MXU's one bf16
  pass.  Here it selects the bf16-operand datapath of the synthesis ops
  alone: kernel B's and the stride-2 kernel's one-pass mode
  (``ops/modconv.py``), the mapping and style GEMMs (``ops/linear.py``)
  and the stock convolutions (:func:`conv2d`).  It never turns on TF32 for
  cuBLAS or cuDNN: the estimators stay in IEEE float32 under every policy,
  as the JAX package pins them to ``HIGHEST`` (``estimators/utils.py``).
* **activation storage** (:func:`get_synth_dtype`, :func:`set_synth_dtype`,
  :func:`synth_dtype`, :func:`synth_dtype_name`): ``None`` (float32) or
  ``bfloat16``, read by the generators on each call (DCGAN keeps float32
  storage under it, as the JAX package's does).

One rule covers every combination: a synthesis conv on ``x`` rounds its
operands to bf16 when ``x`` is stored in bf16 or the precision is
``default`` (:func:`bf16_operands`), accumulates in float32 and writes its
output in ``x``'s dtype (:func:`conv2d`, :func:`einsum`, :func:`bmm`).
The storage follows the tensor, as in JAX: an op reads it from ``x`` on
every call, never from the global.

PyTorch's own TF32 flags are process-global; :func:`ieee_f32` keeps TF32
off for matmuls and cuDNN convolutions for a region and restores the
caller's values afterwards.  cuDNN's convolution TF32 is ON by default,
so the port sets both explicitly.  The port's entry points (model
forward, decomposition, visualize) run inside it.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
import torch.nn.functional as F


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_flags(matmul_tf32: bool, cudnn_tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32


@contextlib.contextmanager
def ieee_f32():
    """Run the enclosed region with TF32 off for matmuls and convolutions."""
    old = _flags()
    _set_flags(False, False)
    try:
        yield
    finally:
        _set_flags(*old)


# -- matmul precision --------------------------------------------------------

_PRECISIONS = ("highest", "default")
_PRECISION = "highest"


def get_precision() -> str:
    """``highest`` (IEEE float32) or ``default`` (the bf16-operand datapath
    of the synthesis ops)."""
    return _PRECISION


def set_precision(p: str) -> None:
    global _PRECISION
    if p not in _PRECISIONS:
        raise ValueError(f"precision {p!r}: expected one of {_PRECISIONS}")
    _PRECISION = p


@contextlib.contextmanager
def precision(p: str):
    old = get_precision()
    set_precision(p)
    try:
        yield
    finally:
        set_precision(old)


# -- activation storage ------------------------------------------------------

_SYNTH_DTYPE = None  # None -> float32 activations


def get_synth_dtype():
    """Activation storage dtype for generator synthesis, or None for float32."""
    return _SYNTH_DTYPE


def set_synth_dtype(dt) -> None:
    """dt: None / 'float32' for full precision, 'bfloat16' (or
    ``torch.bfloat16``) for half storage."""
    global _SYNTH_DTYPE
    if dt is None or dt == "float32" or dt is torch.float32:
        _SYNTH_DTYPE = None
    elif dt == "bfloat16" or dt is torch.bfloat16:
        _SYNTH_DTYPE = torch.bfloat16
    else:
        raise ValueError(f"synthesis storage {dt!r}: expected float32 or bfloat16")


def synth_dtype_name():
    """The storage policy as a dtype name (``'bfloat16'``) or None: what
    the generators read on each call."""
    return None if _SYNTH_DTYPE is None else "bfloat16"


@contextlib.contextmanager
def synth_dtype(dt):
    old = _SYNTH_DTYPE
    set_synth_dtype(dt)
    try:
        yield
    finally:
        set_synth_dtype(old)


# -- the bf16 datapath -------------------------------------------------------

def bf16_operands(x: torch.Tensor) -> bool:
    """Whether a synthesis conv on ``x`` takes the bf16-operand datapath:
    ``x`` is stored in bf16, or the precision is ``default``."""
    return x.dtype == torch.bfloat16 or _PRECISION == "default"


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even), as float32 values."""
    return t.to(torch.bfloat16).to(torch.float32)


def bf16_values(t: torch.Tensor) -> torch.Tensor:
    """``t`` as bf16-rounded float32 values (a bf16 ``t`` widened exactly)."""
    return t.float() if t.dtype == torch.bfloat16 else round_bf16(t)


def einsum(equation: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of a synthesis contraction of activations ``x`` with
    a weight or a second activation ``w`` under the policy: on the bf16
    datapath (:func:`bf16_operands`) both operands rounded to bf16, float32
    sums, the output in ``x``'s dtype."""
    if not bf16_operands(x):
        return torch.einsum(equation, x, w)
    return torch.einsum(equation, bf16_values(x), bf16_values(w)).to(x.dtype)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` of two synthesis activations under the policy: on the
    bf16 datapath (:func:`bf16_operands` of ``a``) both rounded to bf16,
    float32 sums, the output in ``a``'s dtype."""
    if not bf16_operands(a):
        return torch.bmm(a, b)
    return torch.bmm(bf16_values(a), bf16_values(b)).to(a.dtype)


class StorageCopies:
    """Tensors derived from parameters and buffers, each made once and kept
    until its source changes (another tensor, an in-place edit or a move),
    so that synthesis casts no weight, bias, noise or constant per call.
    ``copies(t, dtype)`` is ``t`` in ``dtype`` (``t`` itself when it is in
    it already); ``copies(t, dtype, tag, make)`` is ``make(t)``, cast to
    ``dtype`` unless that is None, ``tag`` naming the derivation.  The
    kernels' weights of a layer (``ops/modconv.LayerWeights``) are kept in
    one too.  Pass the tensor itself (a parameter or a buffer), not a view
    of it."""

    def __init__(self):
        self._made = {}

    def __call__(self, t: torch.Tensor, dtype: torch.dtype | None, tag=None,
                 make=None) -> torch.Tensor:
        if make is None and (dtype is None or t.dtype == dtype):
            return t
        key = (id(t), dtype, tag)
        valid = (t._version, t.data_ptr())
        hit = self._made.get(key)
        if hit is None or hit[0]() is not t or hit[1] != valid:
            self._made = {k: v for k, v in self._made.items() if v[0]() is not None}
            made = t if make is None else make(t)
            made = made if dtype is None else made.to(dtype)
            hit = self._made[key] = (weakref.ref(t), valid, made)
        return hit[2]


def conv2d(x: torch.Tensor, weight: torch.Tensor, **kwargs) -> torch.Tensor:
    """``F.conv2d`` of a stock synthesis conv (blur, 1x1 ``to_rgb``) under
    the policy.  On the bf16 datapath the operands are rounded to bf16, the
    products accumulate in float32 and the output is rounded to ``x``'s
    dtype: cuDNN's bf16 convolution on a bf16 ``x`` on the card, as the
    JAX package leaves these convs to XLA; elsewhere the convolution runs
    in float32 on the rounded values, a pinned accumulation, which torch's
    CPU bf16 convolution does not promise."""
    if not bf16_operands(x):
        return F.conv2d(x, weight.to(x.dtype), **kwargs)
    if x.is_cuda and x.dtype == torch.bfloat16:
        return F.conv2d(x, weight.to(torch.bfloat16), **kwargs)
    y = F.conv2d(round_bf16(x), round_bf16(weight), **kwargs)
    return y.to(x.dtype)
