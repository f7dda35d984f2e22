"""Float32 precision policy: IEEE float32, never TF32.

The JAX package pins every contraction to ``lax.Precision.HIGHEST``
(``ganspace_tpu/ops/precision.py``, ``estimators/utils.py``): true float32
accumulation, which component parity with the float32 reference needs.
PyTorch's counterpart is to keep TF32 off for both matmuls and cuDNN
convolutions.  Matmul TF32 is off by default, but cuDNN convolution TF32 is
ON by default, so the port sets both explicitly.

The flags are process-global in PyTorch; :func:`ieee_f32` sets them for a
region and restores the caller's values afterwards.  The port's entry
points (model forward, decomposition, visualize) run inside it.  The bf16
preview policy of the JAX package is not ported.
"""

from __future__ import annotations

import contextlib

import torch


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
