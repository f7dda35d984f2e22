"""Plain PyTorch references the benchmark judges the program against.

Float32 with TF32 off (:func:`ieee`), no kernel and no module of the
program: the generators follow their published descriptions, the
decomposition follows the published streaming Nystrom sketch with the
rules the program documents (test matrix, oversampling, refine policy).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee(tf32: bool = False):
    """Float32 products as IEEE float32 (``tf32=False``), or in TF32 for the
    control; the previous switches are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
