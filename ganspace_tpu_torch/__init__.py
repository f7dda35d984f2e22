"""ganspace_tpu_torch: the PyTorch + CUDA port of ganspace_tpu.

A second package beside the JAX one, for one NVIDIA Hopper GPU.  It covers
the visualize CLI on StyleGAN, StyleGAN2, BigGAN-deep, ProGAN and DCGAN:
sample latents, run the generator to a tap on the card, fit the streaming
IPCA estimator (exact moments or the Nystrom sketch) or a full-batch one
(PCA, randomized SVD, FastICA, sparse PCA), regress the components to
latent space, write the ``.npz`` component cache and render the edit
grids, sweep videos and gallery pages; the web viewer; the bf16 preview
policy (``ops/precision.py``); the paper's figure scripts
(``notebooks/``); and ``makesample`` with its image writer pool
(``native/``).  ``python -m ganspace_tpu_torch`` dispatches to the CLIs.
The two Pallas kernels of the JAX package are hand-written CUDA kernels
here (``csrc/``), each beside its plain PyTorch version.
Models are built on the card unless the caller names another device.

The package imports ``torch`` and never ``jax`` or ``ganspace_tpu``.
"""

__version__ = "0.1.0"


def require_device(name):
    """``torch.device(name)``, refusing a CUDA device when none is present.

    The port never falls back from the card to the CPU: asking for
    ``cuda`` on a machine without a usable GPU is an error."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run the plain PyTorch path")
    return device


__all__ = ["__version__", "require_device"]
