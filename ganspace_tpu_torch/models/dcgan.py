"""DCGAN generator in the pytorch_GAN_zoo style as a PyTorch module.

Counterpart of ``ganspace_tpu/models/dcgan.py`` and, through it, of the
reference's ``GANZooModel`` (``models/wrappers.py:438-466``), which loads
``facebookresearch/pytorch_GAN_zoo`` over torch.hub: a trunk of transposed
convs, eval-mode batch norm and ReLU, tanh at the end, with importable
weights.  Kept from the reference: no true ``partial_forward`` (a full
forward, ``wrappers.py:453-455``), and the last 20 latent dimensions as the
conditioning slice (``wrappers.py:457-461``).

The module tree follows the checkpoint key names (``deconv{i}.weight``,
``bn{i}.running_mean``, ...), so :meth:`GANZooModel.params_from_jax` loads
the JAX package's flat parameter dict without renaming.  Built without
``cfg`` and ``params``, the model loads the zoo ``.pth`` that
``models/checkpoints.py`` finds, its architecture read off the file, and
keeps seeded random weights when there is none.

Where each op runs: ``deconv0`` (1x1 -> 4x4, stride 1, padding 0) is one
dense product (cuBLAS); every later ``deconv`` (k = 4, stride 2, padding 1)
goes through the stride-2 kernel, :func:`upsample_conv`, with the zoo's
[in, out, k, k] weight read as [out, in, k, k]; the batch norms use the
**running** statistics, so a sample's output never depends on its
batch-mates (``tests/test_partial_forward.py:80``).

Under the preview policy (``ops/precision.py``) the storage stays float32,
as the JAX package's DCGAN ignores it; at the ``default`` precision its
convs take bf16 operands with float32 sums (``ganspace_tpu/models/dcgan.py:
67-78``): ``deconv0``'s product rounds both operands, the stride-2 kernel
runs its bf16 datapath on float32 storage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.models import checkpoints
from ganspace_tpu_torch.models.base import BaseGenerator, TapState, grad_while_edit_override
from ganspace_tpu_torch.models.torch_import import import_ganzoo_dcgan
from ganspace_tpu_torch.ops import precision
from ganspace_tpu_torch.ops.modconv import LayerWeights, upsample_conv
from ganspace_tpu_torch.ops.precision import ieee_f32
from ganspace_tpu_torch.sampling import gaussian_latents

BN_EPS = 1e-5


@dataclass(frozen=True)
class DCGANConfig:
    latent_dim: int = 120
    cond_dim: int = 20          # last 20 dims = conditioning (wrappers.py:457-461)
    base_channels: int = 512
    resolution: int = 64

    @property
    def z_total(self) -> int:
        return self.latent_dim + self.cond_dim

    @property
    def n_up(self) -> int:
        """Stride-2 stages after the 4x4 format layer."""
        return int(np.log2(self.resolution // 4))

    def channels(self):
        """Output channels of ``deconv0 .. deconv{n_up}``."""
        return [3 if i == self.n_up else max(self.base_channels >> i, 32)
                for i in range(self.n_up + 1)]


def init_params(cfg: DCGANConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters, drawn exactly as ``ganspace_tpu``'s ``init_params``
    (same keys, same numpy draws in the same order: bit-identical)."""
    rs = np.random.RandomState(seed)
    p: Dict[str, np.ndarray] = {}
    cin = cfg.z_total
    for i, cout in enumerate(cfg.channels()):
        p[f"deconv{i}.weight"] = (0.02 * rs.randn(cin, cout, 4, 4)).astype(np.float32)
        p[f"deconv{i}.bias"] = np.zeros((cout,), np.float32)
        if i != cfg.n_up:
            p[f"bn{i}.weight"] = np.ones((cout,), np.float32)
            p[f"bn{i}.bias"] = np.zeros((cout,), np.float32)
            # torch BatchNorm2d running stats (identity at fresh init);
            # imported checkpoints overwrite these with trained values
            p[f"bn{i}.running_mean"] = np.zeros((cout,), np.float32)
            p[f"bn{i}.running_var"] = np.ones((cout,), np.float32)
        cin = cout
    return p


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class _Deconv(nn.Module):
    """A ConvTranspose2d's weight [in, out, 4, 4] and bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = _param(cin, cout, 4, 4)
        self.bias = _param(cout)


class _EvalBatchNorm(nn.Module):
    """BatchNorm2d in eval mode: the running statistics, eps 1e-5."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = _param(ch)
        self.bias = _param(ch)
        self.running_mean = _param(ch)
        self.running_var = _param(ch)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        def per_channel(t):
            return t.reshape(1, -1, 1, 1)
        y = (y - per_channel(self.running_mean)) * per_channel(
            torch.rsqrt(self.running_var + BN_EPS))
        return y * per_channel(self.weight) + per_channel(self.bias)


class GANZooModel(BaseGenerator):
    """Drop-in equivalent of the reference ``GANZooModel``
    (``models/wrappers.py:438-466``) on one torch device, the card unless
    ``device`` says otherwise."""

    def __init__(self, model_name: str = "DCGAN", cfg: Optional[DCGANConfig] = None,
                 params: Optional[Dict[str, np.ndarray]] = None, init_seed: int = 0,
                 device="cuda"):
        super().__init__(model_name, "default")
        device = require_device(device)
        if params is None and cfg is None:
            # the pytorch_GAN_zoo save the JAX package reads, its
            # architecture inferred from the file; seeded random weights
            # when there is none
            found, rel = checkpoints.locate_ganzoo(model_name)
            if found is not None:
                params, cfg = import_ganzoo_dcgan(found)
            else:
                checkpoints.note_random_init(model_name, rel)
        self.cfg = cfg or DCGANConfig()
        self.resolution = self.cfg.resolution
        self.name = model_name
        self.has_latent_residual = False
        if params is None:
            params = init_params(self.cfg, init_seed)
        # the widths are the weights' (a zoo checkpoint keeps its own
        # schedule, which the config does not record)
        for i in range(self.cfg.n_up + 1):
            cin, cout = params[f"deconv{i}.weight"].shape[:2]
            self.add_module(f"deconv{i}", _Deconv(cin, cout))
            if i != self.cfg.n_up:
                self.add_module(f"bn{i}", _EvalBatchNorm(cout))
        self.up_weights = [LayerWeights(getattr(self, f"deconv{i}").weight)
                           for i in range(1, self.cfg.n_up + 1)]
        self.params_from_jax(params)
        self.to(device)

    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> None:
        """Load the JAX package's flat parameter dict (the key layout
        ``init_params`` and ``import_ganzoo_dcgan`` produce)."""
        self.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                              for k, v in flat.items()}, strict=True)

    def tap_names(self):
        return tuple(f"deconv{i}" for i in range(self.cfg.n_up)) + ("output",)

    def sample_latent(self, n_samples=1, seed=0, truncation=None):
        if seed is None:
            seed = self.host_rng.next_seed()
        z = gaussian_latents(n_samples, self.cfg.z_total, seed)
        return torch.from_numpy(z).to(self.device)

    def _gaussian_latent_dim(self):
        return self.cfg.z_total

    def _latents_from_gaussian(self, z):
        return z

    def get_conditional_state(self, z):
        return z[:, -self.cfg.cond_dim:]

    def set_conditional_state(self, z, c):
        return torch.cat([z[:, :-self.cfg.cond_dim], torch.as_tensor(c).to(z)], dim=1)

    # -- execution ----------------------------------------------------------
    def synthesize(self, z: torch.Tensor, ts: TapState):
        """The trunk on latents [B, z_total]; returns the tanh image, or None
        when ``ts`` stopped at a tap."""
        n_up = self.cfg.n_up
        x = z.reshape(z.shape[0], -1)
        for i in range(n_up + 1):
            deconv = getattr(self, f"deconv{i}")
            if i == 0:
                # 1x1 -> 4x4, stride 1, padding 0: out[o, u, v] = sum_c z[c] w[c, o, u, v]
                y = precision.einsum("bc,couv->bouv", x, deconv.weight)
            else:
                y = upsample_conv(x, deconv.weight.transpose(0, 1), pad=1,
                                  cache=self.up_weights[i - 1])
            y = y + deconv.bias.reshape(1, -1, 1, 1)
            if i != n_up:
                y = ts.tap(f"deconv{i}", torch.relu(getattr(self, f"bn{i}")(y)))
            else:
                y = ts.tap("output", torch.tanh(y))
            if ts.stopped:
                return None
            x = y
        return x

    @grad_while_edit_override
    def _run(self, x, stop_at: Optional[str]):
        if isinstance(x, list):
            if len(x) != 1:
                raise ValueError("DCGAN only supports a single global latent")
            x = x[0]
        z = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        retain, edits, store = self._instrumentation()
        ts = TapState(retain, edits, stop_at)
        with ieee_f32():
            img = self.synthesize(z, ts)
        if store is not None:
            store(ts.retained)
        return img

    def forward(self, x):
        return 0.5 * (self._run(x, None) + 1)

    def partial_forward(self, x, layer_name: str):
        # The reference's "Don't bother for now": a full forward
        # (wrappers.py:453-455), its output returned; the tap still retains.
        return self._run(x, None)

    def pure_acts_fn(self, layer_name: str):
        """``fn(z [n, z_total]) -> activations [n, -1]`` at the tap, stopping
        there; None at ``output``, which needs the full forward, so the
        stream takes the generic loop (the JAX package's rule)."""
        tap = self.resolve_tap(layer_name)
        if tap == "output":
            return None

        @torch.no_grad()
        def fn(z):
            ts = TapState((tap,), None, tap)
            with ieee_f32():
                self.synthesize(z, ts)
            return ts.retained[tap].reshape(z.shape[0], -1)
        return fn
