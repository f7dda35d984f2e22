"""Generator base contract and tap/edit instrumentation.

Counterpart of ``ganspace_tpu/models/base.py``.  Every generator's
synthesis is one walk over named **tap points** (reference-compatible
module paths).  A :class:`TapState` carries, for one call, which taps to
retain, which edits to apply and where to stop, so ``partial_forward``
runs only the stages up to the tap.  Edits are applied at the tap exactly
like the reference hook (``nethook.py:211-231``):

    retained <- x (pre-edit)
    x <- x * (1 - ablation) + replacement * ablation
    x <- x + offset

:class:`InstrumentedModel` is the host-side bag of (retain set, edit dict)
that models consult when called, with the public API of the reference's
``nethook.InstrumentedModel``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ganspace_tpu_torch.imaging import uint8_nhwc
from ganspace_tpu_torch.sampling import (
    STREAM_MAIN, SeedStream, block_generator, device_gaussian, gaussian_latents)


def _match_rank(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reference broadcast rule (``nethook.make_matching_tensor``): missing
    dims are filled as (1, *v.shape, 1, ...)."""
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    if v.ndim < x.ndim:
        v = v.reshape((1,) + tuple(v.shape) + (1,) * (x.ndim - v.ndim - 1))
    return v


def apply_edit(x: torch.Tensor, edit: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Ablation/replacement then offset, as in ``nethook.py:219-231``."""
    a = edit.get("ablation")
    if a is not None:
        a = _match_rank(a, x)
        x = x * (1 - a)
        r = edit.get("replacement")
        if r is not None:
            x = x + _match_rank(r, x) * a
    b = edit.get("offset")
    if b is not None:
        x = x + _match_rank(b, x)
    return x


class TapState:
    """Per-call carrier for retained activations, edits and early exit."""

    __slots__ = ("retain", "edits", "stop_at", "retained", "stopped")

    def __init__(self, retain: Tuple[str, ...],
                 edits: Optional[Dict[str, Dict[str, torch.Tensor]]],
                 stop_at: Optional[str]):
        self.retain = frozenset(retain)
        self.edits = edits or {}
        self.stop_at = stop_at
        self.retained: Dict[str, torch.Tensor] = {}
        self.stopped = False

    def tap(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if name in self.retain:
            self.retained[name] = x
        e = self.edits.get(name)
        if e is not None:
            x = apply_edit(x, e)
        if name == self.stop_at:
            self.stopped = True
        return x


def canonical_tap(tap_names: Sequence[str], layer_name: str) -> str:
    """Resolve a user layer path to the canonical tap that covers it: an
    exact name wins, else a dotted-prefix match in execution order."""
    for t in tap_names:
        if layer_name == t:
            return t
    for t in tap_names:
        if layer_name.startswith(t + ".") or t.startswith(layer_name + "."):
            return t
    raise ValueError(
        f"Layer '{layer_name}' not found. Available taps:\n" + "\n".join(tap_names))


class BaseGenerator(nn.Module, ABC):
    """Public surface mirroring the reference ``BaseModel`` (``wrappers.py:27-94``).

    Host draws (latent seeds, the style-mixing point) come from
    ``host_rng``, a :class:`SeedStream` the caller reseeds where the JAX
    package reseeds numpy's global stream, so both packages draw the same
    values."""

    def __init__(self, model_name: str, class_name: Optional[str]):
        super().__init__()
        self.model_name = model_name
        self.outclass = class_name
        self.inst: Optional["InstrumentedModel"] = None  # set by InstrumentedModel
        self.host_rng = SeedStream()
        self._latent_shape_cache: Dict[Tuple, Tuple[int, ...]] = {}

    # -- abstract -----------------------------------------------------------
    @abstractmethod
    def forward(self, x) -> torch.Tensor:
        """Full forward; output mapped [-1,1] -> [0,1], shape [B,3,H,W]."""

    @abstractmethod
    def partial_forward(self, x, layer_name: str) -> None:
        """Run only up to ``layer_name`` (activations land in ``self.inst``)."""

    @abstractmethod
    def sample_latent(self, n_samples: int = 1, seed=None) -> torch.Tensor:
        """Seeded host-side latent sampling (see ``ganspace_tpu_torch.sampling``)."""

    @abstractmethod
    def tap_names(self) -> Tuple[str, ...]:
        """Canonical tap points in execution order."""

    @abstractmethod
    def _gaussian_latent_dim(self) -> int:
        """Dim of the raw host gaussian behind ``sample_latent``."""

    @abstractmethod
    def _latents_from_gaussian(self, z: torch.Tensor) -> torch.Tensor:
        """Device transform of the raw gaussian draw (the mapping in W mode)."""

    # -- defaults (reference wrappers.py:49-94) -----------------------------
    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def seed_host_rng(self, seed: Optional[int]) -> None:
        """Restart the host seed stream (the JAX package's ``np.random.seed``)."""
        self.host_rng = SeedStream(seed)

    def get_max_latents(self) -> int:
        return 1

    def latent_space_name(self) -> str:
        return "Z"

    def get_latent_shape(self) -> Tuple[int, ...]:
        # Cached per latent space, as in the JAX package; the probe draws
        # one seed from host_rng, which keeps the two seed streams aligned.
        key = (self.latent_space_name(), self.outclass)
        if key not in self._latent_shape_cache:
            self._latent_shape_cache[key] = tuple(self.sample_latent(1).shape)
        return self._latent_shape_cache[key]

    def get_latent_dims(self) -> int:
        return int(np.prod(self.get_latent_shape()))

    def set_output_class(self, new_class):
        self.outclass = new_class

    @torch.no_grad()
    def sample_np(self, z=None, n_samples: int = 1, seed=None,
                  uint8: bool = False) -> np.ndarray:
        """Generate images, return clipped HWC numpy in [0,1] (squeezed);
        ``uint8=True`` quantizes on the device before the copy to the host."""
        if z is None:
            z = self.sample_latent(n_samples, seed=seed)
        img = self.forward(z)
        if uint8:
            return uint8_nhwc(img).squeeze()
        img_np = img.permute(0, 2, 3, 1).cpu().numpy()
        return np.clip(img_np, 0.0, 1.0).squeeze()

    @torch.no_grad()
    def sample_latents_prefetched(self, n_batches: int, batch_size: int, keep_on=None):
        """``n_batches`` seedless ``sample_latent(batch_size)`` calls: all
        seeds are drawn from ``host_rng`` first, in the same order, so the
        stream does not depend on later host draws.  Each batch is mapped on
        the model's device and then kept on ``keep_on`` (default: there), so
        with ``keep_on="cpu"`` the device holds one batch at a time."""
        dim = self._gaussian_latent_dim()
        seeds = [self.host_rng.next_seed() for _ in range(n_batches)]
        return [self._latents_from_gaussian(torch.from_numpy(
                    gaussian_latents(batch_size, dim, s)).to(self.device)).to(
                        keep_on or self.device)
                for s in seeds]

    # -- device streams (ganspace_tpu/models/base.py:225-274, 313-334) ------
    def device_latents_fn(self):
        """``fn(gen, n) -> latents [n, ...]`` in the primary latent space: a
        gaussian drawn on ``gen`` (a generator on the model's device), then
        ``_latents_from_gaussian`` (the mapping in W mode).  None when the
        model has no gaussian latent stream."""
        dim = self._gaussian_latent_dim()
        if dim is None:
            return None
        return lambda gen, n: self._latents_from_gaussian(device_gaussian(gen, n, dim))

    @torch.no_grad()
    def sample_latents_device(self, n_batches: int, batch_size: int, seed: int):
        """The pre-sampled device stream: batch ``i`` is block ``i`` of the
        main stream under ``seed``, drawn and mapped on the model's device
        (zero host-to-device latent traffic).  None when the model has no
        device sampler; the caller then draws on the host."""
        fn = self.device_latents_fn()
        if fn is None:
            return None
        return [fn(block_generator(seed, STREAM_MAIN, i, self.device), batch_size)
                for i in range(n_batches)]

    def pure_acts_fn(self, layer_name: str):
        """``fn(latents) -> activations [n, -1]`` at the tap, with no
        instrumentation and no edits (the fused activation stream's block),
        or None when the model has no such path."""
        return None

    # -- instrumentation plumbing ------------------------------------------
    def _instrumentation(self):
        """(retain tuple, edits dict, after-run callback) from the wrapper."""
        if self.inst is None:
            return (), {}, None
        return self.inst._retain_tuple(), self.inst._edit_tree(), self.inst._store_retained

    def resolve_tap(self, layer_name: str) -> str:
        return canonical_tap(self.tap_names(), layer_name)


class InstrumentedModel:
    """Host-side retention/edit state, API-compatible with the reference
    ``nethook.InstrumentedModel`` where the pipeline uses it."""

    def __init__(self, model: BaseGenerator):
        self.model = model
        model.inst = self
        self._retained: Dict[str, Optional[torch.Tensor]] = {}
        self._edits: Dict[str, Dict[str, np.ndarray]] = {}
        self.feature_shape: Dict[str, Tuple[int, ...]] = {}
        self.input_shape: Optional[Tuple[int, ...]] = None

    # -- retention ----------------------------------------------------------
    def retain_layer(self, layername: str):
        self.retain_layers([layername])

    def retain_layers(self, layernames):
        for name in layernames:
            self.model.resolve_tap(name)  # validate
            self._retained.setdefault(name, None)

    def stop_retaining_layers(self, layernames):
        for name in layernames:
            self._retained.pop(name, None)

    def retained_features(self) -> Dict[str, Optional[torch.Tensor]]:
        return dict(self._retained)

    def retained_layer(self, aka=None, clear=False):
        if aka is None:
            aka = next(iter(self._retained))
        result = self._retained[aka]
        if clear:
            self._retained[aka] = None
        return result

    # -- edits --------------------------------------------------------------
    def edit_layer(self, layername: str, ablation=None, replacement=None, offset=None):
        self.model.resolve_tap(layername)  # validate
        if ablation is None and replacement is not None:
            ablation = 1.0
        e = self._edits.setdefault(layername, {})
        if ablation is not None:
            e["ablation"] = ablation
        if replacement is not None:
            e["replacement"] = replacement
        if offset is not None:
            e["offset"] = offset

    def remove_edits(self, layername=None, remove_offset=True, remove_replacement=True):
        names = [layername] if layername is not None else list(self._edits)
        for name in names:
            e = self._edits.get(name)
            if e is None:
                continue
            if remove_replacement:
                e.pop("ablation", None)
                e.pop("replacement", None)
            if remove_offset:
                e.pop("offset", None)
            if not e:
                del self._edits[name]

    def close(self):
        """The reference unhooks everything; here: clear all state."""
        self._retained.clear()
        self._edits.clear()

    # -- model-facing -------------------------------------------------------
    def _retain_tuple(self) -> Tuple[str, ...]:
        return tuple(sorted({self.model.resolve_tap(n) for n in self._retained}))

    def _edit_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        device = self.model.device
        return {
            self.model.resolve_tap(name): {
                k: torch.as_tensor(v, dtype=torch.float32, device=device)
                for k, v in e.items()}
            for name, e in self._edits.items() if e
        }

    def _store_retained(self, tap_outputs: Dict[str, torch.Tensor]):
        for user_name in self._retained:
            canon = self.model.resolve_tap(user_name)
            if canon in tap_outputs:
                self._retained[user_name] = tap_outputs[canon]
