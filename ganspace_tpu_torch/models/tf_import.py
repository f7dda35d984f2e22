"""The NVlabs StyleGAN pickle, read without TensorFlow (the StyleGAN half
of ``ganspace_tpu/models/tf_import.py``).

NVlabs pickles store every variable as a plain numpy array inside the
``Network.__getstate__`` dict (keys ``name`` / ``static_kwargs`` /
``variables`` / optional ``components``), so a restricted unpickler that
stubs the ``dnnlib``/``tfutil`` classes recovers the full ``{var_name:
ndarray}`` mapping offline.  :func:`import_stylegan_tf` translates the
generator's names and layouts into the flat parameter dict that
``StyleGAN.params_from_jax`` loads (reference
``models/stylegan/model.py:395-456``).  The ProGAN and BigGAN importers
come with their model families.
"""

from __future__ import annotations

import io
import pickle
from typing import Dict, List

import numpy as np

# ---------------------------------------------------------------------------
# Restricted NVlabs-pickle reader
# ---------------------------------------------------------------------------


class _TFNetworkStub:
    """Stand-in for ``dnnlib.tflib.network.Network`` / ``tfutil.Network``.

    Both classes define ``__getstate__`` returning a plain dict (version,
    name, static_kwargs, build source, and ``variables`` as a list of
    ``(name, np.ndarray)``), so unpickling only needs a state sink.
    """

    state: dict

    def __setstate__(self, state):
        self.state = dict(state)


class _StubContainer(dict):
    """Stand-in for EasyDict and other dict-like dnnlib helpers."""


_STUBBED_ROOTS = ("dnnlib", "tfutil", "config", "util", "training",
                  "torch_utils", "legacy")


class _TFUnpickler(pickle.Unpickler):
    """Unpickler that maps NVlabs framework classes to local stubs.

    Anything under the stubbed module roots resolves to a stub (Network ->
    state sink, everything else -> dict-like); numpy/collections resolve
    normally.  Arbitrary other globals are refused — these files are
    untrusted input.
    """

    _SAFE_MODULES = ("numpy", "collections", "builtins", "copyreg",
                     "_codecs")

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _STUBBED_ROOTS:
            return _TFNetworkStub if name == "Network" else _StubContainer
        if root in self._SAFE_MODULES or module.startswith("numpy"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from a TF-era checkpoint")


def _flatten_network(net: _TFNetworkStub) -> Dict[str, np.ndarray]:
    """Variables of a Network plus its components, fully prefixed.

    Composite networks (StyleGAN1 ``Gs`` = mapping + synthesis) keep each
    component's variables under the component's *network name* scope, which
    is what the live ``trainables`` view the reference iterates exposes
    (reference ``model.py:404``: keys like ``G_synthesis/4x4/Conv/weight``).
    """
    out: Dict[str, np.ndarray] = {}
    state = net.state
    for name, value in state.get("variables", []):
        out[str(name)] = np.asarray(value)
    components = state.get("components") or {}
    for comp in components.values():
        if not isinstance(comp, _TFNetworkStub):
            continue
        cname = str(comp.state.get("name", ""))
        for name, value in comp.state.get("variables", []):
            out[f"{cname}/{name}"] = np.asarray(value)
    return out


def read_tf_networks(path_or_bytes) -> List[Dict[str, np.ndarray]]:
    """All Network var-dicts in an NVlabs pickle, in file order.

    StyleGAN/ProGAN training pickles hold ``(G, D, Gs)``; the
    exponential-moving-average generator ``Gs`` is the last entry
    (reference ``model.py:400-406`` uses ``weights[2]``).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, "rb")
    with f:
        data = _TFUnpickler(f, encoding="latin1").load()
    nets = list(data) if isinstance(data, (list, tuple)) else [data]
    return [_flatten_network(n) for n in nets if isinstance(n, _TFNetworkStub)]


def _tf_vars(src) -> Dict[str, np.ndarray]:
    """Accept a path / pickle bytes / pre-extracted {name: array} mapping."""
    if isinstance(src, dict):
        return {k: np.asarray(v) for k, v in src.items()}
    nets = read_tf_networks(src)
    if not nets:
        raise ValueError("no NVlabs Network objects found in TF checkpoint")
    return nets[-1]  # Gs


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


# ---------------------------------------------------------------------------
# StyleGAN1 (karras2019 dnnlib pickle)
# ---------------------------------------------------------------------------

_SG1_RENAMES = (
    ("const.const", "const"),
    ("const.bias", "bias"),
    ("const.stylemod", "epi1.style_mod.lin"),
    ("const.noise.weight", "epi1.top_epi.noise.weight"),
    ("conv.noise.weight", "epi2.top_epi.noise.weight"),
    ("conv.stylemod", "epi2.style_mod.lin"),
    ("conv0_up.noise.weight", "epi1.top_epi.noise.weight"),
    ("conv0_up.stylemod", "epi1.style_mod.lin"),
    ("conv1.noise.weight", "epi2.top_epi.noise.weight"),
    ("conv1.stylemod", "epi2.style_mod.lin"),
    ("torgb_lod0", "torgb"),
)


def _sg1_key(tf_name: str) -> str:
    """TF var name -> lernapparat/param name (reference model.py:406-424)."""
    parts = tf_name.lower().split("/")
    if parts[0] == "g_synthesis" and not parts[1].startswith("torgb"):
        parts.insert(1, "blocks")
    key = ".".join(parts)
    if key.startswith("g_synthesis"):
        for old, new in _SG1_RENAMES:
            key = key.replace(old, new)
    return key


def import_stylegan_tf(src) -> Dict[str, np.ndarray]:
    """NVlabs StyleGAN1 pickle (or var mapping) -> flat SG1 params.

    Mirrors the reference's ``export_from_tf`` name/weight translation
    (``models/stylegan/model.py:406-441``): lowercase dotted names, dense
    weights transposed [in,out]->[out,in], conv weights HWIO->OIHW, LOD>0
    toRGB heads and non-model variables dropped.
    """
    params: Dict[str, np.ndarray] = {}
    for tf_name, value in _tf_vars(src).items():
        key = _sg1_key(tf_name)
        # Fixed noise inputs / sampling-time state, rebuilt locally.  They
        # live either at network scope ('lod', 'noise0') or inside the
        # G_synthesis component scope ('g_synthesis.blocks.noise0') — match
        # on the LEAF name so the per-channel noise WEIGHTS
        # ('...top_epi.noise.weight') are kept.
        leaf = key.rsplit(".", 1)[-1]
        if ("torgb_lod" in key or leaf in ("lod", "dlatent_avg")
                or leaf.startswith("noise")):
            continue
        v = _f32(value)
        if key.endswith(".weight"):
            if v.ndim == 2:
                v = _f32(v.T)
            elif v.ndim == 4:
                v = _f32(v.transpose(3, 2, 0, 1))
        params[key] = v
    return params
