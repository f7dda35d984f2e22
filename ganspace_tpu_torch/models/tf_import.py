"""TF-era checkpoints read without TensorFlow: the NVlabs StyleGAN and
ProGAN pickles and BigGAN's TF-Hub variable set
(``ganspace_tpu/models/tf_import.py``).

NVlabs pickles store every variable as a plain numpy array inside the
``Network.__getstate__`` dict (keys ``name`` / ``static_kwargs`` /
``variables`` / optional ``components``), so a restricted unpickler that
stubs the ``dnnlib``/``tfutil`` classes recovers the full ``{var_name:
ndarray}`` mapping offline.  :func:`import_stylegan_tf` translates the
generator's names and layouts into the flat parameter dict that
``StyleGAN.params_from_jax`` loads (reference
``models/stylegan/model.py:395-456``).  BigGAN's TF-Hub weights are taken
as any ``{tf_var_name: ndarray}`` mapping or an ``.npz`` of one (dumped once
with ``tf.train.load_checkpoint`` where TF is installed): the name map and
all tensor munging of the reference's converter live in
:func:`import_biggan_tf`.  :func:`import_progan_tf` converts the karras2018
ProGAN pickle, and :func:`import_progan_old_pt` the old PyTorch naming, into
GANDissect's names (reference ``netdissect/proggan.py:216-298``).
"""

from __future__ import annotations

import io
import pickle
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ganspace_tpu_torch.models.torch_import import import_progan


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


# ---------------------------------------------------------------------------
# ProGAN (karras2018 tfutil pickle + "old pytorch" naming)
# ---------------------------------------------------------------------------

def import_progan_tf(src) -> Tuple[Dict[str, np.ndarray], Tuple[int, ...]]:
    """TF ProGAN variables -> (GANDissect-named params, channel schedule).

    The name walk and weight munging of reference ``proggan.py:216-269``:
    ``4x4/Dense`` becomes a flipped 4x4 conv, the ``Conv0_up`` transposed-conv
    weights become flipped convs, ``ToRGB_lod0`` the output block."""
    tf = _tf_vars(src)
    state: Dict[str, np.ndarray] = {}
    i = 0
    while True:
        res = 4 * (2 ** (i // 2))
        tf_layer = "%dx%d/%s" % (res, res, "Dense" if i == 0 else "Conv" if i == 1
                                 else "Conv0_up" if i % 2 == 0 else "Conv1")
        if f"{tf_layer}/weight" not in tf:
            break
        w = _f32(tf[f"{tf_layer}/weight"])
        if i == 0:
            # dense [z, ch * 16] -> conv [ch, z, 4, 4], spatially flipped
            w = w.reshape(w.shape[0], w.shape[1] // 16, 4, 4)
            w = _f32(w.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1])
        elif i % 2 == 0:
            # transposed conv [kh, kw, out, in] -> conv [out, in, kh, kw], flipped
            w = _f32(w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        else:
            w = _f32(w.transpose(3, 2, 0, 1))  # HWIO -> OIHW
        state[f"layer{i + 1}.conv.weight"] = w
        state[f"layer{i + 1}.wscale.b"] = _f32(tf[f"{tf_layer}/bias"])
        i += 1
    if i == 0:
        raise ValueError("no ProGAN layers found in TF checkpoint")
    res = 4 * (2 ** ((i - 1) // 2))
    out = f"output_{res}x{res}"
    state[f"{out}.conv.weight"] = _f32(tf["ToRGB_lod0/weight"].transpose(3, 2, 0, 1))
    state[f"{out}.wscale.b"] = _f32(tf["ToRGB_lod0/bias"])
    return import_progan(state)


def import_progan_old_pt(state) -> Tuple[Dict[str, np.ndarray], Tuple[int, ...]]:
    """The old PyTorch ProGAN naming (``features.N.*`` and ``output.*``) ->
    (GANDissect-named params, channel schedule).  Reference
    ``proggan.py:271-298``."""
    src = {k: _f32(v if isinstance(v, np.ndarray) else v.detach().cpu().numpy())
           for k, v in state.items()}
    out: Dict[str, np.ndarray] = {}
    i = 0
    while f"features.{i}.conv.weight" in src:
        out[f"layer{i + 1}.conv.weight"] = src[f"features.{i}.conv.weight"]
        out[f"layer{i + 1}.wscale.b"] = src[f"features.{i}.wscale.b"]
        i += 1
    if i == 0:
        raise ValueError("no ProGAN layers found in old-pt state dict")
    res = 4 * (2 ** ((i - 1) // 2))
    out[f"output_{res}x{res}.conv.weight"] = src["output.conv.weight"]
    out[f"output_{res}x{res}.wscale.b"] = src["output.wscale.b"]
    return import_progan(out)


# ---------------------------------------------------------------------------
# BigGAN (TF-Hub variable set)
# ---------------------------------------------------------------------------

_EMA = "ema_0.9999"


def bake_spectral_norm_tf(w: np.ndarray, u0: np.ndarray,
                          eps: float = 1e-4) -> np.ndarray:
    """Bake SN from a TF ``u0`` with the converter's exact arithmetic.

    The reference conversion seeds torch's buffers with one power-iteration
    step from ``u0`` (``convert_tf_to_pytorch.py:169-183``): ``v =
    normalize(W^T u0)``, ``u = normalize(W v)``; torch eval then divides by
    ``sigma = u^T W v = |W v|``.  Collapsed to a single division here.
    """
    w_mat = w.reshape(w.shape[0], -1)
    v = w_mat.T @ u0
    v = v / max(float(np.linalg.norm(v)), eps)
    sigma = float(np.linalg.norm(w_mat @ v))
    return _f32(w / sigma)


def _biggan_config_for_vars(tf: Dict[str, np.ndarray]):
    from ganspace_tpu_torch.models.biggan import BigGANConfig
    n_blocks = 1 + max((int(m.group(1))
                        for k in tf
                        for m in [re.match(r"Generator/GBlock_(\d+)/", k)]
                        if m), default=0)
    resolution = {10: 128, 12: 256, 14: 512}.get(n_blocks)
    if resolution is None:
        raise ValueError(f"unrecognized BigGAN depth: {n_blocks} GBlocks")
    return BigGANConfig.for_resolution(resolution)


def import_biggan_tf(src, cfg=None,
                     batch_stats: Optional[Sequence[np.ndarray]] = None
                     ) -> Dict[str, np.ndarray]:
    """TF-Hub BigGAN vars -> flat params with spectral norm baked.

    ``src``: ``{tf_var_name: ndarray}`` or the ``.npz`` path of one.  The
    name map mirrors reference ``convert_tf_to_pytorch.py:60-116``; the
    tensor munging ``:149-160`` (2-D transposed, 4-D HWIO->OIHW, 1-D
    squeezed).  ``batch_stats``: the 51-point truncation-sweep BN statistics
    in the reference's extraction order (means/vars interleaved per BN,
    ``:186-216``), else bundled in ``src`` as ``stats_0, stats_1, ...``;
    zeros/ones are substituted when absent.
    """
    if isinstance(src, (str, bytes)) or hasattr(src, "__fspath__"):
        with np.load(src) as z:
            tf = {k: np.asarray(z[k]) for k in z.files}
    else:
        tf = {k: np.asarray(v) for k, v in src.items()}
    if batch_stats is None:
        bundled = sorted((k for k in tf if re.fullmatch(r"stats_\d+", k)),
                         key=lambda k: int(k.split("_")[1]))
        if bundled:
            batch_stats = [tf.pop(k) for k in bundled]
    cfg = cfg or _biggan_config_for_vars(tf)

    params: Dict[str, np.ndarray] = {}

    def lin(tf_base: str, name: str, sn: bool = True):
        w = _f32(tf[f"{tf_base}/w/{_EMA}"].T)
        if sn:
            w = bake_spectral_norm_tf(w, np.squeeze(tf[f"{tf_base}/u0"]), cfg.eps)
        params[f"{name}.weight"] = w
        if f"{tf_base}/b/{_EMA}" in tf:
            params[f"{name}.bias"] = _f32(np.squeeze(tf[f"{tf_base}/b/{_EMA}"]))

    def conv(tf_base: str, name: str):
        w = _f32(tf[f"{tf_base}/w/{_EMA}"].transpose(3, 2, 0, 1))
        params[f"{name}.weight"] = bake_spectral_norm_tf(
            w, np.squeeze(tf[f"{tf_base}/u0"]), cfg.eps)
        if f"{tf_base}/b/{_EMA}" in tf:
            params[f"{name}.bias"] = _f32(np.squeeze(tf[f"{tf_base}/b/{_EMA}"]))

    lin("linear", "embeddings", sn=False)
    lin("Generator/GenZ/G_linear", "generator.gen_z")

    stats = list(batch_stats) if batch_stats is not None else None
    stat_i = 0

    def bn_stats(name: str, ch: int):
        nonlocal stat_i
        if stats is not None:
            params[f"{name}.running_means"] = _f32(stats[stat_i])
            params[f"{name}.running_vars"] = _f32(stats[stat_i + 1])
        else:
            params[f"{name}.running_means"] = np.zeros((cfg.n_stats, ch), np.float32)
            params[f"{name}.running_vars"] = np.ones((cfg.n_stats, ch), np.float32)
        stat_i += 2

    layer_idx = 0
    for i, (up, cin_mult, cout_mult) in enumerate(cfg.layers):
        if i == cfg.attention_layer_position:
            attn = f"generator.layers.{layer_idx}"
            tf_attn = "Generator/attention"
            params[f"{attn}.gamma"] = _f32(tf[f"{tf_attn}/gamma/{_EMA}"]).reshape(1)
            for pt_sub, tf_sub in (("snconv1x1_g", "g"),
                                   ("snconv1x1_o_conv", "o_conv"),
                                   ("snconv1x1_phi", "phi"),
                                   ("snconv1x1_theta", "theta")):
                conv(f"{tf_attn}/{tf_sub}", f"{attn}.{pt_sub}")
            layer_idx += 1
        tf_block = f"Generator/GBlock_{i}" if i > 0 else "Generator/GBlock"
        base = f"generator.layers.{layer_idx}"
        cin = cfg.channel_width * cin_mult
        mid = cin // 4
        for j, ch in enumerate((cin, mid, mid, mid)):
            tf_bn = f"{tf_block}/BatchNorm_{j}" if j > 0 else f"{tf_block}/BatchNorm"
            bn_stats(f"{base}.bn_{j}", ch)
            lin(f"{tf_bn}/scale", f"{base}.bn_{j}.scale")
            lin(f"{tf_bn}/offset", f"{base}.bn_{j}.offset")
        for j in range(4):
            conv(f"{tf_block}/conv{j}", f"{base}.conv_{j}")
        layer_idx += 1

    ch_out = cfg.channel_width * cfg.layers[-1][2]
    bn_stats("generator.bn", ch_out)
    params["generator.bn.weight"] = _f32(np.squeeze(tf[f"Generator/BatchNorm/scale/{_EMA}"]))
    params["generator.bn.bias"] = _f32(np.squeeze(tf[f"Generator/BatchNorm/offset/{_EMA}"]))
    conv("Generator/conv_to_rgb", "generator.conv_to_rgb")
    return params
