"""State-dict adapters: a copy of ``ganspace_tpu/utils/statedict.py`` (host
code; the port imports nothing of the JAX package), reference
``netdissect/statedict.py``.

Convert between nested parameter trees (dicts and lists of arrays or
tensors) and flat numpy dicts for serialization, plus npz save and load.
The npz layout is the JAX package's, so either package reads the other's
files.  A leaf may be a torch tensor on any device: it is copied to the
host (``np.asarray`` cannot read a CUDA tensor).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np


def _to_numpy(leaf) -> np.ndarray:
    """A tensor (any device, grad or not) or array-like as a host array."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_tree(tree: Any, prefix: str = "", sep: str = ".") -> Dict[str, np.ndarray]:
    """Nested dict/list tree -> flat {dotted.name: numpy array}."""
    out: Dict[str, np.ndarray] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}{sep}{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}{sep}{i}" if path else str(i))
        else:
            out[path] = _to_numpy(node)

    rec(tree, prefix)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray], sep: str = ".") -> Dict[str, Any]:
    """Inverse of :func:`flatten_tree` (lists come back as dicts keyed by
    their stringified index — param consumers address by name anyway)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def save_state_dict(path, tree: Any) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flatten_tree(tree))
    return path


def load_state_dict(path, nested: bool = False):
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten_tree(flat) if nested else flat


def numpy_state_dict(torch_state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """torch ``state_dict`` (tensors) -> numpy dict (reference statedict's
    torch<->numpy adapters)."""
    return {k: _to_numpy(v) for k, v in torch_state.items()}
