"""Named edit-direction export/import (reference ``interactive.py:88-129,
526-578``): a copy of ``ganspace_tpu/directions.py``, host numpy and
pickle, which the port cannot import (the JAX package's import runs JAX).

Directions are pickled dicts with full provenance — name, sigma range,
component vectors (activation + latent space), stdevs, model/class, the
decomposition parameters that produced them, edit type/layer window, seed —
in the exact reference schema, so ``.pkl`` files exported by either
implementation load in the other.  File identity follows the reference
naming scheme, e.g.::

    StyleGAN2-Light_direction-ffhq-ipca-w-style-comp15-range8-9.pkl
"""

from __future__ import annotations

import pickle
from os import makedirs
from pathlib import Path
from typing import List, Optional

import numpy as np

from ganspace_tpu_torch.imaging import prettify_name


def direction_params(*, name: str, sigma_range: float, component_index: int,
                     act_comp: np.ndarray, lat_comp: np.ndarray,
                     latent_space: str, act_stdev: float, lat_stdev: float,
                     model_name: str, output_class: str, estimator: str,
                     components: int, samples: int, layer: str,
                     component_class: str, edit_type: str, truncation: float,
                     edit_start: int, edit_end: int, example_seed: int) -> dict:
    """Assemble the reference provenance dict (``interactive.py:526-549``).

    ``edit_end`` is exclusive here and in the file (the reference UI shows it
    inclusive and saves ``end + 1``).
    """
    return {
        "name": name,
        "sigma_range": sigma_range,
        "component_index": component_index,
        "act_comp": np.asarray(act_comp, np.float32),
        "lat_comp": np.asarray(lat_comp, np.float32),  # either Z or W
        "latent_space": latent_space,
        "act_stdev": float(act_stdev),
        "lat_stdev": float(lat_stdev),
        "model_name": model_name,
        "output_class": output_class,            # applied onto
        "decomposition": {
            "name": estimator,
            "components": components,
            "samples": samples,
            "layer": layer,
            "class_name": component_class,       # computed from
        },
        "edit_type": edit_type,
        "truncation": float(truncation),
        "edit_start": int(edit_start),
        "edit_end": int(edit_end),
        "example_seed": int(example_seed),
    }


def direction_file_ident(params: dict) -> str:
    """Reference file-identity scheme (``interactive.py:560-570``)."""
    edit_mode_str = params["edit_type"]
    if edit_mode_str == "latent":
        edit_mode_str = params["latent_space"].lower()

    comp_class = params["decomposition"]["class_name"]
    appl_class = params["output_class"]
    if comp_class != appl_class:
        comp_class = f"{comp_class}_onto_{appl_class}"

    return "{model}-{name}-{cls}-{est}-{mode}-{layer}-comp{idx}-range{start}-{end}".format(
        model=params["model_name"],
        name=prettify_name(params["name"]),
        cls=comp_class,
        est=params["decomposition"]["name"],
        mode=edit_mode_str,
        layer=params["decomposition"]["layer"],
        idx=params["component_index"],
        start=params["edit_start"],
        end=params["edit_end"],
    )


def export_direction(params: dict, out_dir) -> Path:
    out_dir = Path(out_dir)
    file_ident = direction_file_ident(params)
    makedirs(out_dir, exist_ok=True)
    out_path = out_dir / f"{file_ident}.pkl"
    with open(out_path, "wb") as f:
        pickle.dump(params, f)
    return out_path


def load_direction(path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_named_components(directory, model_name: str, output_class: str,
                          latent_space: Optional[str] = None) -> List[dict]:
    """Load all applicable directions from a directory, filtered by model,
    class changeability and latent space (reference ``interactive.py:88-129``)."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for p in sorted(directory.glob("*.pkl")):
        try:
            d = load_direction(p)
        except Exception as e:  # corrupt/foreign pickle: skip, don't crash the UI
            print(f"Skipping {p.name}: {e}")
            continue
        if d.get("model_name") != model_name:
            continue
        # class must match unless the model supports class switching (BigGAN)
        if d.get("output_class") != output_class and "BigGAN" not in model_name:
            continue
        if latent_space is not None and d.get("latent_space") != latent_space:
            print(f"Skipping {p.name}: latent space "
                  f"{d.get('latent_space')} != {latent_space}")
            continue
        d["file"] = p
        out.append(d)
    return out
