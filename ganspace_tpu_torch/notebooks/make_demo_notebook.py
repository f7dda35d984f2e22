"""Build (and optionally execute) ``Ganspace_torch.ipynb``: the port of
``notebooks/make_demo_notebook.py``, the interactive-notebook equivalent of
the reference's ``Ganspace_colab.ipynb``: discover components, apply
layer-windowed edits, export a named direction and register a custom
generator, all through the port's public API.

The notebook is generated from this script so it stays in sync with the
API.  ``--execute`` runs it headless (nbclient) and saves the outputs in
place; ``--device`` (``cuda`` by default) reaches the notebook's setup cell
as ``GANSPACE_DEVICE``.  ``nbformat`` and ``nbclient`` are imported only
when a notebook is built, so the module imports without them.

    python -m ganspace_tpu_torch.notebooks.make_demo_notebook [--execute] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

MD = [
    # --- 0: header -----------------------------------------------------------
    """# GANSpace in PyTorch — end-to-end walkthrough

Notebook equivalent of the reference's ``Ganspace_colab.ipynb``, on the
PyTorch + CUDA port (``ganspace_tpu_torch``): discover interpretable GAN
controls with PCA on internal activations, apply them as layer-windowed
edits, export named directions, and bring your own generator.

Everything below runs **offline**: without checkpoints the models use seeded
random initialization (drop reference-format checkpoints into
``$GANCONTROL_CHECKPOINT_DIR`` for real imagery).  The calls run on the GPU
(``cuda``) unless ``GANSPACE_DEVICE`` names another device.  The outputs
committed with this notebook come from a run on the CPU
(``python -m ganspace_tpu_torch.notebooks.make_demo_notebook --execute
--device cpu``); the tiny sample counts keep that run to about a minute.""",
    # --- 1 -------------------------------------------------------------------
    """## 1. Discover components

``get_or_compute`` is the whole pipeline: sample latents → run the generator
*up to* the chosen layer (``partial_forward`` stops at the tap) → stream
activations through an estimator → regress components back to latent space
→ cache as an ``.npz`` (reference-compatible keys and filename).""",
    # --- 2 -------------------------------------------------------------------
    """## 2. Apply edits

``create_strip_centered`` applies component ``i`` over a latent-layer window:
the sample is first projected onto the component and re-centered, then walked
``±sigma`` standard deviations (reference ``notebook_utils.py:68-81``).""",
    # --- 3 -------------------------------------------------------------------
    """## 3. Export a named direction

Directions are ``.pkl`` files with full provenance (model, estimator, layer
window, σ-range — reference ``interactive.py:526-578``); the interactive
viewer (``python -m ganspace_tpu_torch.apps.interactive ... --inputs <dir>``)
loads them back.""",
    # --- 4 -------------------------------------------------------------------
    """## 4. Bring your own generator

A custom model is an ``nn.Module`` subclass of ``BaseGenerator`` whose
synthesis passes each stage through a tap, registered by name — no
framework-source edits (the reference requires patching ``get_model``).
``ganspace_tpu_torch/examples/custom_model.py`` is the complete walkthrough;
here we just register and drive it.""",
    # --- 5 -------------------------------------------------------------------
    """## Where to next

* batch rendering and sweep videos: ``python -m ganspace_tpu_torch.apps.visualize``
* live sliders / layer windows: ``python -m ganspace_tpu_torch.apps.interactive``
* unit dissection vs segmentation: ``python -m ganspace_tpu_torch.dissection``
* reproduction of the paper figures: ``python -m ganspace_tpu_torch.notebooks.run_all``""",
]

CODE = [
    # --- setup (goes after MD[0]) -------------------------------------------
    """import os, sys, tempfile
from pathlib import Path

root = next(p for p in (Path.cwd(), *Path.cwd().parents)
            if (p / "ganspace_tpu_torch").is_dir())
sys.path.insert(0, str(root))
os.environ.setdefault("GANSPACE_OUTPUT_DIR",
                      tempfile.mkdtemp(prefix="ganspace_demo_"))
DEVICE = os.environ.get("GANSPACE_DEVICE", "cuda")

import numpy as np
import matplotlib.pyplot as plt

from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.models import get_instrumented_model
print("device:", DEVICE)""",
    # --- 1: decomposition ----------------------------------------------------
    """inst = get_instrumented_model("DCGAN", None, "deconv1", device=DEVICE)
config = Config(model="DCGAN", layer="deconv1", estimator="ipca",
                components=6, n=512, batch_size=64, device=DEVICE)
npz_path = get_or_compute(config, inst)
data = np.load(npz_path)
print(npz_path.name)
print("explained variance ratio:", np.round(data["var_ratio"], 3))""",
    # --- 2: edits ------------------------------------------------------------
    """from ganspace_tpu_torch.edit import create_strip_centered

n_show, n_frames = 3, 7
z = inst.model.sample_latent(1, seed=3)
strips = [create_strip_centered(            # one component per call
    inst, "latent", "deconv1", [z],
    data["act_comp"][c], data["lat_comp"][c],
    data["act_stdev"][c], data["lat_stdev"][c],
    data["act_mean"], data["lat_mean"],
    sigma=2.0, layer_start=0, layer_end=inst.model.get_max_latents(),
    num_frames=n_frames)[0] for c in range(n_show)]

fig, axes = plt.subplots(n_show, 1, figsize=(2 * n_frames, 2 * n_show))
for c, ax in enumerate(np.atleast_1d(axes)):
    ax.imshow(np.clip(np.hstack([np.asarray(f) for f in strips[c]]), 0, 1))
    ax.set_ylabel(f"component {c}")
    ax.set_xticks([]); ax.set_yticks([])
fig.suptitle("component sweeps, -2\\u03c3 .. +2\\u03c3 (random-init model)")
plt.show()""",
    # --- 3: direction export -------------------------------------------------
    """from ganspace_tpu_torch.directions import (direction_params, export_direction,
                                           load_named_components)

params = direction_params(
    name="demo direction", sigma_range=2.0, component_index=0,
    act_comp=data["act_comp"][0], lat_comp=data["lat_comp"][0],
    latent_space=inst.model.latent_space_name(),
    act_stdev=data["act_stdev"][0], lat_stdev=data["lat_stdev"][0],
    model_name="DCGAN", output_class="None", estimator="ipca",
    components=6, samples=512, layer="deconv1", component_class="None",
    edit_type="latent", truncation=1.0, edit_start=0,
    edit_end=inst.model.get_max_latents(), example_seed=3)
direction_dir = Path(os.environ["GANSPACE_OUTPUT_DIR"]) / "out" / "directions"
pkl = export_direction(params, direction_dir)
print("exported:", pkl.name)
print("reloaded:", [d["name"] for d in
                    load_named_components(direction_dir, "DCGAN", "None")])""",
    # --- 4: custom model -----------------------------------------------------
    """from ganspace_tpu_torch.examples import custom_model as custom
from ganspace_tpu_torch.models import register_model, unregister_model

register_model("ToyGAN", custom.ToyGenerator)
try:
    toy = get_instrumented_model("ToyGAN", None, "fc2", device=DEVICE)
    toy_cfg = Config(model="ToyGAN", layer="fc2", estimator="ipca",
                     components=4, n=256, batch_size=64, device=DEVICE)
    toy_npz = np.load(get_or_compute(toy_cfg, toy))
    img = toy.model.sample_np(toy.model.sample_latent(1, seed=1))
    plt.figure(figsize=(2, 2)); plt.imshow(np.clip(img, 0, 1))
    plt.title("ToyGAN sample"); plt.xticks([]); plt.yticks([]); plt.show()
    print("ToyGAN var_ratio:", np.round(toy_npz["var_ratio"], 3))
finally:
    unregister_model("ToyGAN")""",
]


def build():
    """The notebook, unexecuted: MD[0], the setup cell, then each section's
    markdown and code, then MD[5]."""
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {"name": "python3",
                                 "display_name": "Python 3",
                                 "language": "python"}
    cells = [nbf.v4.new_markdown_cell(MD[0]),
             nbf.v4.new_code_cell(CODE[0])]
    for md, code in zip(MD[1:5], CODE[1:]):
        cells.append(nbf.v4.new_markdown_cell(md))
        cells.append(nbf.v4.new_code_cell(code))
    cells.append(nbf.v4.new_markdown_cell(MD[5]))
    nb.cells = cells
    return nb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ganspace_tpu_torch.notebooks.make_demo_notebook")
    ap.add_argument("--execute", action="store_true",
                    help="run the notebook headless and save outputs")
    ap.add_argument("--device", default="cuda",
                    help="the notebook's device (GANSPACE_DEVICE): cuda | cpu")
    ap.add_argument("--out", default=str(HERE / "Ganspace_torch.ipynb"))
    args = ap.parse_args(argv)

    import nbformat as nbf

    nb = build()
    if args.execute:
        from nbclient import NotebookClient

        # the kernel inherits this process's environment
        os.environ["GANSPACE_DEVICE"] = args.device
        client = NotebookClient(nb, timeout=1200,
                                resources={"metadata": {"path": str(HERE)}})
        client.execute()
        # stderr holds the run's diagnostics (random-initialization notes
        # naming the host's checkpoint paths, progress lines): not kept
        for cell in nb.cells:
            if cell.cell_type == "code":
                cell.outputs = [o for o in cell.outputs if o.get("name") != "stderr"]
    nbf.write(nb, args.out)
    print(f"wrote {args.out}" + (" (executed)" if args.execute else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
