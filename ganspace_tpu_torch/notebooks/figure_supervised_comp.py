"""PCA directions vs supervised (InterFaceGAN-style) directions
(``notebooks/figure_supervised_comp.py``, reference
``notebooks/figure_supervised_comp.ipynb``: cosine-similarity of each
supervised attribute direction against the PCA basis, plus side-by-side
edit strips).

The reference ships the supervised directions as ``.npy`` files under
``notebooks/data/interfacegan/``; pass ``--data DIR`` pointing at such files
(named ``*.npy``, each [1, latent_dims] or [latent_dims]).  Without ``--data``
the script demonstrates the comparison with synthetic "supervised" directions
(a PC mixed with noise), which exercises the identical analysis path.

    python -m ganspace_tpu_torch.notebooks.figure_supervised_comp --tiny --device cpu
"""

import sys
from pathlib import Path

import numpy as np

from ganspace_tpu_torch.notebooks.notebook_init import (create_strip, figure_main, parse_args,
                                                       save_figure_grid, setup)


def load_supervised(data_dir, dims):
    dirs = {}
    for f in sorted(Path(data_dir).glob("*.npy")):
        v = np.load(f).reshape(-1)[:dims].astype(np.float32)
        dirs[f.stem] = v / np.linalg.norm(v)
    return dirs


def synthetic_supervised(t, dims, seed=4):
    rs = np.random.RandomState(seed)
    lat_comp = t.lat_comp.reshape(t.lat_comp.shape[0], -1)
    out = {}
    for name, pc, noise in (("attr_a", 0, 0.3), ("attr_b", 1, 0.5),
                            ("attr_c", 2, 0.8)):
        g = rs.randn(dims)
        g /= np.linalg.norm(g)
        v = lat_comp[pc] / np.linalg.norm(lat_comp[pc]) + noise * g
        out[name] = (v / np.linalg.norm(v)).astype(np.float32)
    return out


@figure_main
def main(argv=None):
    data_dir = None
    argv_rest = []
    it = iter(argv or sys.argv[1:])
    for a in it:
        if a == "--data":
            data_dir = next(it)
        elif a.startswith("--data="):
            data_dir = a.split("=", 1)[1]
        else:
            argv_rest.append(a)

    args = parse_args(argv_rest, model="StyleGAN2", layer="style",
                      components=8)
    ns = setup(args, use_w=True)
    model, inst, t = ns.model, ns.inst, ns.comps
    dims = model.get_latent_dims()

    sup = load_supervised(data_dir, dims) if data_dir \
        else synthetic_supervised(t, dims)
    lat_comp = t.lat_comp.reshape(-1, dims)
    lat_comp_n = lat_comp / np.linalg.norm(lat_comp, axis=1, keepdims=True)

    # Cosine-similarity table: supervised direction x PCA component
    print(f"{'direction':>12} | best PC | cos")
    report = {}
    for name, v in sup.items():
        cos = np.abs(lat_comp_n @ v)
        best = int(np.argmax(cos))
        report[name] = (best, float(cos[best]))
        print(f"{name:>12} | PC{best:<5} | {cos[best]:.3f}")

    # Side-by-side strips: supervised direction vs its best-matching PC
    z = model.sample_latent(1, seed=1)
    max_lat = model.get_max_latents()
    rows = []
    for name, v in sup.items():
        best, _ = report[name]
        rows.append(create_strip(inst, "latent", args.layer, [z], 0,
                                 v.reshape(t.lat_comp[0].shape),
                                 0, t.lat_stdev[best], 2.0, 0, max_lat,
                                 num_frames=5)[0])
        rows.append(create_strip(inst, "latent", args.layer, [z], 0,
                                 t.lat_comp[best], 0, t.lat_stdev[best], 2.0,
                                 0, max_lat, num_frames=5)[0])
    return save_figure_grid(rows, ns.outdir / "supervised_comp.png")


if __name__ == "__main__":
    main()
