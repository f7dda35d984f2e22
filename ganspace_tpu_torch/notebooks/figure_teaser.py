"""Teaser figure: a sequence of edits applied cumulatively to one sample
(``notebooks/figure_teaser.py``, reference ``notebooks/figure_teaser.ipynb``:
project the latent onto a PC, move it to a target coordinate, repeat for
each edit in the chain).

    python -m ganspace_tpu_torch.notebooks.figure_teaser --tiny --device cpu
"""

import numpy as np

from ganspace_tpu_torch.notebooks.notebook_init import (figure_main, parse_args,
                                                       save_figure_grid, setup)

# (component idx, layer start, layer end, target strength, invert)
EDITS = [
    ("edit0", (0, 0, 5, 2.0, True)),
    ("edit1", (1, 2, 6, 8.0, False)),
    ("edit2", (2, 4, 8, -8.0, False)),
]


def perform_edit_chain(ns, seed: int, edits):
    """The frames of one chain: the sample, then one frame after each edit.
    The W+ latents stay on the host as numpy arrays, as in the JAX script."""
    model = ns.model
    lat_comp = ns.comps.lat_comp
    lat_mean = ns.comps.lat_mean
    lat_std = ns.comps.lat_stdev
    max_lat = model.get_max_latents()

    w0 = model.sample_latent(1, seed=seed).cpu().numpy()
    w = [w0.copy() for _ in range(max_lat)]
    frames = [ns.model.sample_np(list(w))]

    for idx, start, end, strength, invert in edits:
        # current coordinate along the PC (reference: w_coord)
        w_centered = w[0] - lat_mean
        coord = float(np.sum(w_centered.reshape(-1) * lat_comp[idx].reshape(-1))
                      / lat_std[idx])
        if invert:
            target = -np.sign(coord) * abs(strength)
        else:
            target = strength
        delta = target - coord
        end = min(end, max_lat)
        for l in range(start, end):
            w[l] = w[l] + lat_comp[idx].reshape(w[l].shape) * lat_std[idx] * delta
        frames.append(model.sample_np(list(w)))
    return frames


def chain_edits(components: int):
    """The edits of each chain: the first min(3, c) of ``EDITS``."""
    return [e for _, e in EDITS[:min(3, components)]]


@figure_main
def main(argv=None):
    args = parse_args(argv, model="StyleGAN2", layer="style", components=8)
    ns = setup(args, use_w=True)
    edits = chain_edits(args.components)
    rows = [perform_edit_chain(ns, seed, edits) for seed in (5, 11)]
    return save_figure_grid(rows, ns.outdir / "teaser.png")


if __name__ == "__main__":
    main()
