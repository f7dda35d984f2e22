"""Style/content separation + random-basis baseline
(``notebooks/figure_style_content_sep.py``, reference
``notebooks/figure_style_content_sep.ipynb``: early-layer PC edits change
content/geometry while late-layer edits change style/appearance; PCA
directions are compared against a random orthonormal basis).

    python -m ganspace_tpu_torch.notebooks.figure_style_content_sep --tiny --device cpu
"""

import numpy as np

from ganspace_tpu_torch.notebooks.notebook_init import (create_strip, figure_main, parse_args,
                                                       save_figure_grid, setup)


def random_basis(dims: int, n: int, seed: int = 0) -> np.ndarray:
    """Random orthonormal directions (the baseline the paper compares to)."""
    rs = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rs.randn(dims, dims))
    return q.T[:n].astype(np.float32)


@figure_main
def main(argv=None):
    args = parse_args(argv, model="StyleGAN2", layer="style", components=8)
    ns = setup(args, use_w=True)
    model, inst, t = ns.model, ns.inst, ns.comps
    max_lat = model.get_max_latents()
    z = model.sample_latent(1, seed=3)
    pc = 1

    windows = [("content_early", 0, max(1, max_lat // 3)),
               ("mid", max(1, max_lat // 3), max(2, 2 * max_lat // 3)),
               ("style_late", max(2, 2 * max_lat // 3), max_lat)]
    rows = [
        create_strip(inst, "latent", args.layer, [z], 0, t.lat_comp[pc], 0,
                     t.lat_stdev[pc], 3.0, s, e, num_frames=5)[0]
        for _, s, e in windows]
    save_figure_grid(rows, ns.outdir / "style_content_sep.png")

    # Random-direction baseline: same sigma budget, random orthonormal dirs
    rand = random_basis(model.get_latent_dims(), 3, seed=9)
    rand_rows = [
        create_strip(inst, "latent", args.layer, [z],
                     0, rand[i].reshape(t.lat_comp[0].shape), 0,
                     t.lat_stdev[i], 3.0, 0, max_lat, num_frames=5)[0]
        for i in range(3)]
    return save_figure_grid(rand_rows, ns.outdir / "random_baseline.png")


if __name__ == "__main__":
    main()
