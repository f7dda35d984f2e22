"""Global PCs vs hand-tuned layer-range "cleaned up" PCs
(``notebooks/figure_pca_cleanup.py``, reference
``notebooks/figure_pca_cleanup.ipynb``: top PCs applied over all W+ slots,
then the same PCs restricted to tuned layer windows).

    python -m ganspace_tpu_torch.notebooks.figure_pca_cleanup --tiny --device cpu
"""

from ganspace_tpu_torch.notebooks.notebook_init import (create_strip_centered, parse_args,
                                                       save_figure_grid, setup)

# (component, (layer start, layer end), sigma) — the reference hand-tunes
# per-PC windows; the *windowing mechanism* is what the figure demonstrates.
HAND_TUNED = [
    (0, (1, 4), 2.0),
    (1, (0, 3), 2.0),
    (2, (3, 6), 2.0),
    (3, (2, 6), 2.0),
]


def main(argv=None):
    args = parse_args(argv, model="StyleGAN2", layer="style", components=8)
    ns = setup(args, use_w=True)
    model, inst, t = ns.model, ns.inst, ns.comps
    max_lat = model.get_max_latents()
    seed = 7
    n_pcs = min(6, args.components)

    z = model.sample_latent(1, seed=seed)

    global_rows = [
        create_strip_centered(inst, "latent", args.layer, [z], 0,
                              t.lat_comp[i], 0, t.lat_stdev[i], 0, t.lat_mean,
                              2.0, 0, max_lat, num_frames=5)[0]
        for i in range(n_pcs)]
    save_figure_grid(global_rows, ns.outdir / "pca_cleanup_global.png")

    tuned_rows = [
        create_strip_centered(inst, "latent", args.layer, [z], 0,
                              t.lat_comp[i], 0, t.lat_stdev[i], 0, t.lat_mean,
                              sigma, s, min(e, max_lat), num_frames=5)[0]
        for i, (s, e), sigma in HAND_TUNED]
    return save_figure_grid(tuned_rows, ns.outdir / "pca_cleanup_tuned.png")


if __name__ == "__main__":
    main()
