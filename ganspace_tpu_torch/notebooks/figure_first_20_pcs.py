"""First 20 principal components, one centered strip each
(``notebooks/figure_first_20_pcs.py``, reference
``notebooks/figure_first_20_pcs.ipynb``).

    python -m ganspace_tpu_torch.notebooks.figure_first_20_pcs --tiny --device cpu
"""

from ganspace_tpu_torch.notebooks.notebook_init import (create_strip_centered, figure_main,
                                                       parse_args, save_figure_grid, setup)


@figure_main
def main(argv=None):
    args = parse_args(argv, model="StyleGAN2", layer="style", components=20)
    ns = setup(args, use_w=True)
    model, inst, t = ns.model, ns.inst, ns.comps
    max_lat = model.get_max_latents()
    z = model.sample_latent(1, seed=0)
    n = min(20, args.components)

    rows = [
        create_strip_centered(inst, "latent", args.layer, [z], 0,
                              t.lat_comp[i], 0, t.lat_stdev[i], 0, t.lat_mean,
                              2.0, 0, max_lat, num_frames=5)[0]
        for i in range(n)]
    return save_figure_grid(rows, ns.outdir / "first_20_pcs.png")


if __name__ == "__main__":
    main()
