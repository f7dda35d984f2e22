"""BigGAN edit transferability across classes
(``notebooks/figure_biggan_edit_transferability.py``, reference
``notebooks/figure_biggan_edit_transferability.ipynb``: components computed
on one class applied, unchanged, to other classes — geometric PCs transfer
because the layer-wise z space is shared).

    python -m ganspace_tpu_torch.notebooks.figure_biggan_edit_transferability --tiny --device cpu
"""

from ganspace_tpu_torch.notebooks.notebook_init import (create_strip, figure_main, parse_args,
                                                       save_figure_grid, setup)

CLASSES = ["husky", "church", "goldfish"]


@figure_main
def main(argv=None):
    args = parse_args(argv, model="BigGAN-128", output_class="husky",
                      layer="generator.gen_z", components=8, n=512)
    ns = setup(args, use_w=False)       # components computed on args.output_class
    model, inst, t = ns.model, ns.inst, ns.comps
    max_lat = model.get_max_latents()
    pc = 0

    rows = []
    for cls in CLASSES:
        model.set_output_class(cls)
        z = model.sample_latent(1, seed=6)
        rows.append(create_strip(inst, "latent", args.layer, [z], 0,
                                 t.lat_comp[pc], 0, t.lat_stdev[pc], 3.0,
                                 0, max_lat, num_frames=5)[0])
    model.set_output_class(args.output_class or "husky")
    return save_figure_grid(rows, ns.outdir / "biggan_edit_transferability.png")


if __name__ == "__main__":
    main()
