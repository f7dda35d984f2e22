"""BigGAN layer-wise style resampling
(``notebooks/figure_biggan_style_resampling.py``, reference
``notebooks/figure_biggan_style_resampling.ipynb``: keep the base latent for
the first n layer slots, resample the remaining slots — BigGAN's layer-wise
z is the analog of StyleGAN style mixing).

    python -m ganspace_tpu_torch.notebooks.figure_biggan_style_resampling --tiny --device cpu
"""

from ganspace_tpu_torch.notebooks.notebook_init import parse_args, save_figure_grid, setup


def main(argv=None):
    args = parse_args(argv, model="BigGAN-128", output_class="husky",
                      layer="generator.gen_z", components=8, n=512)
    ns = setup(args, use_w=False)
    model = ns.model
    max_lat = model.get_max_latents()

    base_seed = 10
    style_seeds = [21, 22, 23]
    num_keep = sorted({1, max(1, max_lat // 2), max_lat - 1})

    rows = []
    for n_base in num_keep:
        z0 = model.sample_latent(1, seed=base_seed)
        row = [model.sample_np(z0)]
        for seed in style_seeds:
            z1 = model.sample_latent(1, seed=seed)
            z = [z0] * n_base + [z1] * (max_lat - n_base)
            row.append(model.sample_np(z))
        rows.append(row)
    return save_figure_grid(rows, ns.outdir / "biggan_style_resampling.png")


if __name__ == "__main__":
    main()
