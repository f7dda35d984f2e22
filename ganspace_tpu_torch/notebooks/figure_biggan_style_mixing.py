"""BigGAN style-mixing grid
(``notebooks/figure_biggan_style_mixing.py``, reference
``notebooks/figure_biggan_style_mixing.ipynb``: content latents on one axis,
style latents on the other; each cell takes the row's latent for the early
layer slots and the column's for the rest).

    python -m ganspace_tpu_torch.notebooks.figure_biggan_style_mixing --tiny --device cpu
"""

from ganspace_tpu_torch.notebooks.notebook_init import parse_args, save_figure_grid, setup

CONTENT_SEEDS = [1, 2, 3]
STYLE_SEEDS = [41, 42, 43]


def mixed_latents(model, content_seed: int, style_seed: int):
    """One cell's layer-wise latents: the content latent in the first half
    of the slots, the style latent in the rest."""
    max_lat = model.get_max_latents()
    split = max(1, max_lat // 2)
    z_c = model.sample_latent(1, seed=content_seed)
    z_s = model.sample_latent(1, seed=style_seed)
    return [z_c] * split + [z_s] * (max_lat - split)


def main(argv=None):
    args = parse_args(argv, model="BigGAN-128", output_class="husky",
                      layer="generator.gen_z", components=8, n=512)
    ns = setup(args, use_w=False)
    model = ns.model

    header = [model.sample_np(model.sample_latent(1, seed=s))
              for s in STYLE_SEEDS]
    rows = [header]
    for cs in CONTENT_SEEDS:
        rows.append([model.sample_np(mixed_latents(model, cs, ss))
                     for ss in STYLE_SEEDS])
    return save_figure_grid(rows, ns.outdir / "biggan_style_mixing.png")


if __name__ == "__main__":
    main()
