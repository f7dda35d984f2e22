"""Edit zoo: named exported directions applied across samples
(``notebooks/figure_edit_zoo.py``, reference ``notebooks/figure_edit_zoo.ipynb``:
loads exported ``.pkl`` directions and renders one strip per named edit).

Pass ``--inputs DIR`` with exported direction pkls (the viewer's export
format, reference ``interactive.py:526-549``); without it the top PCs are
exported to a temporary directory first and then loaded back — exercising
the full export/import round trip.

    python -m ganspace_tpu_torch.notebooks.figure_edit_zoo --tiny --device cpu
"""

import shutil
import sys
import tempfile
from pathlib import Path

from ganspace_tpu_torch import directions as dirlib
from ganspace_tpu_torch.notebooks.notebook_init import (create_strip, figure_main, parse_args,
                                                       save_figure_grid, setup)


@figure_main
def main(argv=None):
    inputs = None
    argv_rest = []
    it = iter(argv or sys.argv[1:])
    for a in it:
        if a == "--inputs":
            inputs = next(it)
        elif a.startswith("--inputs="):
            inputs = a.split("=", 1)[1]
        else:
            argv_rest.append(a)

    args = parse_args(argv_rest, model="StyleGAN2", layer="style",
                      components=8)
    ns = setup(args, use_w=True)
    model, inst, t = ns.model, ns.inst, ns.comps
    max_lat = model.get_max_latents()

    exported = None
    if inputs is None:
        # Export the top PCs as named directions, then load them back
        # (full export/import round trip, reference interactive.py:526-578).
        exported = inputs = Path(tempfile.mkdtemp(prefix="edit_zoo_"))
        for i, name in enumerate(["direction_a", "direction_b", "direction_c"]):
            params = dirlib.direction_params(
                name=name, sigma_range=2.0, component_index=i,
                act_comp=t.act_comp[i], lat_comp=t.lat_comp[i],
                latent_space=model.latent_space_name(),
                act_stdev=float(t.act_stdev[i].ravel()[0]),
                lat_stdev=float(t.lat_stdev[i].ravel()[0]),
                model_name=model.name, output_class=str(model.outclass),
                estimator="ipca", components=args.components, samples=args.n,
                layer=args.layer, component_class=str(model.outclass),
                edit_type="latent", truncation=1.0, edit_start=0,
                edit_end=max_lat, example_seed=13)
            dirlib.export_direction(params, inputs)

    try:
        named = dirlib.load_named_components(inputs, model.name,
                                             str(model.outclass),
                                             model.latent_space_name())
    finally:
        if exported is not None:
            shutil.rmtree(exported)
    print(f"loaded {len(named)} named directions from {inputs}")

    rows = []
    for d in named:
        z = model.sample_latent(1, seed=13)
        rows.append(create_strip(inst, "latent", args.layer, [z], 0,
                                 d["lat_comp"], 0, d["lat_stdev"],
                                 d.get("sigma_range", 2.0),
                                 d.get("edit_start", 0),
                                 min(d.get("edit_end", max_lat), max_lat),
                                 num_frames=5)[0])
    return save_figure_grid(rows, ns.outdir / "edit_zoo.png")


if __name__ == "__main__":
    main()
