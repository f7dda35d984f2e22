"""Run the whole figure suite on the port (``notebooks/run_all.py``,
reference: the 10 notebooks listed in ``README.md:63-72``).

    python -m ganspace_tpu_torch.notebooks.run_all --tiny --device cpu
    python -m ganspace_tpu_torch.notebooks.run_all        # full width, on the card

Exits 1 when any figure failed, 0 when all were written.
"""

import importlib
import sys
import traceback

FIGURES = [
    "figure_pca_illustration",
    "figure_teaser",
    "figure_pca_cleanup",
    "figure_style_content_sep",
    "figure_supervised_comp",
    "figure_first_20_pcs",
    "figure_edit_zoo",
    "figure_biggan_style_resampling",
    "figure_biggan_style_mixing",
    "figure_biggan_edit_transferability",
]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    failed = []
    for name in FIGURES:
        print(f"\n=== {name} ===", flush=True)
        try:
            mod = importlib.import_module(f"ganspace_tpu_torch.notebooks.{name}")
            mod.main(argv)
        except Exception as e:
            # one figure's failure is reported and the suite goes on
            traceback.print_exc()
            print(f"FAILED {name}: {type(e).__name__}: {e}")
            failed.append(name)
    if failed:
        print(f"\n{len(failed)} figure(s) failed: {failed}")
        return 1
    print(f"\nall {len(FIGURES)} figures written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
