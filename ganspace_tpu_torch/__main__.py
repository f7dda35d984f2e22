"""Package entry point: route to the port's CLIs.

    python -m ganspace_tpu_torch <command> [args...]

The dispatcher of ``ganspace_tpu/__main__.py``, with its six commands.
"""

from __future__ import annotations

import sys

COMMANDS = {
    "visualize": ("ganspace_tpu_torch.apps.visualize",
                  "compute components and render grids/videos"),
    "interactive": ("ganspace_tpu_torch.apps.interactive",
                    "web viewer with sliders and direction export"),
    "dissect": ("ganspace_tpu_torch.dissection.__main__",
                "GAN dissection: unit quantiles, IoU vs segmentation, report"),
    "makesample": ("ganspace_tpu_torch.tools.makesample", "sample images to PNGs"),
    "ganseg": ("ganspace_tpu_torch.tools.ganseg",
               "image|segmentation visualizations"),
    "allunitsample": ("ganspace_tpu_torch.tools.allunitsample",
                      "top-activating grids for every unit of a layer"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        width = max(len(k) for k in COMMANDS)
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:<{width}}  {desc}")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command '{cmd}' — one of: {', '.join(COMMANDS)}",
              file=sys.stderr)
        return 2
    import importlib
    mod = importlib.import_module(COMMANDS[cmd][0])
    result = mod.main(rest)
    return result if isinstance(result, int) else 0


if __name__ == "__main__":
    sys.exit(main())
