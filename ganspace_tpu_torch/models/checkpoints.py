"""Checkpoint location for the StyleGAN families (the locate half of
``ganspace_tpu/models/checkpoints.py``).

A constructor called without ``params`` looks for the reference's file
under ``$GANCONTROL_CHECKPOINT_DIR`` and loads what it finds; on a miss it
prints a one-line notice to stderr and keeps its seeded random weights.
This port has no URL tables and no download-on-miss: it runs where there is
no network, and there the JAX package's download attempt fails and falls
back to random weights too.  Put the files in place by hand.

Layout (the reference's, shared with the JAX package):
    $GANCONTROL_CHECKPOINT_DIR/
      stylegan2/stylegan2_<class>_<res>.pt               (rosinality format)
      stylegan/stylegan_<class>_<res>.pt                 (lernapparat format)
      stylegan/stylegan_<class>_<res>.pkl                (NVlabs dnnlib pickle)
      stylegan/karras2019stylegan-<class>-<res>x<res>.pkl

Without ``$GANCONTROL_CHECKPOINT_DIR`` the root is the JAX package's own
default, ``ganspace_tpu/models/checkpoints`` of this checkout, so that one
set of files serves both packages.  The path is computed; nothing of that
package is imported.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Optional, Tuple

#: the JAX package's default checkpoint directory in this checkout
DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "ganspace_tpu" / "models" / "checkpoints"


def checkpoint_root() -> Path:
    return Path(os.environ.get("GANCONTROL_CHECKPOINT_DIR", DEFAULT_ROOT))


def find_checkpoint(relative: str) -> Optional[Path]:
    path = checkpoint_root() / relative
    return path if path.is_file() else None


def note_random_init(name: str, relative: str) -> None:
    # stderr: a diagnostic, not program output
    print(f"[{name}] no checkpoint at {checkpoint_root() / relative}; "
          f"using seeded random initialization", file=sys.stderr)


def locate_stylegan2(outclass: str, resolution: int) -> Tuple[Optional[Path], str]:
    """(the rosinality ``.pt`` or None, its path under the root)."""
    rel = f"stylegan2/stylegan2_{outclass}_{resolution}.pt"
    return find_checkpoint(rel), rel


def locate_stylegan(outclass: str, resolution: int) -> Tuple[Optional[Path], str]:
    """(the lernapparat ``.pt``, else one of the two NVlabs pickle names,
    or None; the ``.pt``'s path under the root)."""
    rel = f"stylegan/stylegan_{outclass}_{resolution}.pt"
    for candidate in (rel, f"stylegan/stylegan_{outclass}_{resolution}.pkl",
                      f"stylegan/karras2019stylegan-{outclass}-{resolution}x{resolution}.pkl"):
        found = find_checkpoint(candidate)
        if found is not None:
            return found, rel
    return None, rel
