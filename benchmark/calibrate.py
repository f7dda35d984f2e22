"""The readings the limits of ``correct`` are set from, for one cell, in one
process on the card:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out <file.jsonl>]

For each ``--seeds`` seed: the program's unit of work (the first fit, or
the first ``check_strips`` strips, of a run under that seed) judged
against the reference, as a run's check judges it: the lower readings.
For each ``--control-seeds`` seed: the control, the reference computed
with TF32 on (the precision below the configuration's float32) and put in
the program's place, judged the same way: the upper readings.  One JSON
line per reading.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness


def _fit_readings(drv, seed, control: bool):
    from benchmark.loops.fit import fit_seed
    fs = fit_seed(seed, 0)
    out, path = {}, drv.ctx.tmp / "cal.npz"
    if not control:
        drv._fit(drv.mix["n"], fs, path)
    t0 = time.perf_counter()
    ref = drv.reference_fit(fs)
    ref_s = time.perf_counter() - t0
    if control:
        out = drv.judge(ref, drv.as_output(drv.reference_fit(fs, tf32=True)))
    elif path.exists():                       # rank 0 writes the cache on a mesh
        with np.load(path) as d:
            out = drv.judge(ref, {k: d[k] for k in d.files if k != "_meta"})
        path.unlink()
    return out, {"reference_s": ref_s, "refined": ref.refined,
                 "ratio_top": float(ref.ratio[0]), "ratio_sum": float(ref.ratio.sum())}


def _strip_readings(drv, seed, control: bool):
    k = drv.mix["check_strips"]
    off = total = 0
    t0 = time.perf_counter()
    for i in range(k):
        want = drv.reference_frames(i)
        got = (drv.reference_frames(i, tf32=True) if control else np.stack(drv._strip(i)))
        off += int(np.count_nonzero(got != want))
        total += want.size
    return {"pixels_off": 100.0 * off / total}, {"seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.resolve(args.workload)
    harness.pin_env(cell.mix)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    plan = ([(int(s), False) for s in args.seeds.split(",") if s]
            + [(int(s), True) for s in args.control_seeds.split(",") if s])
    if cell.mix.get("ranks", 1) > 1:
        from ganspace_tpu_torch.parallel.mesh import launch
        launch(_rank, args=(args.workload, plan, args.out), shape=str(cell.mix["ranks"]))
    else:
        _readings(cell, plan, torch.device("cuda"), None, args.out)
    return 0


def _rank(mesh, name, plan, out):
    cell = harness.resolve(name)
    harness.pin_env(cell.mix)
    _readings(cell, plan, mesh.device, mesh, out)


def _readings(cell, plan, device, mesh, out):
    """Each (seed, control) of ``plan``: one JSON line (rank 0's)."""
    sink = open(out, "a") if out else sys.stdout
    readings = _fit_readings if cell.mix["loop"] == "fit" else _strip_readings
    for seed, control in plan:
        with tempfile.TemporaryDirectory(prefix="ganspace-cal-") as tmp:
            drv = cell.loop.Loop(harness.Context(cell, seed, device, Path(tmp), mesh))
            drv.setup()
            numbers, info = readings(drv, seed, control)
            drv.free()
            del drv
            torch.cuda.empty_cache()
        if mesh is None or mesh.is_root:
            line = {"workload": cell.name, "seed": seed,
                    "side": "control" if control else "program", "numbers": numbers, **info}
            print(json.dumps(line), file=sink, flush=True)


if __name__ == "__main__":
    sys.exit(main())
