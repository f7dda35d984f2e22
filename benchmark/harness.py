"""The benchmark's harness: it resolves a cell by name, makes its set-up,
runs its window, checks what the window produced and prints one result.

Everything a cell is made of is found by name, so that a cell, a
configuration, a traffic mix or a per-layer metric is added with new files
and new entries in ``BENCHMARK.json``, and no file edited:

* ``BENCHMARK.json``'s ``configs`` entry names the configuration's file;
  its ``model`` key names ``benchmark/models/<model>.py`` (weights from the
  seed, the program's model, the reference, the work of a unit);
* a cell's ``traffic`` names ``benchmark/mixes/<traffic>.json``, whose
  ``loop`` names ``benchmark/loops/<loop>.py``;
* a cell's limits for ``correct`` are ``benchmark/limits/<cell>.json``;
* a per-layer metric is ``benchmark/metrics/<name>.py``: ``RANGES``, the
  program's entry points it needs ranges around, and ``read(run)``, which
  returns its value or None.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "ganspace_tpu")


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (from /proc; the
    harness's import time where /proc is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


#: host threads of the run's process (OpenMP, MKL, OpenBLAS, torch's
#: intra-op pool): few, so that the host-paced loops share the machine's
#: cores steadily
HOST_THREADS = "2"


def pin_threads() -> None:
    """Few host threads: the variables for libraries not loaded yet, and
    torch's pool if it is."""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = HOST_THREADS
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(int(HOST_THREADS))


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    model: ModuleType
    loop: ModuleType
    end_to_end: list
    per_layer: list
    readers: dict
    root: Path
    spec: dict                         # the BENCHMARK.json it was resolved from


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` goes to those cells; a per-layer one
    without, to every cell reporting what it moves; else to every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def resolve(name: str, root: Path = ROOT, spec: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, every piece loaded."""
    spec = spec or json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / centry["file"]).read_text())
    mix = json.loads((root / "benchmark" / "mixes" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    readers = {m["name"]: load_file(root / "benchmark" / "metrics" / f"{m['name']}.py",
                                    "benchmark_metric_" + m["name"].replace(".", "_"))
               for m in per_layer}
    return Cell(name, cell["chips"], cfg, mix, limits,
                load_file(root / "benchmark" / "models" / f"{cfg['model']}.py",
                          f"benchmark_model_{cfg['model']}"),
                load_file(root / "benchmark" / "loops" / f"{mix['loop']}.py",
                          f"benchmark_loop_{mix['loop']}"),
                e2e, per_layer, readers, root, spec)


def pin_env(mix: dict, root: Path = ROOT) -> None:
    """The program's switches as the mix pins them, every other
    ``GANSPACE_*`` variable unset (so ``GANSPACE_COMPILE_CACHE`` is, as a CLI
    user has it); the caches of torch's compilers at fixed paths inside the
    checkout (the program's own kernel library builds into
    ``build/ganspace_tpu_torch/``)."""
    for k in [k for k in os.environ if k.startswith("GANSPACE_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in mix.get("pins", {}).items()})
    cache = root / "build" / "benchmark"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"


@dataclass
class Context:
    cell: Cell
    seed: int
    device: object
    tmp: Path
    mesh: object = None                # the rank's ``parallel.Mesh``, or None
    cfg: dict = field(init=False)
    mix: dict = field(init=False)
    model: ModuleType = field(init=False)

    def __post_init__(self):
        self.cfg, self.mix, self.model = self.cell.cfg, self.cell.mix, self.cell.model


@dataclass
class Run:
    """What a per-layer metric reads."""
    loop: str
    chips: int
    phases: list
    trace: object
    unit_flops: float


class JaxLoaded(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             started: Optional[float] = None) -> dict:
    """One run of ``cell``: set-up, the window, the check; the result.  A
    cell whose mix asks for more than one rank runs one process per device
    through the program's own launcher (``parallel.mesh.launch``, as the
    visualize CLI does); rank 0's readings are the run's, with the peak
    memory of the fullest device and the busy seconds averaged over the
    devices."""
    import torch

    started = time.perf_counter() if started is None else started
    ranks = cell.mix.get("ranks", 1)
    if ranks > 1:
        from ganspace_tpu_torch.parallel.mesh import launch
        outs = launch(rank_main, args=(str(cell.root), cell.spec, cell.name, cell.cfg, cell.mix,
                                       seed, seconds, trace, started, device),
                      shape=str(ranks), devices="cpu" if device == "cpu" else None)
        res = {**outs[0], "peak": max(o["peak"] for o in outs),
               "late": sorted({m for o in outs for m in o["late"]})}
        if res["busy_s"] is not None:
            res["busy_s"] = sum(o["busy_s"] for o in outs) / len(outs)
    else:
        res = run_here(cell, seed, seconds, trace, started, torch.device(device))
    late = sorted(set(res["late"]) | set(banned_modules()))
    if late:
        raise JaxLoaded(f"loaded in the run's process: {', '.join(late)}")
    checks = res["checks"]
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    if set(checks) != set(limits):
        raise RuntimeError(f"checks {sorted(checks)} against limits {sorted(limits)}")
    correct = res["failed"] == 0 and all(checks[k] <= limits[k] for k in checks)

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {k: {"value": float(v), "unit": units[k]} for k, v in res["metrics"].items()
               if k in units}
    cuda = device != "cpu"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(res["peak"])}
    out = {"correct": bool(correct), "attempted": res["units"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    if res["busy_s"] is not None:
        dev["busy_s"], dev["window_s"] = res["busy_s"], res["window_s"]
        out["breakdown"] = res["breakdown"]
    out["checks"] = {k: {"value": checks[k] if math.isfinite(checks[k]) else None,
                         "limit": limits[k]} for k in sorted(checks)}
    return out


def rank_main(mesh, root, spec, name, cfg, mix, seed, seconds, trace, started,
              device) -> dict:
    """One rank of a multi-device cell, in its own process: the cell
    resolved again by name, with the caller's configuration and mix."""
    import torch
    cell = resolve(name, Path(root), spec)
    cell.cfg, cell.mix = cfg, mix
    pin_threads()
    pin_env(mix, cell.root)
    return run_here(cell, seed, seconds, trace, started,
                    torch.device(device) if device == "cpu" else mesh.device, mesh)


@contextlib.contextmanager
def broken(fault):
    """A mix's ``fault``, ``[module, "Attr" or "Class.attr", "module:function"]``,
    replaces a function of the program for the length of the block: the
    tests' broken runs, reaching the ranks of a mesh too.  No cell has one."""
    if not fault:
        yield
        return
    modname, path, repl = fault
    owner = importlib.import_module(modname)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    rmod, rfn = repl.split(":")
    old = getattr(owner, attr)
    setattr(owner, attr, getattr(importlib.import_module(rmod), rfn))
    try:
        yield
    finally:
        setattr(owner, attr, old)


def run_here(cell: Cell, seed, seconds, trace, started, device, mesh=None) -> dict:
    """Set-up, window and check in this process (one rank of a mesh, or the
    whole run); plain values, so that a rank can hand them back."""
    import torch
    from benchmark.trace import Profiled

    cuda = device.type == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="ganspace-bench-"))
    try:
        drv = cell.loop.Loop(Context(cell, seed, device, tmp, mesh))
        drv.setup()
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - started
        print(f"set-up: {setup_s:.3f} s", flush=True)

        ranges = {}
        for reader in cell.readers.values():
            ranges.update(reader.RANGES)
        with broken(cell.mix.get("fault")):
            win = drv.window(seconds, trace, lambda: Profiled(ranges))
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        late = banned_modules()
        drv.free()
        if cuda:
            torch.cuda.empty_cache()
        checks = drv.check()
        late = sorted(set(late) | set(banned_modules()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if not trace:
        metrics = {k: v for k, (v, _) in drv.end_to_end(win).items()}
        metrics["setup_s"] = setup_s
    else:
        run = Run(drv.name, cell.chips, win.phases, win.trace, win.unit_flops)
        metrics = {m["name"]: cell.readers[m["name"]].read(run) for m in cell.per_layer}
        metrics = {k: v for k, v in metrics.items() if v is not None}
    tr = win.trace if trace else None
    return {"metrics": metrics, "units": win.units, "failed": win.failed, "checks": checks,
            "peak": peak, "late": late,
            "busy_s": tr.busy_s if tr is not None else None,
            "window_s": tr.span_s if tr is not None else None,
            "breakdown": ({"device_ops": tr.top_ops, "idle_gaps": tr.idle_gaps}
                          if tr is not None else None)}


def report(out: dict) -> None:
    """The checks as the last lines on standard error, the result as the
    last line on standard output."""
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
