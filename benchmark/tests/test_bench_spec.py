"""The benchmark's spec: every cell resolves by name, new files are picked
up with no file edited, the file keeps to its format, the import guard
compares whole top-level names, and the work counts match the kernel
table's bounds."""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness, work

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = harness.resolve(name)
    assert cell.chips in (1, 4)
    assert hasattr(cell.loop, "Loop") and hasattr(cell.model, "make_weights")
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(cell.readers[m["name"]].read)
        assert isinstance(cell.readers[m["name"]].RANGES, dict)
    assert set(cell.limits) and all("limit" in v for v in cell.limits.values())


def test_spec_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
        assert json.loads((harness.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)


def test_new_cell_config_metric_are_picked_up(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric added as new
    files (and entries) in a copy of the benchmark resolve with no file of
    the copy edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "StyleGAN2-FFHQ-1024.json").read_text())
    cfg.update(name="StyleGAN2-LSUN-car-512", resolution=512, port_class="car")
    (b / "configs" / "StyleGAN2-LSUN-car-512.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "mixes" / "w-strips-5.json").read_text())
    mix.update(frames=9)
    (b / "mixes" / "w-strips-9.json").write_text(json.dumps(mix))
    (b / "limits" / "car-strips.json").write_text(
        (b / "limits" / "sg2-w-render.json").read_text())
    (b / "metrics" / "render.frames_per_strip.py").write_text(
        "RANGES = {}\n\ndef read(run):\n    return 9.0\n")
    spec["configs"].append({"name": "StyleGAN2-LSUN-car-512", "source": "x",
                            "file": "benchmark/configs/StyleGAN2-LSUN-car-512.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "car-strips", "config": "StyleGAN2-LSUN-car-512",
                              "traffic": "w-strips-9", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "render.frames_per_strip", "unit": "frames",
                              "better": "higher", "source": "program_counter",
                              "layer": "render", "moves": "render_frames_per_s"})
    for w in spec["end_to_end"]:
        if "workloads" in w and "sg2-w-render" in w["workloads"]:
            w["workloads"].append("car-strips")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve("car-strips", root=root)
    assert cell.cfg["resolution"] == 512 and cell.mix["frames"] == 9
    assert cell.readers["render.frames_per_strip"].read(None) == 9.0
    # a metric without ``workloads`` goes to every cell reporting what it moves
    assert "render.frames_per_strip" in harness.resolve("sg2-w-render", root=root).readers
    assert "render.frames_per_strip" not in harness.resolve("sg2-convs2-fit", root=root).readers
    assert all(p.read_bytes() == data for p, data in before.items())


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.banned_modules() == [] or "jax" in sys.modules
    for name in ("jax", "jaxlib.xla_client", "ganspace_tpu.models", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.delitem(sys.modules, "jax")
    found = harness.banned_modules()
    assert found == ["flax", "ganspace_tpu", "jaxlib"]
    for name in ("ganspace_tpu_torch", "jaxtyping", "jax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.banned_modules() == found


def test_benchmark_and_program_import_no_jax():
    """The harness, its readers and the program's entry points, imported in
    a fresh process, load neither JAX nor the JAX package."""
    code = ("import sys; from benchmark import harness, trace; "
            "[harness.resolve(n) for n in %r]; "
            "import ganspace_tpu_torch.decomposition, ganspace_tpu_torch.edit, "
            "ganspace_tpu_torch.parallel.mesh; "
            "print(harness.banned_modules())" % (CELLS,))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, text=True,
                         capture_output=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


# StyleGAN2-1024's synthesis shapes: (C, Co, resolution) of its nine 3x3
# convs and its eight stride-2 ones (at their input resolution)
SG2_3X3 = [(512, 512, 4), (512, 512, 8), (512, 512, 16), (512, 512, 32), (512, 512, 64),
           (256, 256, 128), (128, 128, 256), (64, 64, 512), (32, 32, 1024)]
SG2_UP = [(512, 512, 4), (512, 512, 8), (512, 512, 16), (512, 512, 32), (512, 256, 64),
          (256, 128, 128), (128, 64, 256), (64, 32, 512)]


def test_work_counts_match_the_kernel_table():
    """The bounds of PERF.md's kernel table (3xTF32 at 165 TFLOP/s): B at
    the nine render shapes at B = 5 3.124 ms, at the two tap shapes at B =
    128 0.293 ms; B-up at the eight render shapes 1.3747 ms, at the tap
    shapes 0.2928 ms; 103.05 GFLOP of 3x3 convs a frame."""
    b3 = sum(work.bound_s(*work.modconv3x3(5, c, co, r, r)) for c, co, r in SG2_3X3)
    assert b3 * 1e3 == pytest.approx(3.124, abs=1e-3)     # the table's 3 decimals
    tap = sum(work.bound_s(*work.modconv3x3(128, 512, 512, r, r)) for r in (4, 8))
    assert tap * 1e3 == pytest.approx(0.293, abs=1e-3)
    up = sum(work.bound_s(*work.upconv(5, c, co, r, r)) for c, co, r in SG2_UP)
    assert up * 1e3 == pytest.approx(1.3747, abs=5e-5)
    up_tap = sum(work.bound_s(*work.upconv(128, 512, 512, r, r)) for r in (4, 8))
    assert up_tap * 1e3 == pytest.approx(0.2928, abs=5e-5)
    assert sum(work.modconv3x3(1, c, co, r, r)[0] for c, co, r in SG2_3X3) / 1e9 == \
        pytest.approx(103.05, abs=0.01)


def test_model_flops_of_a_frame_and_a_fit_sample():
    cfg = json.loads((harness.ROOT / "benchmark/configs/StyleGAN2-FFHQ-1024.json").read_text())
    from benchmark.models import stylegan2
    frame = stylegan2.frame_flops(cfg, {})
    convs = (sum(work.modconv3x3(1, c, co, r, r)[0] for c, co, r in SG2_3X3)
             + sum(work.upconv(1, c, co, r, r)[0] for c, co, r in SG2_UP))
    assert convs / 1e9 == pytest.approx(148.12, abs=0.01)
    assert convs < frame < convs * 1.01          # + the affines and to_rgb
    tap = stylegan2.sample_flops(cfg, {"layer": "convs.2"})
    assert tap / 1e9 == pytest.approx(0.76, abs=0.01)
    assert stylegan2.tap_dim(cfg, "convs.2") == 131072
    assert stylegan2.tap_dim(cfg, "conv1") == 8192
    assert math.isclose(work.sketch_update(128, 131072, 320)[0], 4 * 128 * 131072 * 320)
