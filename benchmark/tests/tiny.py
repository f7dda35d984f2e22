"""Tiny cells of the benchmark, cut to run on the CPU in seconds."""

from __future__ import annotations

import copy
import json

from benchmark import harness

#: StyleGAN2 at 32 px and 8-16 channels; BigGAN-deep 4 wide
TINY_CFG = {
    "stylegan2": {"resolution": 32, "channels": {"4": 16, "8": 16, "16": 8, "32": 8}},
    "biggan_deep": {"channel_width": 4, "n_stats": 3},
}


MESH = "sg2-convs2-fit-mesh4"


def mesh_cell() -> harness.Cell:
    """The four-GPU fit, prepared and not in ``BENCHMARK.json``: its mix and
    limits, entered here as a cell of the ``convs.2`` fit's metrics."""
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": MESH, "config": "StyleGAN2-FFHQ-1024",
                              "traffic": "convs2-fit-300k-mesh4", "chips": 4, "why": ""})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sg2-convs2-fit" in m.get("workloads", []):
            m["workloads"].append(MESH)
    return harness.resolve(MESH, spec=spec)


def tiny_cell(name: str) -> harness.Cell:
    """Cell ``name`` cut to run on the CPU in seconds: narrow models, small
    fits on the sketch tier (D over the moments tier's limit, which is set
    low), few strips."""
    cell = mesh_cell() if name == MESH else harness.resolve(name)
    cell.cfg = {**cell.cfg, **TINY_CFG[cell.cfg["model"]]}
    mix = copy.deepcopy(cell.mix)
    if mix["loop"] == "fit":
        sg2 = cell.cfg["model"] == "stylegan2"
        mix.update(n=3000 if sg2 else 4000, components=8, batch=128 if sg2 else 256,
                   reference_rows=512)
        mix["pins"].update(GANSPACE_FUSED_ACTS="1", GANSPACE_IPCA_MOMENTS_MAX_D="128")
    else:
        mix.update(components=8, trace_from=1, trace_strips=2, check_strips=3)
    cell.mix = mix
    return cell
