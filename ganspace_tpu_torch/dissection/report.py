"""Dissection report generation (reference ``dissection.py:174-500, 1371``).

Counterpart of ``ganspace_tpu/dissection/report.py``: the JSON report, an
SVG IoU bargraph, per-unit top-image grids (regenerated on the model's
device, quantized there, written by the native writer pool) and a static
HTML viewer.  The ACE report pages come with ACE (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import html
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ganspace_tpu_torch.imaging import uint8_nhwc
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.native import ImageWriterPool


def make_svg_bargraph(names, values, width: int = 640, bar_h: int = 16) -> str:
    """Horizontal IoU bargraph (reference ``make_svg_bargraph``,
    ``dissection.py:1371``)."""
    vmax = max(values) if len(values) else 1.0
    rows = []
    for i, (name, val) in enumerate(zip(names, values)):
        w = int((width - 180) * (val / max(vmax, 1e-9)))
        y = i * (bar_h + 4)
        rows.append(
            f'<text x="0" y="{y + bar_h - 3}" font-size="12">{html.escape(str(name))}</text>'
            f'<rect x="150" y="{y}" width="{max(w,1)}" height="{bar_h}" fill="#4a90d9"/>'
            f'<text x="{155 + w}" y="{y + bar_h - 3}" font-size="11">{val:.3f}</text>')
    height = len(values) * (bar_h + 4) + 4
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}">{"".join(rows)}</svg>')


@torch.no_grad()
def save_unit_images(report: Dict, inst: InstrumentedModel, outdir,
                     n_units: int = 20, seed: int = 1,
                     pool: Optional[ImageWriterPool] = None):
    """Regenerate and save each top unit's highest-activating samples side
    by side (async via the native writer pool): one forward of a unit's
    (up to) four latents."""
    outdir = Path(outdir)
    (outdir / "image").mkdir(parents=True, exist_ok=True)
    own_pool = pool is None
    pool = pool or ImageWriterPool(4)
    model = inst.model
    # Regenerate batch-aligned: a top-sample index s belongs to the batch
    # drawn with seed + (s//batch)*batch (see dissect.regenerate_sample).
    from ganspace_tpu_torch.dissection.dissect import regenerate_sample
    seed = report.get("seed", seed)
    batch = report.get("batch", 16)
    n_samples = report.get("n_samples", 1000)
    try:
        for rec in report["units"][:n_units]:
            z = torch.cat([regenerate_sample(model, s, seed=seed, batch=batch,
                                             n_samples=n_samples)
                           for s in rec["top_samples"][:4]])
            imgs = uint8_nhwc(model.forward(z))                 # [k, H, W, 3]
            pool.save_png(outdir / "image" / f"unit_{rec['unit']}.png",
                          np.concatenate(list(imgs), axis=1))
        pool.wait()
        if pool.errors():
            raise RuntimeError(f"{pool.errors()} unit image(s) failed to write")
    finally:
        if own_pool:
            pool.close()


def generate_report(report: Dict, outdir, inst: Optional[InstrumentedModel] = None,
                    n_units: int = 20, html_summary: bool = True) -> Path:
    """JSON + SVG + HTML under ``outdir``; returns the html path.
    ``html_summary=False`` (reference ``--no-report``) writes the data file
    only and returns the json path."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    serializable = {k: v for k, v in report.items()
                    if k not in ("iou_matrix", "iqr_matrix")}
    json_path = outdir / "dissect.json"
    json_path.write_text(json.dumps(serializable, indent=2))
    if not html_summary:
        return json_path

    top = report["units"][:n_units]
    svg = make_svg_bargraph(
        [f"unit {r['unit']}: {r['label']}" for r in top],
        [r["iou"] for r in top])
    (outdir / "bargraph.svg").write_text(svg)

    if inst is not None:
        save_unit_images(report, inst, outdir, n_units=n_units)

    rows = []
    for r in top:
        img_tag = (f'<img src="image/unit_{r["unit"]}.png" height="96"/>'
                   if inst is not None else "")
        rows.append(
            f"<tr><td>{r['unit']}</td><td>{html.escape(r['label'])}</td>"
            f"<td>{r['iou']:.3f}</td><td>{img_tag}</td></tr>")
    page = f"""<!DOCTYPE html><html><head><title>dissect: {html.escape(report['model'])}</title>
<style>body{{font-family:sans-serif}}td{{padding:4px 10px}}</style></head><body>
<h2>{html.escape(report['model'])} — {html.escape(report['layer'])}</h2>
<p>{report['n_samples']} samples, activation level quantile {report['level_quantile']}</p>
{svg}
<table><tr><th>unit</th><th>label</th><th>iou</th><th>top images</th></tr>
{''.join(rows)}</table></body></html>"""
    out = outdir / "dissect.html"
    out.write_text(page)
    return out
