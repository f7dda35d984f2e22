"""Dissection report generation (reference ``dissection.py:174-500, 1371``).

Counterpart of ``ganspace_tpu/dissection/report.py``: the JSON report, an
SVG IoU bargraph, per-unit top-image grids (regenerated on the model's
device, quantized there, written by the native writer pool) and a static
HTML viewer; and the ACE pages (reference ``acesummarize.py`` /
``aceplotablate.py``): the loss and ablation-effect plots (matplotlib's Agg
canvas, where matplotlib is installed) and a summary table.
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


# ---------------------------------------------------------------------------
# ACE reporting (reference acesummarize.py / aceplotablate.py)
# ---------------------------------------------------------------------------

def _figure(figsize=(4.5, 3.5)):
    from matplotlib.backends.backend_agg import FigureCanvasAgg as FigureCanvas
    from matplotlib.figure import Figure
    fig = Figure(figsize=figsize)
    FigureCanvas(fig)
    return fig


def save_ace_loss_plot(runs: Dict[str, Dict], outpath, title: str = "") -> Path:
    """Loss-history curves, one per labeled run (e.g. different L1
    strengths) — the ``acesummarize.py:28-60`` plot: per-run optimization
    loss with the run label in the legend."""
    outpath = Path(outpath)
    fig = _figure()
    ax = fig.add_subplot(111)
    for label, run in runs.items():
        ax.plot(run["loss_history"], label=str(label))
    ax.set_title(title or "ACE optimization loss")
    ax.grid(True)
    ax.legend()
    ax.set_ylabel("Loss")
    ax.set_xlabel("Steps")
    fig.tight_layout()
    outpath.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(outpath)
    return outpath


def save_ablation_effect_plot(effects: Dict[str, Dict[int, float]],
                              baseline: float, outpath,
                              classname: str = "") -> Path:
    """Normalized ablation-effect curves ``1 - presence(k) / baseline`` per
    ranking (``aceplotablate.py:25-51``): x = units ablated, y = portion of
    class pixels removed, one labeled curve per ranking (ACE vs IoU...)."""
    outpath = Path(outpath)
    fig = _figure()
    ax = fig.add_subplot(111)
    for label, eff in effects.items():
        ks = sorted(int(k) for k in eff)
        base = eff.get(0, baseline) or baseline or 1e-9
        ax.plot(ks, [1.0 - eff[k] / base for k in ks], marker=".",
                label=str(label))
    ax.set_title(f"Effect of ablating units for {classname}".strip())
    ax.grid(True)
    ax.legend()
    ax.set_ylabel(f"Portion of {classname or 'class'} pixels removed")
    ax.set_xlabel("Number of units ablated")
    ax.set_ylim(0, 1.0)
    fig.tight_layout()
    outpath.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(outpath)
    return outpath


def generate_ace_report(outdir, classname: str, runs: Dict[str, Dict],
                        effects: Optional[Dict[str, Dict[int, float]]] = None,
                        n_top: int = 20) -> Path:
    """ACE summary page: loss plot + effect plot + per-run table (baseline
    presence, final loss, saturated-unit count, top-ranked units).  Returns
    the ``ace.html`` path.  ``runs`` maps a label to an ``ace_optimize``
    result; ``effects`` maps a label to an ``ablation_effect`` result.
    Where matplotlib is not installed the page holds the table alone, and a
    line on stdout says that the plots were not written."""
    import importlib.util

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    first = next(iter(runs.values()))
    plots = []
    if importlib.util.find_spec("matplotlib") is None:
        print("ace: matplotlib is not installed: the plots ace-loss.png and "
              "ace-effect.png are not written")
    else:
        save_ace_loss_plot(runs, outdir / "ace-loss.png",
                           title=f"{classname} ACE loss")
        plots.append("ace-loss.png")
        if effects:
            save_ablation_effect_plot(effects, first.get("baseline", 0.0),
                                      outdir / "ace-effect.png", classname)
            plots.append("ace-effect.png")

    rows = []
    for label, run in runs.items():
        abl = np.asarray(run["ablation"])
        top = ", ".join(str(int(u)) for u in np.asarray(run["ranking"])[:8])
        rows.append(
            f"<tr><td>{html.escape(str(label))}</td>"
            f"<td>{run.get('baseline', float('nan')):.5f}</td>"
            f"<td>{run['loss_history'][-1]:.5f}</td>"
            f"<td>{int((abl >= 0.999).sum())}/{abl.size}</td>"
            f"<td>{top}</td></tr>")
    page = f"""<!DOCTYPE html><html><head><title>ACE: {html.escape(classname)}</title>
<style>body{{font-family:sans-serif}}td{{padding:4px 10px}}</style></head><body>
<h2>ACE — {html.escape(classname)}</h2>
{' '.join(f'<img src="{p}"/>' for p in plots)}
<table><tr><th>run</th><th>baseline presence</th><th>final loss</th>
<th>saturated units</th><th>top units</th></tr>
{''.join(rows)}</table></body></html>"""
    out = outdir / "ace.html"
    out.write_text(page)
    return out
