"""Dissection REST server + live-edit viewer (reference ``netdissect/
server.py`` + ``serverstate.py``'s ``GanTester``).

Counterpart of ``ganspace_tpu/dissection/server.py``, stdlib only
(``ThreadingHTTPServer``), with the same endpoints:

    GET  /                       viewer page (report table + live edit panel)
    GET  /api/report             full dissection report JSON
    GET  /api/units?n=20         top-n units
    GET  /api/generate?seed=&units=&strength=&n=   JPEG batch with the given
                                 units ablated (strength 1 = remove) or
                                 boosted (negative strength adds activation)
    GET  /api/overlay?unit=&seed=  unit-activation overlay JPEG
    GET  /api/layers             tap name/channels/shape (ref GET /layers)
    GET  /api/rankings           named per-unit score vectors (GET /rankings)
    GET  /api/levels?quantiles=0.9,0.99   per-unit activation quantile
                                 levels from the stats sketch (GET /levels;
                                 needs the session's ``stats=``)
    GET  /api/compare?seed=&n=   clean row over intervened row (JPEG)
    GET  /api/interventions, /api/recipes, /api/recipe/apply?name=
    POST /api/features           {"ids": [...], "units": [...]} -> per-unit
                                 max/mean over report samples (POST /features)
    POST /api/featuremaps        same body -> level-normalized 0-255 maps
    POST /api/generate           {"ids" | "zs", "interventions"} -> base64 JPEGs
    POST /api/interventions, /api/recipe
    GET  /image/unit_N.png       saved report images (if generated)

The live-edit path uses ``InstrumentedModel``'s edits; the generator runs
on its device (the card unless the session's model says otherwise), and
images stay there, quantized to uint8 on the device, until the JPEG.  Out
of range sample ids, units and standard-z ids raise ``ValueError``, which
answers HTTP 400.  Device work runs under one lock: HTTP threads share one
model.
"""

from __future__ import annotations

import base64
import io
import json
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ganspace_tpu_torch.models.base import InstrumentedModel

# ---------------------------------------------------------------------------
# Reference intervention wire format (serverstate.py:383-478): a list of
# intervention records, each {ablations: [{layer, unit, alpha, value}],
# mask: {bitstring, bitbounds, shape}, maskpooling: max|mean}, combined by
# alpha blending into one [2(alpha, value), C, H, W] map per layer.
# ---------------------------------------------------------------------------

def _adaptive_pool2d(m: np.ndarray, out_hw, mode: str = "max") -> np.ndarray:
    """torch adaptive_{max,avg}_pool2d on a 2-D numpy mask."""
    h, w = m.shape
    oh, ow = out_hw
    out = np.zeros((oh, ow), m.dtype)
    for i in range(oh):
        r0, r1 = (i * h) // oh, -(-((i + 1) * h) // oh)
        for j in range(ow):
            c0, c1 = (j * w) // ow, -(-((j + 1) * w) // ow)
            block = m[r0:r1, c0:c1]
            out[i, j] = block.max() if mode == "max" else block.mean()
    return out


def mask_to_numpy(mask_record: Dict) -> np.ndarray:
    """Reference ``mask_to_numpy`` (serverstate.py:383-423): a spatial mask
    from either a base64 PNG (alpha channel nonzero, or red < 255 when no
    alpha) or a '0101...' bitstring, placed into ``shape`` at
    ``bitbounds`` (row-major)."""
    bitstring = mask_record["bitstring"]
    bitnumpy = None
    default_shape = (256, 256)
    if "image/png;base64," in bitstring:
        from PIL import Image
        raw = base64.b64decode(bitstring.split("image/png;base64,", 1)[1])
        bitnumpy = np.asarray(Image.open(io.BytesIO(raw)))
        default_shape = bitnumpy.shape[:2]
    shape = mask_record.get("shape") or default_shape
    result = np.zeros(tuple(shape), np.float32)
    bitbounds = mask_record.get("bitbounds") or (
        [0] * len(result.shape) + list(result.shape))
    start, end = bitbounds[:len(result.shape)], bitbounds[len(result.shape):]
    if bitnumpy is not None:
        if bitnumpy.ndim == 2:          # grayscale PNG: nonwhite = masked
            result[start[0]:end[0], start[1]:end[1]] = bitnumpy < 255
        elif bitnumpy.shape[2] == 4:
            result[start[0]:end[0], start[1]:end[1]] = bitnumpy[:, :, 3] > 0
        else:
            result[start[0]:end[0], start[1]:end[1]] = bitnumpy[:, :, 0] < 255
        return result
    bits = np.frombuffer(bitstring.encode(), np.uint8) != ord("0")
    h, w = end[0] - start[0], end[1] - start[1]
    if bits.size != h * w:              # ValueError -> HTTP 400, never a
        raise ValueError(               # dropped connection (and survives -O)
            f"bitstring length {bits.size} != bitbounds area {h}x{w}")
    result[start[0]:end[0], start[1]:end[1]] = \
        bits.reshape(h, w).astype(np.float32)
    return result


def decode_intervention(intervention: Optional[Dict],
                        layer_shapes: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    """One intervention record -> {layer: [2, C, H, W] (alpha, value)}
    (reference ``decode_intervention``, serverstate.py:441-478)."""
    if intervention is None:
        return {}
    mask = intervention.get("mask")
    mask = mask_to_numpy(mask) if mask else None
    pooling = intervention.get("maskpooling", "max")
    channels: Dict[str, np.ndarray] = {}
    for arec in intervention.get("ablations", []):
        layer, unit = arec["layer"], int(arec["unit"])
        alpha = arec.get("alpha")
        alpha = 1.0 if alpha is None else float(alpha)
        value = arec.get("value")
        value = 0.0 if value is None else float(value)
        if alpha == 0.0 and value == 0.0:
            continue
        if layer not in layer_shapes:
            raise ValueError(f"unknown layer {layer!r}")
        n_ch = layer_shapes[layer][1]
        if not 0 <= unit < n_ch:        # negative units would silently wrap
            raise ValueError(
                f"unit {unit} out of range [0, {n_ch}) for layer {layer!r}")
        if layer not in channels:
            channels[layer] = np.zeros((2, *layer_shapes[layer][1:]),
                                       np.float32)
        channels[layer][0, unit] = alpha
        channels[layer][1, unit] = value
    if mask is not None:
        for layer, arr in channels.items():
            hw = layer_shapes[layer][2:]
            arr[0] *= _adaptive_pool2d(mask, hw,
                                       "mean" if pooling == "mean" else "max")
    return channels


def decode_intervention_array(interventions: Optional[List[Dict]],
                              layer_shapes: Dict[str, tuple]
                              ) -> Dict[str, np.ndarray]:
    """Alpha-blend a list of intervention records into one per-layer map
    (reference ``decode_intervention_array``, serverstate.py:425-439)."""
    result: Dict[str, np.ndarray] = {}
    for channels in (decode_intervention(iv, layer_shapes)
                     for iv in (interventions or [])):
        for layer, channel in channels.items():
            if layer not in result:
                result[layer] = channel
                continue
            accum = result[layer]
            newalpha = 1 - (1 - channel[:1]) * (1 - accum[:1])
            newvalue = (accum[1:] * accum[:1] * (1 - channel[:1])
                        + channel[1:] * channel[:1]) / (newalpha + 1e-40)
            accum[:1] = newalpha
            accum[1:] = newvalue
    return result


def img2base64(img_u8: np.ndarray, for_html: bool = True) -> str:
    """JPEG-in-base64 (reference ``img2base64``, serverstate.py:480-491)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, format="JPEG", quality=92)
    prefix = "data:image/jpeg;base64," if for_html else ""
    return prefix + base64.b64encode(buf.getvalue()).decode()




def _u8_row(imgs: torch.Tensor) -> torch.Tensor:
    """[n, 3, H, W] in [0,1] -> [H, n*W, 3] uint8 on the images' device:
    the frames side by side, clipped, scaled by 255 and truncated (the JAX
    package's ``(np.hstack(...) * 255).astype(np.uint8)``)."""
    x = torch.clamp(imgs.float().permute(0, 2, 3, 1), 0.0, 1.0)
    n, h, w, c = x.shape
    return (x.permute(1, 0, 2, 3).reshape(h, n * w, c) * 255).to(torch.uint8)


class DissectionSession:
    """Server-side state: one dissected (model, layer) + its report.

    ``stats`` (optional) is the ``tally_stats`` dict; with it the session
    can answer quantile-level queries (reference ``GET /levels``)."""

    def __init__(self, inst: InstrumentedModel, layer: str, report: Dict,
                 outdir: Optional[Path] = None, stats: Optional[Dict] = None):
        self.inst = inst
        self.layer = layer
        self.report = report
        self.outdir = Path(outdir) if outdir else None
        self.units = len(report["units"])
        # Unit indices are report-relative: the tally covers channels
        # [0, n_channels) even when the report lists fewer rows.
        self.n_channels = max(r["unit"] for r in report["units"]) + 1
        self.stats = stats
        # the persistent intervention set (GanTester-style project state),
        # applied by compare/generate_records until replaced
        self.interventions: List[Dict] = []
        self._stdz: Optional[np.ndarray] = None

    # -- request validation (ValueError -> HTTP 400) ------------------------
    def check_ids(self, ids) -> list:
        n = int(self.report["n_samples"])
        ids = [int(i) for i in ids]
        for i in ids:
            if not 0 <= i < n:
                raise ValueError(f"sample id {i} out of range [0, {n})")
        return ids

    def check_units(self, units) -> Optional[list]:
        if units is None:
            return None
        units = [int(u) for u in units]
        for u in units:
            if not 0 <= u < self.n_channels:
                raise ValueError(
                    f"unit {u} out of range [0, {self.n_channels})")
        return units

    # -- live generation ----------------------------------------------------
    @torch.no_grad()
    def generate(self, seed: int = 0, n: int = 4, units=(),
                 strength: float = 1.0) -> np.ndarray:
        """[n] samples with ``units`` ablated by ``strength`` -> uint8 grid."""
        model = self.inst.model
        self.inst.remove_edits()
        if len(units):
            units = self.check_units(units)
            alpha = np.zeros((self.n_channels,), np.float32)
            alpha[np.asarray(units, np.int64)] = strength
            self.inst.edit_layer(self.layer, ablation=alpha)
        try:
            grid = _u8_row(model.forward(model.sample_latent(n, seed=seed)))
        finally:
            self.inst.remove_edits()
        return grid.cpu().numpy()

    # -- report-derived queries (reference serverstate.py API) --------------
    def layers(self) -> list:
        """Layer name + channel count + spatial shape (``get_layers``)."""
        shape = getattr(self.inst, "feature_shape", {}).get(self.layer)
        spatial = (list(shape[2:]) if shape is not None and len(shape) == 4
                   else [1, 1])
        return [{"layer": self.layer, "channels": self.units,
                 "shape": spatial}]

    def rankings(self) -> list:
        """Named per-unit score vectors, unit-indexed (``get_rankings``)."""
        by_unit = sorted(self.report["units"], key=lambda r: r["unit"])
        out = [{"name": "iou", "metric": "iou",
                "scores": [r["iou"] for r in by_unit]},
               {"name": "activation level", "metric": "level",
                "scores": [r["activation_level"] for r in by_unit]}]
        if "iqr" in by_unit[0]:
            out.append({"name": "iqr", "metric": "iqr",
                        "scores": [r["iqr"] for r in by_unit]})
        if "iqr_score" in by_unit[0]:
            out.append({"name": "max iqr", "metric": "iqr",
                        "scores": [r["iqr_score"] for r in by_unit]})
        return out

    def levels(self, quantiles) -> list:
        """[U, Q] activation values at the requested quantiles from the
        stats pass's sketch (``get_levels``); needs ``stats=``."""
        if not self.stats:
            raise ValueError(
                "session built without stats; pass stats=tally_stats(...)")
        qs = np.clip(np.asarray(quantiles, np.float64), 0.0, 1.0)
        return np.asarray(self.stats["quantiles"].quantiles(qs)).tolist()

    def _regenerate(self, ids) -> torch.Tensor:
        """Latents for report sample indices, reproducing the stats pass's
        seed-per-batch draw geometry (``dissect.regenerate_sample``)."""
        from ganspace_tpu_torch.dissection.dissect import regenerate_sample
        model = self.inst.model
        seed = int(self.report.get("seed", 1))
        batch = int(self.report.get("batch", 16))
        n_samples = int(self.report["n_samples"])
        return torch.cat([regenerate_sample(model, int(s), seed=seed, batch=batch,
                                            n_samples=n_samples) for s in ids])

    @torch.no_grad()
    def _activations(self, ids, interventions) -> torch.Tensor:
        """The tap's [n, U, h, w] activations for report samples ``ids``,
        under ``interventions`` when given."""
        self.inst.retain_layer(self.layer)
        z = self._regenerate(ids)
        try:
            if interventions:
                self._apply_interventions(interventions)
            self.inst.model.partial_forward(z, self.layer)
        finally:
            if interventions:
                self.inst.remove_edits()
        act = self.inst.retained_features()[self.layer].float()
        if act.ndim == 2:
            act = act[:, :, None, None]
        return act

    def features(self, ids, units=None, interventions=None) -> Dict:
        """Per-unit activation stats (max/mean over the map) for report
        sample indices (``get_features``); with ``interventions`` the
        stats reflect the edited network."""
        act = self._activations(ids, interventions)
        if units is not None:
            act = act[:, torch.as_tensor(units, dtype=torch.int64, device=act.device)]
        return {self.layer: {"max": act.amax(dim=(2, 3)).cpu().tolist(),
                             "mean": act.mean(dim=(2, 3)).cpu().tolist()}}

    def featuremaps(self, ids, units=None, interventions=None) -> Dict:
        """Level-normalized activation maps scaled 0-255 (``get_featuremaps``):
        each unit's map divided by its dissection activation level, so 255 =
        'at or above the threshold that defines this unit on'."""
        act = self._activations(ids, interventions)
        levels = np.ones((act.shape[1],), np.float32)
        for r in self.report["units"]:
            levels[r["unit"]] = max(r["activation_level"], 1e-9)
        if units is not None:
            sel = np.asarray(units, np.int64)
            act, levels = act[:, torch.as_tensor(sel, device=act.device)], levels[sel]
        maps = torch.clamp(act / torch.as_tensor(levels, device=act.device)[None, :, None, None],
                           0.0, 1.0)
        return {self.layer: (maps * 255).to(torch.uint8).cpu().tolist()}

    @torch.no_grad()
    def overlay(self, unit: int, seed: int = 0) -> np.ndarray:
        """Activation overlay of one unit on one sample -> uint8 image."""
        from ganspace_tpu_torch.dissection.viz import activation_overlay
        (unit,) = self.check_units([unit])
        model = self.inst.model
        self.inst.retain_layer(self.layer)
        img = model.forward(model.sample_latent(1, seed=seed))[0].cpu().numpy()
        act = self.inst.retained_features()[self.layer][0].float().cpu().numpy()
        if act.ndim == 1:
            act = act[:, None, None]
        return (activation_overlay(img, act[unit]) * 255).astype(np.uint8)

    # -- GanTester-style interventions --------------------------------------
    def layer_shapes(self) -> Dict[str, tuple]:
        """{layer: (1, C, H, W)} for intervention decoding."""
        shape = getattr(self.inst, "feature_shape", {}).get(self.layer)
        if shape is not None and len(shape) == 4:
            return {self.layer: (1, shape[1], shape[2], shape[3])}
        return {self.layer: (1, self.n_channels, 1, 1)}

    def standard_z(self, size: int) -> np.ndarray:
        """Prefix-stable standard z set (reference ``standard_z_sample``:
        id i is the same z regardless of how many are requested)."""
        if self._stdz is None or len(self._stdz) < size:
            z = self.inst.model.sample_latent(max(size, 2 * size), seed=1)
            self._stdz = z.cpu().numpy().astype(np.float32).reshape(z.shape[0], -1)
        return self._stdz[:size]

    def set_interventions(self, interventions: List[Dict]) -> None:
        """Validate + store the persistent intervention set."""
        decode_intervention_array(interventions, self.layer_shapes())
        self.interventions = list(interventions or [])

    def _apply_interventions(self, interventions) -> bool:
        """Install the blended (alpha, value) maps as layer edits; returns
        True when any edit was installed."""
        blended = decode_intervention_array(interventions, self.layer_shapes())
        self.inst.remove_edits()
        for layer, arr in blended.items():
            self.inst.edit_layer(layer, ablation=arr[0], replacement=arr[1])
        return bool(blended)

    @torch.no_grad()
    def generate_records(self, zs=None, ids=None, interventions=None,
                         want_b64: bool = True) -> List[Dict]:
        """A batch of images for explicit ``zs`` or standard-set ``ids``
        (reference ``DissectionProject.generate_images``), with the given
        (or the persistent) intervention set applied; each record carries a
        base64 JPEG (or the uint8 image) under ``d``, and ``id`` when ids
        were given."""
        model = self.inst.model
        if ids is not None:
            assert zs is None
            ids = [int(i) for i in ids]
            if not 1 <= len(ids) <= 64:
                raise ValueError("ids batch must have 1..64 entries")
            for i in ids:
                # negative ids would index from the end; huge ids would
                # drive standard_z into an unbounded allocation
                if not 0 <= i < 10_000:
                    raise ValueError(
                        f"standard-z id {i} out of range [0, 10000)")
            zs = self.standard_z(max(ids) + 1)[np.asarray(ids)]
        try:
            zs = np.asarray(zs, np.float32)
        except (ValueError, TypeError) as e:
            raise ValueError(f"zs must be a numeric array: {e}")
        zdim = int(np.prod(model.get_latent_shape()))
        if zs.ndim != 2 or zs.shape[1] != zdim:
            raise ValueError(f"zs must be [n, {zdim}], got {zs.shape}")
        if not 1 <= zs.shape[0] <= 64:
            raise ValueError("zs batch must have 1..64 rows")
        if not np.isfinite(zs).all():
            raise ValueError("zs must be finite")
        if interventions is None:
            interventions = self.interventions
        try:
            self._apply_interventions(interventions)
            imgs = model.forward(torch.from_numpy(zs).to(model.device))
        finally:
            self.inst.remove_edits()
        frames = [_u8_row(img[None]).cpu().numpy() for img in imgs]
        out = []
        for i, img in enumerate(frames):
            rec = {"d": img2base64(img) if want_b64 else img}
            if ids is not None:
                rec["id"] = ids[i]
            out.append(rec)
        return out

    @torch.no_grad()
    def compare(self, seed: int = 0, n: int = 4,
                interventions=None) -> np.ndarray:
        """Image compare strip: clean row over intervened row -> uint8 image."""
        model = self.inst.model
        z = model.sample_latent(n, seed=seed)
        if interventions is None:
            interventions = self.interventions
        self.inst.remove_edits()
        clean = model.forward(z)
        try:
            self._apply_interventions(interventions)
            edited = model.forward(z)
        finally:
            self.inst.remove_edits()
        return torch.cat([_u8_row(clean), _u8_row(edited)]).cpu().numpy()

    # -- recipes: interventions saved as project state ----------------------
    def _recipe_dir(self) -> Path:
        if self.outdir is None:
            raise ValueError("session has no project directory (outdir)")
        d = self.outdir / "recipe"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def save_recipe(self, name: str, recipe: Dict) -> str:
        if not re.fullmatch(r"[A-Za-z0-9_\-]{1,64}", name or ""):
            raise ValueError("recipe name must be [A-Za-z0-9_-]{1,64}")
        path = self._recipe_dir() / f"{name}.json"
        path.write_text(json.dumps({"name": name, **recipe}, indent=1))
        return str(path)

    def recipes(self) -> List[Dict]:
        if self.outdir is None or not (self.outdir / "recipe").is_dir():
            return []
        return [json.loads(f.read_text())
                for f in sorted((self.outdir / "recipe").glob("*.json"))]

    def apply_recipe(self, name: str) -> List[Dict]:
        """Restore a saved recipe's interventions as the persistent set."""
        for r in self.recipes():
            if r.get("name") == name:
                self.set_interventions(r.get("interventions") or [])
                return self.interventions
        raise ValueError(f"no recipe named {name!r}")


_PAGE = """<!DOCTYPE html>
<html><head><title>dissect: {model}/{layer}</title><style>
body {{ font-family: sans-serif; background: #181818; color: #ddd; margin: 20px; }}
td, th {{ padding: 3px 10px; text-align: left; }}
img {{ image-rendering: auto; }}
input, button {{ margin: 2px; }}
a {{ color: #7ab6f5; }}
</style></head><body>
<h2>{model} — {layer}</h2>
<p>{n_samples} samples; click a unit to ablate it in the live panel.</p>
<div>
  <b>live edit</b>:
  units <input id="units" size="20" value=""/>
  strength <input id="strength" size="4" value="1.0"/>
  value <input id="value" size="4" value="0.0"/>
  seed <input id="seed" size="6" value="0"/>
  <button onclick="gen()">generate</button>
  <button onclick="setiv()">set intervention</button>
  <button onclick="cmp()">compare</button>
  recipe <input id="recipe" size="10" value="edit1"/>
  <button onclick="save()">save recipe</button>
</div>
<img id="live" src="/api/generate?seed=0&n=4"/>
<div><img id="compare"/></div>
<table id="tbl"><tr><th>unit</th><th>label</th><th>category</th><th>iou</th>
<th>overlay</th></tr></table>
<script>
async function load() {{
  const r = await (await fetch('/api/units?n=24')).json();
  const tbl = document.getElementById('tbl');
  for (const u of r.units) {{
    const tr = document.createElement('tr');
    tr.innerHTML = `<td><a href="#" onclick="add(${{u.unit}});return false;">` +
      `${{u.unit}}</a></td><td>${{u.label}}</td><td>${{u.category}}</td>` +
      `<td>${{u.iou.toFixed(3)}}</td>` +
      `<td><img src="/api/overlay?unit=${{u.unit}}&seed=0" height="64"/></td>`;
    tbl.appendChild(tr);
  }}
}}
function add(u) {{
  const el = document.getElementById('units');
  el.value = el.value ? el.value + ',' + u : '' + u;
  gen();
}}
async function gen() {{
  const u = document.getElementById('units').value;
  const s = document.getElementById('strength').value;
  const seed = document.getElementById('seed').value;
  document.getElementById('live').src =
    `/api/generate?seed=${{seed}}&n=4&units=${{u}}&strength=${{s}}&t=` + Date.now();
}}
function iv() {{
  const s = parseFloat(document.getElementById('strength').value);
  const v = parseFloat(document.getElementById('value').value);
  const abl = document.getElementById('units').value.split(',')
    .filter(x => x.trim()).map(u => ({{layer: '{layer}', unit: parseInt(u),
                                      alpha: s, value: v}}));
  return [{{ablations: abl}}];
}}
async function setiv() {{
  await fetch('/api/interventions', {{method: 'POST',
    body: JSON.stringify({{interventions: iv()}})}});
  cmp();
}}
function cmp() {{
  const seed = document.getElementById('seed').value;
  document.getElementById('compare').src =
    `/api/compare?seed=${{seed}}&n=4&t=` + Date.now();
}}
async function save() {{
  await setiv();
  await fetch('/api/recipe', {{method: 'POST', body: JSON.stringify(
    {{name: document.getElementById('recipe').value,
      interventions: iv()}})}});
}}
load();
</script></body></html>
"""


def serve(session: DissectionSession, host: str = "127.0.0.1",
          port: int = 8088, block: bool = True):
    """Start the server; returns the (running) HTTPServer instance."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from PIL import Image

    lock = threading.Lock()

    def jpeg(arr: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=92)
        return buf.getvalue()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)

            def qi(name, default):
                return int(q.get(name, [default])[0] or default)

            def qf(name, default):
                return float(q.get(name, [default])[0] or default)

            if url.path == "/":
                page = _PAGE.format(
                    model=session.report["model"], layer=session.layer,
                    n_samples=session.report["n_samples"])
                self._send(200, page.encode())
            elif url.path == "/api/report":
                body = json.dumps({k: v for k, v in session.report.items()
                                   if k != "iou_matrix"}).encode()
                self._send(200, body, "application/json")
            elif url.path == "/api/units":
                n = qi("n", 20)
                body = json.dumps(
                    {"units": session.report["units"][:n]}).encode()
                self._send(200, body, "application/json")
            elif url.path == "/api/layers":
                self._send(200, json.dumps({"layers": session.layers()})
                           .encode(), "application/json")
            elif url.path == "/api/rankings":
                self._send(200, json.dumps({"rankings": session.rankings()})
                           .encode(), "application/json")
            elif url.path == "/api/levels":
                try:
                    quantiles = [float(v) for v in
                                 q.get("quantiles", [""])[0].split(",")
                                 if v.strip()]
                    if not quantiles:
                        raise ValueError("pass ?quantiles=0.9,0.99,...")
                    body = json.dumps({"levels": session.levels(quantiles)})
                except ValueError as e:
                    self._send(400, str(e).encode(), "text/plain")
                    return
                self._send(200, body.encode(), "application/json")
            elif url.path == "/api/generate":
                try:
                    units = session.check_units(
                        [u for u in q.get("units", [""])[0].split(",")
                         if u.strip()])
                    n = qi("n", 4)
                    if not 1 <= n <= 64:
                        raise ValueError("n must be in [1, 64]")
                    with lock:
                        grid = session.generate(
                            seed=qi("seed", 0), n=n, units=units,
                            strength=qf("strength", 1.0))
                except ValueError as e:
                    self._send(400, f"bad request: {e}".encode(), "text/plain")
                    return
                self._send(200, jpeg(grid), "image/jpeg")
            elif url.path == "/api/overlay":
                try:
                    with lock:
                        img = session.overlay(qi("unit", 0),
                                              seed=qi("seed", 0))
                except ValueError as e:
                    self._send(400, f"bad request: {e}".encode(), "text/plain")
                    return
                self._send(200, jpeg(img), "image/jpeg")
            elif url.path == "/api/compare":
                try:
                    n = qi("n", 4)
                    if not 1 <= n <= 64:
                        raise ValueError("n must be in [1, 64]")
                    with lock:
                        strip = session.compare(seed=qi("seed", 0), n=n)
                except ValueError as e:
                    self._send(400, f"bad request: {e}".encode(), "text/plain")
                    return
                self._send(200, jpeg(strip), "image/jpeg")
            elif url.path == "/api/interventions":
                self._send(200, json.dumps(
                    {"interventions": session.interventions}).encode(),
                    "application/json")
            elif url.path == "/api/recipes":
                self._send(200, json.dumps(
                    {"recipes": session.recipes()}).encode(),
                    "application/json")
            elif url.path == "/api/recipe/apply":
                try:
                    with lock:
                        ivs = session.apply_recipe(
                            q.get("name", [""])[0])
                except ValueError as e:
                    self._send(400, f"bad request: {e}".encode(),
                               "text/plain")
                    return
                self._send(200, json.dumps(
                    {"ok": True, "interventions": ivs}).encode(),
                    "application/json")
            elif url.path.startswith("/image/") and session.outdir:
                f = session.outdir / "image" / Path(url.path).name
                if f.is_file():
                    self._send(200, f.read_bytes(), "image/png")
                else:
                    self._send(404, b"not found", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            url = urlparse(self.path)
            posts = ("/api/features", "/api/featuremaps", "/api/generate",
                     "/api/interventions", "/api/recipe")
            if url.path not in posts:
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length))
                if not isinstance(body, dict):
                    raise ValueError("request must be a JSON object")
                if url.path == "/api/interventions":
                    # persistent GanTester-style intervention set
                    with lock:
                        session.set_interventions(
                            body.get("interventions") or [])
                    res = {"ok": True,
                           "interventions": session.interventions}
                elif url.path == "/api/recipe":
                    ivs = body.get("interventions", session.interventions)
                    # malformed intervention sets must not land on disk
                    decode_intervention_array(ivs, session.layer_shapes())
                    res = {"saved": session.save_recipe(
                        body["name"],
                        {"interventions": ivs,
                         **{k: v for k, v in body.items()
                            if k not in ("name", "interventions")}})}
                elif url.path == "/api/generate":
                    ids = body.get("ids")
                    zs = body.get("zs")
                    if (ids is None) == (zs is None):
                        raise ValueError("pass exactly one of ids / zs")
                    iv = body.get("interventions")
                    with lock:
                        recs = session.generate_records(
                            zs=zs, ids=ids, interventions=iv)
                    res = {"images": recs}
                else:
                    ids = session.check_ids(body["ids"])
                    units = session.check_units(body.get("units"))
                    iv = body.get("interventions")
                    with lock:
                        if url.path == "/api/features":
                            res = {"res": session.features(ids, units, iv)}
                        else:
                            res = {"res": session.featuremaps(ids, units,
                                                              iv)}
            except (ValueError, TypeError, KeyError) as e:
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            self._send(200, json.dumps(res).encode(), "application/json")

    server = ThreadingHTTPServer((host, port), Handler)
    print(f"dissection server at http://{host}:{server.server_address[1]}/")
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
