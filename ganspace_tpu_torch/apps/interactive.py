"""Interactive exploration session + web viewer (``ganspace_tpu/apps/interactive.py``,
reference ``interactive.py``).

The reference drives a Tk window with a CUDA-GL canvas (``TkTorchWindow.py``).
As in the JAX package, the port splits it in two:

* :class:`Session`: the headless state machine holding everything the Tk UI
  held: component sliders, edit mode, W+ layer window, truncation, batch,
  class, seed; the lazy ``ParamCache`` recompute; named-direction import;
  provenance-rich direction export.  Testable without a display.
* :func:`serve`: a stdlib HTTP server exposing the session as a single-page
  slider UI; rendered frames leave the card once per edit as uint8, then
  JPEG bytes.

Edit math mirrors ``interactive.py:412-477``: slider sigma x stdev x
component, accumulated globally or per layer window, activation deltas via
``edit_layer`` offsets.

The viewer process runs at the preview policy of ``ops/precision.py`` by
default (the bf16 datapath and bf16 activation storage), as the JAX
viewer does; ``--dtype float32`` pins full precision.  Component fits run
through ``get_or_compute``, whose ``compute`` pins float32 storage, so a
viewer never writes a preview-grade cache.

    python -m ganspace_tpu_torch interactive --model StyleGAN2 --class ffhq \\
        --layer style --use_w --port 8080
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ganspace_tpu_torch import directions as dirlib
from ganspace_tpu_torch import require_device
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute, read_meta
from ganspace_tpu_torch.imaging import frame_u8
from ganspace_tpu_torch.models import get_instrumented_model


def get_edit_name(idx, s, e, name=None):
    """Paper syntax E(comp, range) (reference ``interactive.py:45-50``)."""
    return "E({comp}, {edit_range}){edit_name}".format(
        comp=idx,
        edit_range=f"{s}-{e}" if e > s else s,
        edit_name=f": {name}" if name else "",
    )


class ParamCache:
    """Dirty-tracking for lazy recomputation (reference ``interactive.py:385-396``)."""

    def update(self, **kwargs) -> bool:
        dirty = False
        for argname, val in kwargs.items():
            current = getattr(self, argname, 0)
            if current is not val and pickle.dumps(current) != pickle.dumps(val):
                setattr(self, argname, val)
                dirty = True
        return dirty


class FrameCache:
    """Bounded LRU of rendered uint8 frames keyed by edit-state digest."""

    def __init__(self, capacity: int = 64):
        self._d = OrderedDict()
        self.capacity = capacity
        self.hits = 0
        self.misses = 0

    def get(self, key):
        frame = self._d.get(key)
        if frame is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return frame

    def put(self, key, frame) -> None:
        self._d[key] = frame
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Session:
    def __init__(self, args: Config, n_sliders: int = 70,
                 preview_size: Optional[int] = None):
        self.args = args
        # Downscale frames on the card before the copy to the host (None:
        # native size).
        self.preview_size = preview_size
        self.model_name = args.model
        self.layer_name = args.layer
        self.inst = get_instrumented_model(args.model, args.output_class, args.layer,
                                           require_device(args.device), use_w=args.use_w)
        self.model = self.inst.model
        self.device = self.model.device
        self.use_named_latents = False
        self.state = SimpleNamespace(z=None, seed=0, base_act=None,
                                     component_class=None,
                                     lat_slider_offset=0, act_slider_offset=0)
        self.cache = ParamCache()
        self.truncation = 0.9
        self.mode = "latent"
        self.batch_size = 1
        self.edit_layer_start = 0
        self.edit_layer_end = self.model.get_max_latents()  # exclusive
        self.img = None

        # Speculative frame queue: rendered frames are memoized by edit-state
        # digest, and an idle worker pre-renders the neighbouring positions
        # of the last-moved slider (the UI quantizes drags to 0.1 steps).
        self.lock = threading.RLock()
        self.frame_cache = FrameCache()
        self.speculate_step = 0.1            # the web UI's slider step
        self.speculate_neighbors = (1, -1, 2, -2)
        self._prev_sliders = None
        self._last_moved: Optional[int] = None
        self._spec_gen = 0
        self._spec_event = threading.Event()
        self._spec_stop = threading.Event()
        self._user_waiting = threading.Event()
        self._spec_thread: Optional[threading.Thread] = None

        if args.inputs:
            self.load_named_components(args.inputs, args.output_class)
        else:
            self.load_components(args.output_class)
        self.n_sliders = min(n_sliders, len(self.components.names))
        self.sliders = np.zeros(self.n_sliders, np.float32)
        self.resample_latent(seed=0)

    # -- components ----------------------------------------------------------
    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def load_components(self, class_name):
        config = self.args.from_dict({"output_class": class_name})
        dump_name = get_or_compute(config, self.inst)
        with np.load(dump_name, allow_pickle=False) as data:
            n_comp = data["act_comp"].shape[0]
            self.components = SimpleNamespace(
                X_comp=self._on_device(data["act_comp"]),
                X_mean=self._on_device(data["act_mean"]),
                X_stdev=np.asarray(data["act_stdev"]),
                Z_comp=self._on_device(data["lat_comp"]),
                Z_mean=self._on_device(data["lat_mean"]),
                Z_stdev=np.asarray(data["lat_stdev"]),
                names=[f"Component {i}" for i in range(n_comp)],
                types=[None] * n_comp,
                layer_names=[self.layer_name] * n_comp,
                latent_types=[self.model.latent_space_name()] * n_comp,
                ranges=[(0, self.model.get_max_latents())] * n_comp,
            )
            meta = read_meta(data)
        # the spectrum-derived bf16 grading of the cache, in the page header
        self.component_quality_note = ""
        if meta and meta.get("bf16_analysis_grade") is False:
            bad = sum(b < 0.99 for b in meta.get("bf16_cos_bounds", []))
            self.component_quality_note = (
                f"preview-precision components: {bad}/{n_comp} below the 0.99 bf16 "
                f"cosine bound (re-run without --dtype bfloat16 for analysis grade)")
        self.state.component_class = class_name
        self.use_named_latents = False
        print("Loaded components for", class_name, "from", dump_name)

    def load_named_components(self, path, class_name):
        selected = dirlib.load_named_components(
            path, self.model_name, class_name,
            latent_space=self.model.latent_space_name())
        if not selected:
            raise RuntimeError("No valid components in given path.")
        comp = SimpleNamespace(X_comp=[], Z_comp=[], X_stdev=[], Z_stdev=[],
                               names=[], types=[], layer_names=[], ranges=[],
                               latent_types=[])
        for d in selected:
            s, e = d["edit_start"], d["edit_end"]
            comp.X_comp.append(self._on_device(d["act_comp"]))
            comp.Z_comp.append(self._on_device(d["lat_comp"]))
            comp.X_stdev.append(d["act_stdev"])
            comp.Z_stdev.append(d["lat_stdev"])
            comp.names.append(get_edit_name(d["component_index"], s, e - 1, d["name"]))
            comp.types.append(d["edit_type"])
            comp.layer_names.append(d["decomposition"]["layer"])
            comp.ranges.append((s, e))
            comp.latent_types.append(d["latent_space"])
        self.components = comp
        self.use_named_latents = True
        print("Loaded named components")

    # -- state ---------------------------------------------------------------
    def resample_latent(self, seed: Optional[int] = None):
        b = self.batch_size
        self.state.seed = (np.random.randint(np.iinfo(np.int32).max - b)
                           if seed is None else seed)
        # Consecutive seeds along the batch (reference interactive.py:349-352).
        latents = [self.model.sample_latent(1, seed=self.state.seed + i,
                                            truncation=self.truncation)
                   for i in range(b)]
        self.state.z = torch.cat(latents)
        if hasattr(self.model, "truncation"):
            self.model.truncation = self.truncation
        self.inst.retain_layer(self.layer_name)
        self.model.partial_forward(self.state.z, self.layer_name)
        feat = self.inst.retained_features()[self.layer_name]
        if feat is None:
            # The mapping-output tap in W mode: the mapping does not run, so
            # the tap cannot fire; the features there are the W latents.
            feat = self.state.z
        self.state.base_act = feat
        self.reset_sliders(zero_on_failure=False)

    def set_class(self, class_name):
        if str(class_name).isnumeric():
            class_name = int(class_name)
        if hasattr(self.model, "is_valid_class") and not self.model.is_valid_class(class_name):
            return False
        self.model.set_output_class(class_name)
        return True

    def recompute_components(self, class_name):
        if self.set_class(class_name):
            self.load_components(self.model.outclass)

    def zero_sliders(self):
        self.sliders[:] = 0.0

    def reset_sliders(self, zero_on_failure=True):
        # The reference ships with back-projection disabled
        # (interactive.py:165-209, `enabled = False`); kept that way.
        self.state.lat_slider_offset = 0
        self.state.act_slider_offset = 0
        if zero_on_failure:
            self.zero_sliders()

    def project_ortho(self, x, comp):
        """Coordinates of x in the orthonormal basis (``interactive.py:156-159``)."""
        n = comp.shape[0]
        x = torch.as_tensor(x, dtype=torch.float32, device=comp.device)
        coords = torch.sum(comp.reshape(n, -1) * x.reshape(1, -1), dim=1)
        return _host(coords)

    def warmup(self) -> None:
        """Render the hot frame kinds once each (no edit, latent edit,
        activation edit) before the first request: in the eager port this
        builds the kernels and warms cuDNN's autotuner where the JAX viewer
        compiles.  The session's state is restored."""
        saved = self.sliders.copy()
        saved_mode = self.mode
        try:
            for mode in ("latent", "activation"):
                self.mode = mode
                self.sliders[:] = 0.0
                self.render(force=True)
                self.sliders[0] = 1.0
                self.render(force=True)
        finally:
            self.sliders[:] = saved
            self.mode = saved_mode
            self.inst.remove_edits()
            self.render(force=True)

    # -- rendering -----------------------------------------------------------
    def render(self, force=False) -> np.ndarray:
        """Recompute the image if any edit parameter changed (reference
        ``on_draw``, ``interactive.py:412-477``); serves a speculatively
        pre-rendered frame when one matches."""
        with self.lock:
            latent_start, latent_end = self.edit_layer_start, self.edit_layer_end
            dirty = self.cache.update(coords=self.sliders.copy(),
                                      comp=self.state.component_class,
                                      mode=self.mode,
                                      z=_host(self.state.z),
                                      s=latent_start, e=latent_end)
            if dirty and self._prev_sliders is not None:
                changed = np.nonzero(self.sliders != self._prev_sliders)[0]
                if len(changed) == 1:
                    self._last_moved = int(changed[0])
            self._prev_sliders = self.sliders.copy()
            if not (dirty or force) and self.img is not None:
                return self.img
            key = self._frame_key(self.sliders)
            if not force:
                hit = self.frame_cache.get(key)
                if hit is not None:
                    self.img = hit
                    self._poke_speculation()
                    return hit
            img = self._compute_frame(self.sliders, latent_start, latent_end)
            self.frame_cache.put(key, img)
            self.img = img
            self._poke_speculation()
            return img

    def _frame_key(self, sliders) -> bytes:
        """Digest of everything a frame depends on.  Slider values round to
        1e-5 so a speculated grid position and the UI's float of the same
        position share a key."""
        h = hashlib.sha1()
        h.update(np.round(np.asarray(sliders, np.float64), 5).tobytes())
        h.update(np.asarray(_host(self.state.z), np.float32).tobytes())
        for off in (self.state.lat_slider_offset, self.state.act_slider_offset):
            if isinstance(off, (np.ndarray, torch.Tensor)):
                h.update(np.asarray(_host(off), np.float32).tobytes())
            else:
                h.update(str(off).encode())
        h.update(f"{self.mode}|{self.edit_layer_start}|{self.edit_layer_end}|"
                 f"{self.truncation}|{self.state.component_class}|"
                 f"{self.use_named_latents}|{self.preview_size}".encode())
        return h.digest()

    def _compute_frame(self, sliders, latent_start, latent_end) -> np.ndarray:
        """The card's render for an explicit slider vector (no caching)."""
        c = self.components
        z_base = self.state.z - self.state.lat_slider_offset
        n_latent = self.model.get_max_latents()
        z_deltas = [0.0] * n_latent
        z_delta_global = 0.0
        act_deltas = {}

        if isinstance(self.state.act_slider_offset, torch.Tensor):
            act_deltas[self.layer_name] = -self.state.act_slider_offset

        for space in c.latent_types:
            if space != self.model.latent_space_name():
                raise ValueError("Cannot mix latent spaces (for now)")

        for ci in range(self.n_sliders):
            coord = float(sliders[ci])
            if coord == 0:
                continue
            edit_mode = c.types[ci] if self.use_named_latents else self.mode

            if edit_mode in ("activation", "both"):
                delta = c.X_comp[ci] * float(c.X_stdev[ci]) * coord
                name = c.layer_names[ci]
                act_deltas[name] = act_deltas.get(name, 0.0) + delta

            if edit_mode in ("latent", "both"):
                delta = c.Z_comp[ci] * float(c.Z_stdev[ci]) * coord
                edit_range = (c.ranges[ci] if self.use_named_latents
                              else (latent_start, latent_end))
                if edit_range == (0, n_latent):
                    z_delta_global = z_delta_global + delta
                else:
                    for lat in range(*edit_range):
                        z_deltas[lat] = z_deltas[lat] + delta

        self.inst.remove_edits()
        for layer, delta in act_deltas.items():
            self.inst.edit_layer(layer, offset=delta)

        has_offsets = any(isinstance(t, torch.Tensor) for t in z_deltas)
        z_final = z_base + z_delta_global
        if has_offsets:
            z_final = [z_final + d for d in z_deltas]
        img = self.model.forward(z_final)
        # quantize on the card: the frame crosses to the host as uint8 HWC
        return frame_u8(img, max_hw=self.preview_size)

    # -- speculative frame queue --------------------------------------------
    def start_speculation(self) -> None:
        """Start the idle pre-render worker (used by ``serve``)."""
        if self._spec_thread is not None:
            return
        self._spec_stop.clear()
        self._spec_thread = threading.Thread(target=self._speculate_loop, daemon=True,
                                             name="ganspace-speculate")
        self._spec_thread.start()

    def stop_speculation(self) -> None:
        if self._spec_thread is None:
            return
        self._spec_stop.set()
        self._spec_event.set()
        self._spec_thread.join(timeout=5)
        self._spec_thread = None

    def _poke_speculation(self) -> None:
        self._spec_gen += 1
        self._spec_event.set()

    def _speculate_once(self, gen: Optional[int] = None) -> int:
        """Pre-render the neighbouring positions of the last-moved slider;
        returns how many frames were added.  Aborts between neighbours when
        a newer interaction supersedes ``gen`` or a user request is waiting
        on the lock.  Every read of the frame state happens under the lock,
        so the cache key and the rendered frame always agree."""
        moved = self._last_moved
        if moved is None:
            return 0
        base = self.sliders.copy()
        added = 0
        for step in self.speculate_neighbors:
            if gen is not None and (self._spec_gen != gen or self._spec_stop.is_set()
                                    or self._user_waiting.is_set()):
                break
            trial = base.copy()
            trial[moved] = np.float32(round(float(base[moved]) + step * self.speculate_step, 5))
            with self.lock:
                if gen is not None and self._spec_gen != gen:
                    break
                # the edit window is read inside the lock: the key digests
                # the live window, so the frame is rendered with the same
                s, e = self.edit_layer_start, self.edit_layer_end
                key = self._frame_key(trial)
                if self.frame_cache._d.get(key) is not None:
                    continue
                self.frame_cache.put(key, self._compute_frame(trial, s, e))
                added += 1
        return added

    def _speculate_loop(self) -> None:
        while not self._spec_stop.is_set():
            if not self._spec_event.wait(timeout=0.5):
                continue
            self._spec_event.clear()
            gen = self._spec_gen
            time.sleep(0.02)           # let a drag burst settle
            if self._spec_gen != gen or self._spec_stop.is_set():
                continue
            self._speculate_once(gen)

    def render_np(self) -> np.ndarray:
        """[H, W*B, 3] uint8 tile of the current batch."""
        img = self.render()          # [B, H, W, 3] uint8
        return np.hstack(list(img))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_frame(self, iters: int = 11):
        """Median (synthesis_ms, readback_ms, total_ms) of a slider-drag
        frame: synthesis ends in a synchronize, the readback is the uint8
        frame's quantisation and copy to the host, the total is a render."""
        self.render(force=True)                       # warm
        synth, read, total = [], [], []
        for i in range(iters):
            self.sliders[0] = 0.05 * (i + 1)          # dirty the cache
            t0 = time.perf_counter()
            self.render(force=True)
            total.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            img = self.model.forward(self.state.z)
            self._sync()
            synth.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            frame_u8(img, max_hw=self.preview_size)
            read.append(time.perf_counter() - t0)
        self.sliders[0] = 0.0
        ms = lambda xs: 1e3 * float(np.median(xs))  # noqa: E731
        return ms(synth), ms(read), ms(total)

    def time_frame_speculative(self, iters: int = 9):
        """Median frame latency when the idle worker pre-rendered the next
        slider position (the perceived-latency companion of
        :meth:`time_frame`): a hit skips the card entirely."""
        self.render(force=True)
        hit_ms = []
        for i in range(iters):
            self.sliders[0] = np.float32(round(0.1 * (i + 1), 5))
            self.render()                 # the drag lands here...
            self._last_moved = 0
            self._speculate_once()        # ...the idle worker fills the neighbours
            self.sliders[0] = np.float32(round(0.1 * (i + 2), 5))
            t0 = time.perf_counter()
            self.render()
            hit_ms.append(time.perf_counter() - t0)
        self.sliders[0] = 0.0
        self.render()
        return 1e3 * float(np.median(hit_ms))

    # -- export --------------------------------------------------------------
    def export_direction(self, idx: int, name: str, sigma_range: float = 2.0,
                         out_dir=None) -> Path:
        c = self.components
        params = dirlib.direction_params(
            name=name, sigma_range=sigma_range, component_index=idx,
            act_comp=_host(c.X_comp[idx]),
            lat_comp=_host(c.Z_comp[idx]),
            latent_space=self.model.latent_space_name(),
            act_stdev=float(np.asarray(c.X_stdev[idx])),
            lat_stdev=float(np.asarray(c.Z_stdev[idx])),
            model_name=self.model_name,
            output_class=str(self.model.outclass),
            estimator=self.args.estimator, components=self.args.components,
            samples=self.args.n, layer=self.args.layer,
            component_class=str(self.state.component_class),
            edit_type=self.mode, truncation=self.truncation,
            edit_start=self.edit_layer_start, edit_end=self.edit_layer_end,
            example_seed=self.state.seed)
        out_dir = out_dir or (Path.cwd() / "out" / "directions")
        return dirlib.export_direction(params, out_dir)


# ---------------------------------------------------------------------------
# Web UI
# ---------------------------------------------------------------------------

_PAGE = """<!DOCTYPE html>
<html><head><title>ganspace-tpu</title><style>
body {{ font-family: sans-serif; display: flex; margin: 0; background: #181818; color: #ddd; }}
#panel {{ width: 280px; padding: 10px; overflow-y: scroll; height: 100vh; box-sizing: border-box; }}
#view {{ flex: 1; display: flex; align-items: center; justify-content: center; }}
#frame {{ max-width: 100%; max-height: 100vh; image-rendering: auto; }}
.slider {{ width: 100%; }}
label {{ font-size: 11px; }}
input, select, button {{ margin: 2px 0; }}
</style></head><body>
<div id="panel">
  <h3>ganspace-tpu</h3>
  <div style="color:#f5a97a">{quality_note}</div>
  <div>mode:
    <select id="mode"><option>latent</option><option>activation</option><option>both</option></select>
  </div>
  <div><label>layers <span id="rangelabel"></span></label><br/>
    <input type="range" id="lstart" min="0" max="{max_lat_m1}" value="0" class="slider"/>
    <input type="range" id="lend" min="0" max="{max_lat_m1}" value="{max_lat_m1}" class="slider"/></div>
  <div><label>truncation</label>
    <input type="range" id="trunc" min="0" max="1" step="0.05" value="0.9" class="slider"/></div>
  <div><label>seed</label> <input type="text" id="seed" size="10" value="0"/>
    <button onclick="resample()">resample</button></div>
  <div><label>class</label> <input type="text" id="cls" size="10" value="{outclass}"/>
    <button onclick="setcls()">apply</button></div>
  <button onclick="zero()">zero sliders</button>
  <div id="sliders"></div>
</div>
<div id="view"><img id="frame" src="/frame.jpg"/></div>
<script>
const N = {n_sliders}; const names = {names_json};
const panel = document.getElementById('sliders');
for (let i = 0; i < N; i++) {{
  const div = document.createElement('div');
  div.innerHTML = `<label>${{names[i]}}: <span id="v${{i}}">0.0</span></label>
    <input type="range" class="slider" id="s${{i}}" min="-10" max="10" step="0.1" value="0"/>`;
  panel.appendChild(div);
}}
let t = null;
function push() {{
  clearTimeout(t);
  t = setTimeout(async () => {{
    const sliders = [];
    for (let i = 0; i < N; i++) {{
      const v = parseFloat(document.getElementById('s'+i).value);
      document.getElementById('v'+i).textContent = v.toFixed(1);
      sliders.push(v);
    }}
    const body = {{sliders: sliders,
      mode: document.getElementById('mode').value,
      lstart: parseInt(document.getElementById('lstart').value),
      lend: parseInt(document.getElementById('lend').value),
      trunc: parseFloat(document.getElementById('trunc').value)}};
    document.getElementById('rangelabel').textContent = body.lstart + '-' + body.lend;
    await fetch('/state', {{method: 'POST', body: JSON.stringify(body)}});
    document.getElementById('frame').src = '/frame.jpg?' + Date.now();
  }}, 60);
}}
document.querySelectorAll('input,select').forEach(e => e.addEventListener('input', push));
async function resample() {{
  await fetch('/resample?seed=' + document.getElementById('seed').value); push();
}}
async function setcls() {{
  await fetch('/class?name=' + document.getElementById('cls').value); push();
}}
function zero() {{
  for (let i = 0; i < N; i++) document.getElementById('s'+i).value = 0; push();
}}
</script></body></html>
"""


def make_server(session: Session, host: str = "127.0.0.1", port: int = 8080):
    """Build the viewer's HTTP server (stdlib only); ``port=0`` binds an
    ephemeral port (tests).  Call ``.serve_forever()`` / ``.shutdown()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from PIL import Image

    lock = session.lock

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                page = _PAGE.format(
                    n_sliders=session.n_sliders,
                    names_json=json.dumps(session.components.names[:session.n_sliders]),
                    max_lat_m1=session.model.get_max_latents(),
                    outclass=str(session.model.outclass),
                    quality_note=getattr(session, "component_quality_note", ""))
                self._send(200, page.encode())
            elif url.path == "/frame.jpg":
                session._user_waiting.set()
                try:
                    with lock:
                        frame = session.render_np()
                finally:
                    session._user_waiting.clear()
                buf = io.BytesIO()
                Image.fromarray(frame).save(buf, format="JPEG", quality=92)
                self._send(200, buf.getvalue(), "image/jpeg")
            elif url.path == "/resample":
                q = parse_qs(url.query)
                seed = q.get("seed", [None])[0]
                with lock:
                    session.resample_latent(int(seed) if seed not in (None, "") else None)
                self._send(200, b"ok", "text/plain")
            elif url.path == "/class":
                q = parse_qs(url.query)
                with lock:
                    session.recompute_components(q.get("name", [""])[0])
                self._send(200, b"ok", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/state":
                self._send(404, b"not found", "text/plain")
                return
            length = int(self.headers.get("Content-Length", 0))
            # All coercion stays inside the try: a JSON-valid but non-numeric
            # payload (sliders=["a"]) answers 400 and keeps the handler alive.
            try:
                body = json.loads(self.rfile.read(length))
                if not isinstance(body, dict):
                    raise ValueError("state must be a JSON object")
                sl = np.asarray(body.get("sliders", []), np.float32)
                if sl.ndim != 1:
                    raise ValueError(f"sliders must be a flat list, got shape {sl.shape}")
                sl = sl[:session.n_sliders]
                if not np.all(np.isfinite(sl)):
                    raise ValueError("sliders must be finite")
                mode = body.get("mode", session.mode)
                if mode not in ("latent", "activation", "both"):
                    raise ValueError(f"unknown mode {mode!r}")
                # Clamp the W+ window: out-of-range indices would raise in
                # render(), negative ones would edit the wrong layers.
                max_lat = session.model.get_max_latents()
                lstart = max(0, min(int(body.get("lstart", 0)), max_lat))
                lend = max(lstart, min(int(body.get("lend", session.edit_layer_end)),
                                       max_lat))
                new_trunc = float(body.get("trunc", session.truncation))
                # json.loads accepts bare NaN / Infinity; a NaN truncation
                # would poison every later frame.
                if not np.isfinite(new_trunc):
                    raise ValueError("trunc must be finite")
            except (ValueError, TypeError, UnicodeDecodeError) as e:
                self._send(400, f"bad state: {e}".encode(), "text/plain")
                return
            with lock:
                session.sliders[:len(sl)] = sl
                session.mode = mode
                session.edit_layer_start = lstart
                session.edit_layer_end = lend
                if new_trunc != session.truncation:
                    session.truncation = new_trunc
                    session.resample_latent(session.state.seed)
            self._send(200, b"ok", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def serve(session: Session, host: str = "127.0.0.1", port: int = 8080):
    """Serve the session as a single-page web UI (blocks)."""
    server = make_server(session, host, port)
    session.start_speculation()
    print(f"ganspace_tpu_torch interactive viewer at "
          f"http://{host}:{server.server_address[1]}/", flush=True)
    try:
        server.serve_forever()
    finally:
        session.stop_speculation()
        server.server_close()


def apply_preview_precision(args) -> None:
    """The viewer process's precision policy: the bf16 datapath and bf16
    activation storage by default, ``--dtype float32`` pins full precision.
    Process-global and applied only from the CLI entry: library users and
    tests scope ``precision()`` / ``synth_dtype()`` themselves, and
    ``compute()`` scopes its own."""
    from ganspace_tpu_torch.ops.precision import set_precision, set_synth_dtype
    modes = {"float32": "highest", "bfloat16": "default", None: "default"}
    dtype = getattr(args, "dtype", None)
    if dtype not in modes:
        raise SystemExit(f"--dtype {dtype!r}: expected 'float32' or 'bfloat16'")
    mode = modes[dtype]
    set_precision(mode)
    set_synth_dtype("bfloat16" if mode == "default" else None)


def main(argv=None):
    import argparse
    argv = list(sys.argv[1:] if argv is None else argv)
    # Viewer-only flags, peeled off before the shared Config parser.
    vp = argparse.ArgumentParser(add_help=False)
    vp.add_argument("--port", type=int, default=8080)
    vp.add_argument("--host", type=str, default="127.0.0.1")
    # Accepted for compatibility: the stdlib viewer never opens a browser.
    vp.add_argument("--no-browser", action="store_true")
    vargs, rest = vp.parse_known_args(argv)
    args = Config().from_args(rest)
    preview = os.environ.get("GANSPACE_PREVIEW")
    apply_preview_precision(args)
    session = Session(args, preview_size=int(preview) if preview else None)
    print("Warming up the frame kinds...", flush=True)
    session.warmup()
    serve(session, host=vargs.host, port=vargs.port)


if __name__ == "__main__":
    main()
