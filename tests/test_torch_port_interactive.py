"""The port's viewer session against the JAX package's, on the CPU.

``tests/test_interactive.py``'s thirteen tests run against the port's
``Session`` on the same tiny StyleGAN2 (32 px, ``style`` in W), every HTTP
request with a timeout and the speculation thread stopped in a
``finally``.  Beside them: ``_compute_frame`` for the same sliders in
latent, activation and layer-window mode against the JAX ``Session`` on the
same weights and the same component cache, in float32 (the uint8 frames
within one level, a rounding apart) and under the preview policy; the
viewer's frame quantiser with ``GANSPACE_PREVIEW`` downscaling against
JAX's ``_frame_u8``; a viewer process under the preview policy writes no
``_bf16`` cache; the ``python -m ganspace_tpu_torch`` dispatcher.

The preview error: the mean |preview - float32| of the frame in uint8
levels, measured here for both packages, the JAX package's contractions on
the one-pass bf16 datapath its TPU runs (``torch_port_jax_bf16``): on the
tiny model, and on a StyleGAN2 and a StyleGAN at 256 px, where the port's
must lie within ``PREVIEW_ERR_BAND`` of JAX's.  ``chip_smoke.py`` holds the
port's full-width 1024-px preview frame on the card to
``PREVIEW_ERR_RATIO`` times JAX's 256-px figure, which it keeps as
``PREVIEW_JAX_MEAN_LEVELS``; this file checks those constants against its
own measurement.
"""

import contextlib
import importlib
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganspace_tpu.apps import interactive as jax_interactive
from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.models import stylegan as jax_sg1
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented

import chip_smoke
from ganspace_tpu_torch import __main__ as dispatcher
from ganspace_tpu_torch.apps import interactive as mod
from ganspace_tpu_torch.apps.interactive import (
    ParamCache, Session, apply_preview_precision, get_edit_name, make_server)
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.directions import (
    direction_file_ident, load_direction, load_named_components)
from ganspace_tpu_torch.imaging import frame_u8
from ganspace_tpu_torch.models import stylegan as torch_sg1
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops import precision

from torch_port_jax_bf16 import one_pass_bf16

jax_precision = importlib.import_module("ganspace_tpu.ops.precision")

CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))
SESSION_KW = dict(model="StyleGAN2", output_class="ffhq", layer="style", estimator="ipca",
                  components=6, n=1200, use_w=True, batch_size=128)
TIMEOUT = 60
# the preview frame against JAX's on the same state, uint8 levels: mean, max
PREVIEW_VS_JAX_LEVELS = (1.5, 24)
# the port's preview error over the JAX package's, on the same model
PREVIEW_ERR_BAND = (0.8, 1.25)
# 256-px models: StyleGAN2 (256 channels down to 32) and StyleGAN
SG2_256 = ((4, 256), (8, 256), (16, 256), (32, 256), (64, 128), (128, 64), (256, 32))
SG1_256 = dict(resolution=256, fmap_base=1024)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params():
    return jax_sg2.init_params(jax_sg2.SG2Config(resolution=32, channels=CHANNELS), seed=0)


def _port_session(**kw):
    """A port Session around the tiny model, its caches under
    ``GANSPACE_OUTPUT_DIR``; ``kw`` overrides the config."""
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=32,
                                                              channels=CHANNELS),
                               params=_params(), use_w=True, device="cpu")
    inst = InstrumentedModel(port)
    orig = mod.get_instrumented_model
    mod.get_instrumented_model = lambda *a, **k: inst
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return Session(Config(device="cpu", **{**SESSION_KW, **kw}), n_sliders=6)
    finally:
        mod.get_instrumented_model = orig


def _jax_session():
    cfg = jax_sg2.SG2Config(resolution=32, channels=CHANNELS)
    model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=cfg, params=_params(), use_w=True)
    inst = JaxInstrumented(model)
    orig = jax_interactive.get_instrumented_model
    jax_interactive.get_instrumented_model = lambda *a, **k: inst
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return jax_interactive.Session(JaxConfig(**SESSION_KW), n_sliders=6)
    finally:
        jax_interactive.get_instrumented_model = orig


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    out = tmp_path_factory.mktemp("interactive")
    mp = pytest.MonkeyPatch()
    mp.setenv("GANSPACE_OUTPUT_DIR", str(out))
    try:
        yield _port_session()
    finally:
        mp.undo()


# -- tests/test_interactive.py against the port --------------------------------

def test_param_cache():
    c = ParamCache()
    assert c.update(a=1, b=np.zeros(3))
    assert not c.update(a=1, b=np.zeros(3))
    assert c.update(b=np.ones(3))


def test_render_changes_with_sliders(session):
    session.zero_sliders()
    base = session.render(force=True).copy()
    session.sliders[0] = 3.0
    edited = session.render()
    assert np.abs(base.astype(int) - edited.astype(int)).max() > 0
    again = session.render()          # lazy cache: same params, same object
    assert again is edited


def test_layer_window_edit(session):
    session.zero_sliders()
    session.sliders[1] = 2.0
    session.edit_layer_start, session.edit_layer_end = 0, session.model.get_max_latents()
    full = session.render().copy()
    session.edit_layer_start, session.edit_layer_end = 5, 7
    windowed = session.render()
    assert np.abs(full.astype(int) - windowed.astype(int)).max() > 0
    session.edit_layer_start, session.edit_layer_end = 0, session.model.get_max_latents()


def test_resample_changes_latent(session):
    z0 = session.state.z.clone()
    session.resample_latent(seed=123)
    assert not torch.equal(z0, session.state.z)
    assert session.state.base_act is not None


def test_export_import_direction(session, tmp_path):
    session.mode = "latent"
    path = session.export_direction(2, "Test Dir", sigma_range=2.0, out_dir=tmp_path)
    assert path.is_file()
    d = load_direction(path)
    assert d["name"] == "Test Dir" and d["component_index"] == 2
    assert d["latent_space"] == "W"
    assert d["act_comp"].shape == (1, 512)
    assert d["decomposition"]["layer"] == "style"
    assert direction_file_ident(d) in path.name
    assert len(load_named_components(tmp_path, "StyleGAN2", "ffhq", latent_space="W")) == 1
    assert load_named_components(tmp_path, "StyleGAN", "ffhq") == []


def test_edit_name_syntax():
    assert get_edit_name(3, 0, 5, "smile") == "E(3, 0-5): smile"
    assert get_edit_name(3, 4, 4) == "E(3, 4)"


def test_render_np_uint8(session):
    frame = session.render_np()
    assert frame.dtype == np.uint8
    assert frame.ndim == 3 and frame.shape[2] == 3


def test_warmup_preserves_state(session):
    session.sliders[:] = 0
    session.sliders[1] = 2.5
    before = session.render(force=True).copy()
    session.warmup()
    assert session.sliders[1] == 2.5 and session.mode == "latent"
    assert np.array_equal(before, session.render(force=True))


def test_apply_preview_precision_rejects_unknown_dtype():
    class Args:
        dtype = "bf16"
    with pytest.raises(SystemExit, match="float32"):
        apply_preview_precision(Args())


def test_viewer_http_endpoints(session):
    server = make_server(session, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    def get(path):
        return urllib.request.urlopen(f"{base}{path}", timeout=TIMEOUT)

    def post(payload):
        req = urllib.request.Request(f"{base}/state", method="POST",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=TIMEOUT)
    try:
        page = get("/").read().decode()
        assert "ganspace-tpu" in page and "Component 0" in page
        assert get("/frame.jpg").read()[:2] == b"\xff\xd8"      # JPEG magic
        assert get("/resample?seed=7").read() == b"ok"
        assert session.state.seed == 7
        max_lat = session.model.get_max_latents()
        assert post({"sliders": [1.0], "mode": "latent", "lstart": -5,
                     "lend": 10_000}).status == 200
        assert session.edit_layer_start == 0 and session.edit_layer_end == max_lat
        assert abs(session.sliders[0] - 1.0) < 1e-6
        session.render(force=True)
        for bad in ({"sliders": ["a"]}, {"mode": "nope"}, ["not", "a", "dict"],
                    {"sliders": [[1.0], [2.0]]}, {"sliders": [float("nan")]},
                    {"trunc": float("nan")}):
            with pytest.raises(urllib.error.HTTPError) as exc:
                post(bad)
            assert exc.value.code == 400, bad
        with pytest.raises(urllib.error.HTTPError) as exc:
            get("/nope")
        assert exc.value.code == 404
        assert get("/frame.jpg").read()[:2] == b"\xff\xd8"
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=TIMEOUT)
        session.sliders[:] = 0.0


def test_speculative_frame_cache(session):
    s = session
    s.frame_cache._d.clear()
    s.sliders[:] = 0
    s.sliders[0] = np.float32(0.1)
    first = s.render(force=True).copy()
    assert len(s.frame_cache) >= 1
    s._last_moved = 0
    assert s._speculate_once() >= 2
    hits_before = s.frame_cache.hits
    s.sliders[0] = np.float32(0.2)
    frame_fast = s.render()
    assert s.frame_cache.hits == hits_before + 1
    s.frame_cache._d.clear()
    s.cache.update(coords=None)
    frame_slow = s.render(force=True)
    np.testing.assert_array_equal(frame_fast, frame_slow)
    assert not np.array_equal(first, frame_fast)
    s.sliders[0] = np.float32(0.1)


def test_speculation_thread_lifecycle(session):
    s = session
    try:
        s.start_speculation()
        assert s._spec_thread is not None and s._spec_thread.is_alive()
        s.sliders[0] = np.float32(0.3)
        s.render(force=True)
        deadline = time.time() + 30
        while time.time() < deadline and len(s.frame_cache) < 3:
            time.sleep(0.1)
    finally:
        s.stop_speculation()
    assert s._spec_thread is None
    assert len(s.frame_cache) >= 3
    s.sliders[0] = 0.0
    s.render()


def test_time_frame_speculative(session):
    fast_ms = session.time_frame_speculative(iters=3)
    synth_ms, read_ms, total_ms = session.time_frame(iters=3)
    assert fast_ms < max(1.0, 0.5 * total_ms)
    assert synth_ms > 0 and read_ms > 0


# -- against the JAX Session ---------------------------------------------------

# (mode, W+ window or None for all slots, {slider: value})
FRAME_EDITS = [("latent", None, {0: 2.0, 3: -1.5}),
               ("activation", None, {1: 2.5}),
               ("latent", (2, 5), {2: 3.0, 5: 1.0})]


@pytest.fixture(scope="module")
def paired_sessions(tmp_path_factory):
    """The JAX and the port Session over one component cache (the JAX
    package's, which the port's get_or_compute finds by name)."""
    out = tmp_path_factory.mktemp("paired")
    mp = pytest.MonkeyPatch()
    mp.setenv("GANSPACE_OUTPUT_DIR", str(out))
    mp.setenv("GANSPACE_DEVICE_RNG", "0")
    try:
        jax_s = _jax_session()
        port_s = _port_session()
        yield jax_s, port_s
    finally:
        mp.undo()


def _frames(sess):
    frames = []
    for mode, window, sliders in FRAME_EDITS:
        s, e = window or (0, sess.model.get_max_latents())
        sess.mode = mode
        v = np.zeros(sess.n_sliders, np.float32)
        for i, x in sliders.items():
            v[i] = x
        frames.append(np.asarray(sess._compute_frame(v, s, e)).astype(np.int16))
    return frames


@contextlib.contextmanager
def _jax_preview():
    """The JAX viewer's preview policy, its contractions on the one-pass
    bf16 datapath its TPU runs."""
    with jax_precision.precision("default"), jax_precision.synth_dtype("bfloat16"), \
            one_pass_bf16():
        yield


@contextlib.contextmanager
def _port_preview():
    with precision.precision("default"), precision.synth_dtype("bfloat16"):
        yield


def test_compute_frame_matches_jax_session_in_float32(paired_sessions):
    jax_s, port_s = paired_sessions
    # the same W latent, the mapping's float32 sums in another order
    z_ref = np.asarray(jax_s.state.z)
    assert np.abs(port_s.state.z.numpy() - z_ref).max() <= 1e-5 * np.abs(z_ref).max()
    jax.clear_caches()
    for ref, got in zip(_frames(jax_s), _frames(port_s)):
        assert ref.shape == got.shape
        assert np.abs(ref - got).max() <= 1


def test_compute_frame_matches_jax_session_in_preview(paired_sessions):
    """Preview against preview for the same sliders; and the preview error
    (preview against float32, mean uint8 levels) of both packages, whose
    JAX figure the chip gate scales."""
    jax_s, port_s = paired_sessions
    jax.clear_caches()
    jax_f32, port_f32 = _frames(jax_s), _frames(port_s)
    with _jax_preview():
        jax_pre = _frames(jax_s)
    with _port_preview():
        port_pre = _frames(port_s)
    mean_lim, max_lim = PREVIEW_VS_JAX_LEVELS
    for ref, got in zip(jax_pre, port_pre):
        d = np.abs(ref - got)
        assert d.mean() <= mean_lim and d.max() <= max_lim, (d.mean(), d.max())
    e_jax = np.mean([np.abs(a - b).mean() for a, b in zip(jax_pre, jax_f32)])
    e_port = np.mean([np.abs(a - b).mean() for a, b in zip(port_pre, port_f32)])
    print(f"\npreview error, mean uint8 levels: JAX {e_jax:.4f}, port {e_port:.4f}, "
          f"ratio {e_port / e_jax:.3f}")
    lo, hi = PREVIEW_ERR_BAND
    assert lo * e_jax <= e_port <= hi * e_jax


@pytest.mark.parametrize("family", ["StyleGAN2", "StyleGAN"])
def test_preview_error_at_256px_matches_jax(family):
    """The preview frame against the float32 frame at 256 px, in both
    packages: the port's mean error within PREVIEW_ERR_BAND of JAX's, and
    JAX's the figure the chip gate scales.  StyleGAN's preview moves single
    pixels by more than half the range in JAX too (its random-weight image
    runs far outside [0, 1]), so a large maximum on the card is no fault."""
    if family == "StyleGAN2":
        cfg = jax_sg2.SG2Config(resolution=256, channels=SG2_256)
        params = jax_sg2.init_params(cfg, seed=0)
        jax_model = jax_sg2.StyleGAN2(class_name="ffhq", cfg=cfg, params=params)
        port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(
            resolution=256, channels=SG2_256), params=params, device="cpu")
    else:
        cfg = jax_sg1.SG1Config(**SG1_256)
        params = jax_sg1.init_params(cfg, seed=3)
        jax_model = jax_sg1.StyleGAN(class_name="ffhq", cfg=cfg, params=params)
        port = torch_sg1.StyleGAN("ffhq", cfg=torch_sg1.SG1Config(**SG1_256), params=params,
                                  device="cpu")
    z = np.random.RandomState(17).randn(2, 512).astype(np.float32)
    jax.clear_caches()
    jax_f32 = np.asarray(jax_interactive._frame_u8(jax_model.forward(z))).astype(np.int16)
    with _jax_preview():
        jax_pre = np.asarray(jax_interactive._frame_u8(jax_model.forward(z))).astype(np.int16)
    port_f32 = frame_u8(port.forward(torch.from_numpy(z))).astype(np.int16)
    with _port_preview():
        port_pre = frame_u8(port.forward(torch.from_numpy(z))).astype(np.int16)
    assert np.abs(port_f32 - jax_f32).max() <= 1
    d_jax, d_port = np.abs(jax_pre - jax_f32), np.abs(port_pre - port_f32)
    print(f"\n{family} 256 px, preview error in uint8 levels: JAX mean {d_jax.mean():.4f} "
          f"max {d_jax.max()}, port mean {d_port.mean():.4f} max {d_port.max()}")
    lo, hi = PREVIEW_ERR_BAND
    assert lo * d_jax.mean() <= d_port.mean() <= hi * d_jax.mean()
    np.testing.assert_allclose(d_jax.mean(), chip_smoke.PREVIEW_JAX_MEAN_LEVELS[family],
                               rtol=0.05)
    if family == "StyleGAN":
        assert d_jax.max() >= 128


@pytest.mark.parametrize("max_hw", [None, 24, 40])
def test_frame_quantiser_matches_jax(max_hw):
    """``frame_u8`` against JAX's ``_frame_u8``: clip, bilinear resize with
    antialiasing when it shrinks (GANSPACE_PREVIEW), quantise."""
    rs = np.random.RandomState(4)
    img = (rs.rand(2, 3, 48, 64) * 1.2 - 0.1).astype(np.float32)
    ref = np.asarray(jax_interactive._frame_u8(jnp.asarray(img), max_hw=max_hw))
    got = frame_u8(torch.from_numpy(img), max_hw=max_hw)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_viewer_process_writes_no_bf16_cache(tmp_path, monkeypatch):
    """A viewer process runs under the preview policy; its component fit
    goes through compute(), which pins float32 storage: an f32-grade cache
    without the _bf16 tag."""
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))

    class Args:
        dtype = None
    try:
        apply_preview_precision(Args())
        assert precision.get_precision() == "default"
        assert precision.synth_dtype_name() == "bfloat16"
        sess = _port_session(n=1300)
        frame = sess.render(force=True)
    finally:
        precision.set_precision("highest")
        precision.set_synth_dtype(None)
    assert frame.dtype == np.uint8
    names = [p.name for p in (tmp_path / "cache" / "components").iterdir()]
    assert names == ["stylegan2-ffhq_style_ipca_c6_n1300_w.npz"]
    with np.load(tmp_path / "cache" / "components" / names[0]) as d:
        meta = json.loads(d["_meta"].item().decode())
    assert meta["dtype"] == "float32" and "bf16_cos_bounds" not in meta


def test_dispatcher(capsys, monkeypatch):
    assert dispatcher.main([]) == 0
    out = capsys.readouterr().out
    for cmd in ("visualize", "interactive", "dissect", "makesample", "ganseg",
                "allunitsample"):
        assert cmd in out
    assert list(dispatcher.COMMANDS) == ["visualize", "interactive", "dissect",
                                         "makesample", "ganseg", "allunitsample"]
    assert dispatcher.main(["nope"]) == 2
    calls = []
    monkeypatch.setattr(mod, "main", lambda argv: calls.append(argv))
    assert dispatcher.main(["interactive", "--port", "0"]) == 0
    assert calls == [["--port", "0"]]
