"""The port's spans and request records (``utils/tracing``), the spans of a
fit, a strip and a model build, the benchmark's readers of them, and the
idle attribution of ``tools/profiling``."""

import json
import statistics
import threading
import time

import pytest
import torch

from benchmark import harness
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.edit import create_strip_centered
from ganspace_tpu_torch.models import get_instrumented_model
from ganspace_tpu_torch.models import stylegan2 as sg2
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.tools.profiling import NO_SPAN, device_idle
from ganspace_tpu_torch.utils import tracing
from ganspace_tpu_torch.utils.tracing import annotate, count

CHANNELS = ((4, 32), (8, 32), (16, 16))
#: the fit's tap: 32 channels at 8 px (D = 2048), through the sketch tier
TAP_ENV = {"GANSPACE_IPCA_MOMENTS_MAX_D": "1024", "GANSPACE_DEVICE_RNG": "1"}
FIT_SPANS = {"fit", "stream.block", "stream.latents", "model.forward", "estimator.update",
             "estimator.init", "estimator.decide", "synth.mapping", "synth.conv1",
             "synth.to_rgb1", "synth.convs.0", "synth.convs.1"}


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the tests run in several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _new(since: int, name=None) -> list:
    """The requests recorded after the one with id ``since``."""
    return [u for u in tracing.units(name) if u["id"] > since]


def _last_id() -> int:
    kept = tracing.units()
    return kept[-1]["id"] if kept else 0


def _tiny(use_w=False) -> sg2.StyleGAN2:
    cfg = sg2.SG2Config(resolution=16, channels=CHANNELS)
    return sg2.StyleGAN2("ffhq", cfg=cfg, params=sg2.init_params(cfg, seed=1), use_w=use_w,
                         device="cpu")


def _spin(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


# -- the span layer --------------------------------------------------------------

def test_self_times_sum_to_the_wall():
    with annotate("req") as req:
        _spin(0.002)
        with annotate("a"):
            _spin(0.001)
            with annotate("b"):
                _spin(0.002)
        for _ in range(3):
            with annotate("b"):
                _spin(0.0005)
    rec = req.record
    spans = rec["spans"]
    wall = rec["end_ns"] - rec["start_ns"]
    assert set(spans) == {"req", "a", "b"}
    assert [spans[k][0] for k in ("req", "a", "b")] == [1, 1, 4]
    assert spans["req"][1] == wall
    assert sum(own for _, _, own in spans.values()) == wall
    # a's self time leaves out its child b; b has no children
    assert spans["a"][2] < spans["a"][1] and spans["b"][2] == spans["b"][1]
    assert spans["a"][2] >= 1_000_000 and spans["b"][1] >= 3_500_000


def test_one_record_per_outermost_span():
    since = _last_id()
    with annotate("first") as first:
        with annotate("inner") as inner:
            pass
    with annotate("second") as second:
        pass
    got = _new(since)
    assert [u["name"] for u in got] == ["first", "second"]
    assert got[0]["id"] < got[1]["id"]
    assert inner.record is None
    assert first.record == got[0] and second.record == got[1]
    assert got[0]["end_ns"] <= got[1]["start_ns"]
    # the records handed out are copies
    first.record["spans"]["first"][0] = 99
    assert tracing.units("first")[-1]["spans"]["first"][0] == 1


def test_a_span_in_its_own_name_is_folded():
    with annotate("forward") as req:
        with annotate("forward"):
            with annotate("forward"):
                _spin(0.0005)
    assert req.record["spans"] == {"forward": [1, req.record["spans"]["forward"][1],
                                               req.record["spans"]["forward"][1]]}


def test_counters_belong_to_the_open_request():
    since = _last_id()
    count("stray")                       # no request open: dropped
    with annotate("req") as req:
        count("passes")
        with annotate("inner"):
            count("passes")
            count("rows", 128)
    count("stray")
    assert req.record["counters"] == {"passes": 2, "rows": 128}
    assert [u["name"] for u in _new(since)] == ["req"]


def test_the_ring_keeps_the_newest():
    for _ in range(tracing.RING + 7):
        with annotate("ring.unit"):
            pass
    kept = tracing.units()
    assert len(kept) == tracing.RING
    ids = [u["id"] for u in kept]
    assert ids == sorted(ids) and ids[-1] - ids[0] == tracing.RING - 1
    assert all(u["name"] == "ring.unit" for u in kept[-tracing.RING + 7:])


def test_threads_keep_their_own_requests():
    since = _last_id()
    started = threading.Barrier(2)

    def work(name):
        with annotate(name):
            started.wait(timeout=10)
            with annotate("leaf"):
                pass
    threads = [threading.Thread(target=work, args=(f"thread.{i}",)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = sorted(_new(since), key=lambda u: u["name"])
    assert [u["name"] for u in got] == ["thread.0", "thread.1"]
    assert all(set(u["spans"]) == {u["name"], "leaf"} for u in got)


def test_traced_flag_under_a_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile
    with annotate("plain") as plain:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("profiled") as profiled:
            torch.ones(4).sum()
    assert plain.record["traced"] is False
    assert profiled.record["traced"] is True


def test_no_record_function_without_a_profiler(monkeypatch):
    made = []

    class Recorder(torch.profiler.record_function):
        def __init__(self, name, args=None):
            made.append(name)
            super().__init__(name, args)
    monkeypatch.setattr(torch.profiler, "record_function", Recorder)
    with annotate("quiet"):
        with annotate("quiet.child"):
            pass
    assert made == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("loud"):
            with annotate("loud.child"):
                pass
    assert made == ["loud", "loud.child"]


def test_spans_share_the_profilers_clock():
    """A span's profiler range and its record start within 1 ms of each
    other, and the ranges nest as the spans do."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("clock.outer") as req:
            x = torch.randn(64, 64)
            with annotate("clock.inner"):
                (x @ x).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    outer, inner = events["clock.outer"], events["clock.inner"]
    assert abs(outer.start_ns() - req.record["start_ns"]) < 1_000_000
    assert abs(outer.start_ns() + outer.duration_ns() - req.record["end_ns"]) < 1_000_000
    assert outer.start_ns() <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer.start_ns() + outer.duration_ns()


def test_span_cost_without_a_profiler(capsys):
    """Host microseconds a span costs with no profiler recording; the bar is
    a loose ceiling (the figure for the record is the card's host's)."""
    n = 20000
    with annotate("cost"):
        t0 = time.perf_counter()
        for _ in range(n):
            with annotate("cost.span"):
                pass
        spans = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        loop = time.perf_counter() - t0
    us = (spans - loop) / n * 1e6
    with capsys.disabled():
        print(f"\nspan cost without a profiler: {us:.3f} us per span")
    assert us < 20.0


def test_format_unit_lists_spans_and_counters():
    with annotate("fmt") as req:
        count("fmt.passes", 2)
        with annotate("fmt.child"):
            _spin(0.001)
    lines = tracing.format_unit(req.record, "rank 1: ").splitlines()
    assert lines[0].startswith(f"rank 1: request fmt #{req.record['id']}: ")
    assert lines[2].split()[2:4] == ["fmt", "1"]
    assert lines[3].split()[2:4] == ["fmt.child", "1"]
    assert lines[-1] == "rank 1:   counter fmt.passes = 2"


# -- the program's spans -----------------------------------------------------------

def _fit(tmp_path, monkeypatch, fused: str, **extra):
    for k, v in {**TAP_ENV, "GANSPACE_FUSED_ACTS": fused, **extra}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    since = _last_id()
    get_or_compute(Config(device="cpu", model="StyleGAN2", output_class="ffhq",
                          layer="convs.1", estimator="ipca", components=4, n=1024,
                          batch_size=256), InstrumentedModel(_tiny()))
    (rec,) = _new(since, "fit")
    return rec


@pytest.mark.parametrize("fused, blocks", [("1", 4), ("0", 1)])
def test_a_fit_is_one_request(tmp_path, monkeypatch, fused, blocks):
    """The fused stream (``run_pass``: 4 blocks of 256 a pass) and the
    pre-sampled one (``run_sweep``: one block of NB = 2000 rows a pass),
    one or two passes."""
    rec = _fit(tmp_path, monkeypatch, fused)
    spans, passes = rec["spans"], rec["counters"]["stream.passes"]
    assert rec["traced"] is False and passes in (1, 2)
    assert spans["stream.block"][0] == blocks * passes
    assert spans["estimator.update"][0] == blocks * passes
    want = FIT_SPANS if fused == "1" else FIT_SPANS - {"stream.latents"}
    assert want <= set(spans), sorted(want - set(spans))
    wall = rec["end_ns"] - rec["start_ns"]
    assert spans["fit"][1] == wall == sum(own for _, _, own in spans.values())
    # the blocks' work lies inside the fit's stream; the sketch is made
    # once and its refine decision taken once
    assert spans["estimator.update"][1] < spans["stream.block"][1] < wall
    assert spans["estimator.init"][0] == 1 and spans["estimator.decide"][0] == 1


def test_the_phase_trace_prints_the_request(tmp_path, monkeypatch, capsys):
    rec = _fit(tmp_path, monkeypatch, "1", GANSPACE_PHASE_TRACE="1")
    err = capsys.readouterr().err.splitlines()
    start = err.index("post-fit phase trace:")
    table = err[start + 8:]              # the seven phase lines come first
    assert table[0].startswith(f"request fit #{rec['id']}: ")
    names = {line.split()[0] for line in table[2:] if not line.startswith("  counter")}
    assert FIT_SPANS <= names
    assert f"  counter stream.passes = {rec['counters']['stream.passes']}" in table


def test_a_strip_and_its_latent_are_requests():
    model = _tiny(use_w=True)
    inst = InstrumentedModel(model)
    since = _last_id()
    w = model.sample_latent(1, seed=3)
    d = torch.nn.functional.normalize(torch.randn(1, 512), dim=1)
    frames = create_strip_centered(inst, "latent", "style", [w], d, d, 1.0, 1.0,
                                   torch.zeros(512), torch.zeros(512), 2.0, 0, -1, 5,
                                   as_uint8=True)
    assert len(frames[0]) == 5
    latent, strip = _new(since)
    assert latent["name"] == "model.sample_latent" and strip["name"] == "edit.strip"
    assert set(latent["spans"]) == {"model.sample_latent"}
    spans = strip["spans"]
    assert spans["model.forward"][0] == 1 and spans["imaging.readback"][0] == 1
    assert {"synth.conv1", "synth.to_rgb1", "synth.convs.3", "synth.to_rgbs.1"} <= set(spans)
    assert "synth.mapping" not in spans          # W: the mapping ran in sample_latent


def test_a_model_build_is_a_request():
    cfg = sg2.SG2Config(resolution=16, channels=CHANNELS)
    since = _last_id()
    get_instrumented_model("StyleGAN2", "ffhq", "convs.1", "cpu", cfg=cfg,
                           params=sg2.init_params(cfg, seed=1))
    (build,) = _new(since)
    assert build["name"] == "model.build"
    assert {"model.build", "model.sample_latent", "synth.convs.1"} <= set(build["spans"])


# -- the benchmark's readers --------------------------------------------------------

def _record(name, wall_ms, spans=None, counters=None, traced=False):
    ns = int(wall_ms * 1e6)
    rows = {name: [1, ns, ns]}
    rows.update({k: [n, int(ms * 1e6), int(ms * 1e6)] for k, (n, ms) in (spans or {}).items()})
    return {"id": 0, "name": name, "start_ns": 10**18, "end_ns": 10**18 + ns,
            "traced": traced, "spans": rows, "counters": counters or {}}


def _fit_record(block_ms, traced=False, blocks=780, passes=2):
    """A fit of ``blocks`` blocks over ``passes`` passes, each ``block_ms``."""
    return _record("fit", blocks * block_ms + 100, {
        "stream.block": (blocks, blocks * block_ms),
        "stream.latents": (blocks, blocks * block_ms / 10),
        "model.forward": (blocks + 2, blocks * block_ms / 2),
        "estimator.update": (blocks, blocks * block_ms / 5)},
        {"stream.passes": passes}, traced)


SYNTHETIC = (
    [_fit_record(5.0), _fit_record(5.5), _fit_record(6.0),
     _fit_record(50.0, traced=True, passes=7),
     _fit_record(200.0, blocks=6, passes=1),      # the set-up's warm-up: not counted
     _record("fit", 3.0)]                           # a fit with no stream: not counted
    + [_record("edit.strip", 45.0, {"model.forward": (1, ms), "imaging.readback": (1, 3 * ms)})
       for ms in (8.0, 9.0, 10.0)]
    + [_record("edit.strip", 90.0, {"model.forward": (1, 80.0)}, traced=True)]
    + [_record("model.sample_latent", ms) for ms in (0.5, 0.7, 0.9)]
    + [_record("model.sample_latent", 30.0, traced=True)]
    + [_record("model.build", 1500.0), _record("model.build", 250.0),
       _record("model.build", 9000.0, traced=True)])

READINGS = {"fit.block_ms": 5.5, "fit.latents_ms": 0.55, "fit.forward_ms": 2.75,
            "fit.estimator_ms": 1.1, "fit.passes": 2, "render.latent_ms": 0.7,
            "render.launch_ms": 9.0, "render.readback_ms": 27.0, "setup.model_s": 1.75}


def _reader(name):
    return harness.load_file(harness.ROOT / "benchmark" / "metrics" / f"{name}.py",
                             "test_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(READINGS))
def test_span_readers_on_synthetic_records(monkeypatch, name):
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["better"] == "lower"
    monkeypatch.setattr(tracing, "_units", list(SYNTHETIC))
    reader = _reader(name)
    assert reader.RANGES == {}
    assert reader.read(None) == pytest.approx(READINGS[name], rel=1e-6)
    # the traced records alone: nothing to read
    monkeypatch.setattr(tracing, "_units", [u for u in SYNTHETIC if u["traced"]])
    assert reader.read(None) is None


def test_a_window_fit_beside_the_warm_up(monkeypatch):
    """A ``--trace 1`` run of a long fit may keep one untraced fit of the
    window beside the set-up's smaller warm-up: the readers take the former."""
    monkeypatch.setattr(tracing, "_units", [_fit_record(200.0, blocks=6, passes=1),
                                            _fit_record(6.0), _fit_record(9.0, traced=True)])
    assert _reader("fit.block_ms").read(None) == pytest.approx(6.0)
    assert _reader("fit.passes").read(None) == 2


def test_the_readers_median_matches_the_records(monkeypatch):
    monkeypatch.setattr(tracing, "_units", list(SYNTHETIC))
    walls = [(u["end_ns"] - u["start_ns"]) / 1e6 for u in SYNTHETIC
             if u["name"] == "model.sample_latent" and not u["traced"]]
    assert _reader("render.latent_ms").read(None) == statistics.median(walls)


# -- tools/profiling -----------------------------------------------------------------

def test_device_idle_unions_work_and_names_gaps_by_span():
    ann = dict(cat="user_annotation", pid=1, tid=1)
    rt = dict(cat="cuda_runtime", name="cudaLaunchKernel", pid=1, tid=1, dur=2)
    ev = [dict(ann, name="fit", ts=0, dur=1000),
          dict(ann, name="stream.block", ts=100, dur=200),
          dict(ann, name="model.forward", ts=110, dur=50),
          dict(ann, name="stream.block", ts=400, dur=200),
          dict(ann, name="estimator.update", ts=440, dur=30),
          dict(ann, name="other thread", tid=2, ts=0, dur=5000),
          dict(rt, ts=120, args={"correlation": 1}),
          dict(rt, ts=130, args={"correlation": 2}),
          dict(rt, ts=450, args={"correlation": 3}),
          dict(rt, ts=1500, args={"correlation": 4}),
          dict(rt, ts=1600, args={"correlation": 5}),
          dict(cat="kernel", name="k1", pid=0, tid=7, ts=125, dur=20, args={"correlation": 1}),
          dict(cat="kernel", name="k2", pid=0, tid=8, ts=135, dur=30, args={"correlation": 2}),
          dict(cat="kernel", name="k3", pid=0, tid=7, ts=460, dur=10, args={"correlation": 3}),
          dict(cat="gpu_memcpy", name="m", pid=0, tid=7, ts=1510, dur=10,
               args={"correlation": 4}),
          dict(cat="kernel", name="k5", pid=0, tid=7, ts=1700, dur=10, args={"correlation": 5}),
          dict(cat="gpu_user_annotation", name="fit", pid=0, tid=7, ts=125, dur=900)]
    busy, chains = device_idle(ev)
    # k1 and k2 overlap: 125-165 counts once
    assert busy == 40 + 10 + 10 + 10
    assert chains == [[NO_SPAN, 1040 + 180, 2],
                      ["fit > estimator.update", 295, 1]]
