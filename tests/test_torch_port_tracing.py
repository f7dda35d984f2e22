"""The port's ``utils/tracing`` against the JAX package's, and the
``GANSPACE_PHASE_TRACE=1`` print of ``decomposition._compute`` against the
JAX package's format."""

import itertools
import json
import re
import time

import pytest
import torch

import jax.numpy as jnp

from ganspace_tpu.config import Config as JaxConfig
from ganspace_tpu.decomposition import get_or_compute as jax_get_or_compute
from ganspace_tpu.models import stylegan2 as jax_sg2
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented
from ganspace_tpu.utils import tracing as jax_tracing

from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.models import stylegan2 as torch_sg2
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.tools.profiling import host_self_times
from ganspace_tpu_torch.utils import tracing

CHANNELS = ((4, 32), (8, 32), (16, 16))
#: one line of the JAX package's post-fit trace (decomposition.py:1474-1480)
TRACE_LINE = re.compile(r"^  (\S.{17}) \+([ \d]{2}\d\.\d{3})s \(t=([ \d]{2}\d\.\d{3})\)$")
PORT_PHASES = ["setup", "pass1", "refine", "finish", "regression", "baselines", "npz"]


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the tests run in several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run_phases(mod, sync):
    """The same phases, in the same order, on a StepTimer of ``mod``."""
    t = mod.StepTimer()
    for name, n in (("sample", 3), ("fit", 1), ("a_much_longer_phase_name_here", 2),
                    ("render", 4)):
        for _ in range(n):
            with t.phase(name, sync=sync if name == "fit" else None):
                pass
    return t


def test_step_timer_report_matches_jax(monkeypatch):
    ticks = [0.0, 0.0125, 0.5, 1.75, 2.0, 2.0001, 9.0, 9.25, 9.5, 9.6, 9.7, 9.8, 11.0,
             11.002, 12.0, 15.5, 16.0, 16.03125, 20.0, 20.5]

    def clock():
        it = itertools.chain(ticks, itertools.count(30.0))
        return lambda: next(it)

    monkeypatch.setattr(time, "perf_counter", clock())
    ref = _run_phases(jax_tracing, jnp.ones((4, 4)))
    monkeypatch.setattr(time, "perf_counter", clock())
    got = _run_phases(tracing, {"acts": [torch.ones(4, 4)]})
    assert got.report() == ref.report()
    assert got.totals() == ref.totals()
    assert got.report().splitlines()[0].endswith("ms/call")


def test_trace_cpu_writes_annotated_file(tmp_path):
    with tracing.trace(str(tmp_path / "tr"), device="cpu") as d:
        with tracing.annotate("ganspace_region"):
            x = torch.randn(32, 32)
            tracing.device_sync(x @ x)
    assert d == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "ganspace_region" for e in events)
    # the annotation spans the product, so its self time excludes it
    times = host_self_times(events)
    assert times["ganspace_region"][1] == 1 and times["aten::mm"][1] == 1
    region = next(e for e in events if e.get("name") == "ganspace_region")
    assert times["ganspace_region"][0] < region["dur"]


def test_host_self_times_nesting():
    ev = [dict(cat="cpu_op", name="outer", pid=1, tid=1, ts=0, dur=100),
          dict(cat="cpu_op", name="inner", pid=1, tid=1, ts=10, dur=30),
          dict(cat="cuda_runtime", name="cudaLaunchKernel", pid=1, tid=1, ts=15, dur=5),
          dict(cat="cpu_op", name="inner", pid=1, tid=1, ts=50, dur=20),
          dict(cat="cpu_op", name="other", pid=1, tid=2, ts=20, dur=40),
          dict(cat="kernel", name="k", pid=0, tid=7, ts=16, dur=50)]
    assert host_self_times(ev) == {"outer": [50.0, 1], "inner": [45.0, 2],
                                   "cudaLaunchKernel": [5.0, 1], "other": [40.0, 1]}


def test_device_sync_on_cpu_tensors():
    x = torch.ones(3)
    tracing.device_sync()
    tracing.device_sync(x, {"a": [x, (x, None)], "b": 1.0}, None)


def test_trace_cuda_refuses_missing_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="cuda"):
        with tracing.trace(str(tmp_path), device="cuda"):
            pass


def _trace_lines(err: str) -> list:
    lines = err.splitlines()
    start = lines.index("post-fit phase trace:")
    out = []
    for line in lines[start + 1:]:
        m = TRACE_LINE.match(line)
        if m is None:
            break
        out.append((m.group(1).rstrip(), float(m.group(2)), float(m.group(3)), line))
    return out


def test_phase_trace_has_jax_format(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    monkeypatch.setenv("GANSPACE_PHASE_TRACE", "1")
    kw = dict(model="StyleGAN2", output_class="ffhq", layer="style", estimator="ipca",
              components=4, n=2048, use_w=True)
    cfg = jax_sg2.SG2Config(resolution=16, channels=CHANNELS)
    params = jax_sg2.init_params(cfg, seed=1)
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    jax_get_or_compute(JaxConfig(mesh_shape="1", **kw), JaxInstrumented(
        jax_sg2.StyleGAN2(class_name="ffhq", cfg=cfg, params=params)))
    ref = _trace_lines(capsys.readouterr().err)
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=16, channels=CHANNELS),
                               params=params, device="cpu")
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    get_or_compute(Config(device="cpu", **kw), InstrumentedModel(port))
    got = _trace_lines(capsys.readouterr().err)

    assert ref and [label for label, *_ in got] == PORT_PHASES
    t = 0.0
    for label, dt, cum, line in got:
        t += dt
        assert abs(cum - t) <= 0.002 * len(PORT_PHASES)
        # the JAX package's f-string, byte for byte
        assert line == f"  {label:18s} +{dt:7.3f}s (t={cum:7.3f})"


def test_phase_trace_off_by_default(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    monkeypatch.delenv("GANSPACE_PHASE_TRACE", raising=False)
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path))
    port = torch_sg2.StyleGAN2("ffhq", cfg=torch_sg2.SG2Config(resolution=16, channels=CHANNELS),
                               params=jax_sg2.init_params(
                                   jax_sg2.SG2Config(resolution=16, channels=CHANNELS), seed=1),
                               device="cpu")
    phases = {}
    get_or_compute(Config(device="cpu", model="StyleGAN2", output_class="ffhq", layer="style",
                          estimator="ipca", components=4, n=2048, use_w=True),
                   InstrumentedModel(port), phases=phases)
    assert list(phases) == PORT_PHASES
    assert "post-fit phase trace:" not in capsys.readouterr().err
