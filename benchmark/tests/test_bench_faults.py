"""A whole run of each cell at tiny widths on the CPU (the harness's look
for a card skipped): sound, ``correct`` comes out true; with the timed path
broken underneath, false.  The faults: a step that returns its state
unchanged, half of each batch left out, an answer altered where it is
produced, and for the four-GPU fit (on four CPU processes) the exchange
between the ranks left out."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_cell


def _run(name, monkeypatch, seed=2**31 + 5, seconds=0.0, fault=None):
    """A run of the tiny cell; ``fault`` (module, attribute, function)
    replaces a function of the program for the window and the check."""
    cell = tiny_cell(name)
    harness.pin_env(cell.mix)
    if fault is not None:
        window = cell.loop.Loop.window

        def broken(self, *a, **k):
            monkeypatch.setattr(*fault)
            return window(self, *a, **k)
        monkeypatch.setattr(cell.loop.Loop, "window", broken)
    out = harness.run_cell(cell, seed, seconds, False, device="cpu")
    json.loads(json.dumps(out, allow_nan=False))        # the result line is valid JSON
    return out


@pytest.mark.parametrize("name", ["sg2-convs2-fit", "biggan512-genz-fit", "sg2-w-render"])
def test_sound_run_is_correct(name, monkeypatch):
    out = _run(name, monkeypatch)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert {"setup_s"} < set(out["metrics"])


def _fit_fault(kind):
    from ganspace_tpu_torch.estimators import ipca
    upd, fin = ipca.nystrom_update, ipca.finish_from_factor
    if kind == "state_unchanged":
        return ipca, "nystrom_update", lambda state, x, omega: state
    if kind == "half_batch":
        return ipca, "nystrom_update", lambda state, x, omega: upd(
            state, x[: x.shape[0] // 2], omega)

    def altered(*a, **k):                 # one component's stdev 1% high
        comp, stdev, ratio = fin(*a, **k)
        stdev = stdev.copy()
        stdev[3] *= 1.01
        return comp, stdev, ratio
    return ipca, "finish_from_factor", altered


@pytest.mark.parametrize("name", ["sg2-convs2-fit", "biggan512-genz-fit"])
@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_fit_fault_is_not_correct(name, kind, monkeypatch):
    assert _run(name, monkeypatch, fault=_fit_fault(kind))["correct"] is False


def _strip_fault(kind):
    from ganspace_tpu_torch import edit
    from ganspace_tpu_torch.models import base
    strip, quant = edit.create_strip_centered, base.uint8_nhwc
    if kind == "state_unchanged":          # the W offset never applied
        def fn(*a, **k):
            a = list(a)
            a[10] = 0.0
            return strip(*a, **k)
        return edit, "create_strip_centered", fn
    if kind == "half_batch":               # the last frames left out, the first repeated
        def fn(*a, **k):
            out = strip(*a, **k)
            return [f[:2] + f[:len(f) - 2] for f in out]
        return edit, "create_strip_centered", fn

    def flipped(img):                      # the red channel's low bit of frame 0
        out = quant(img)
        out[0, ..., 0] ^= np.uint8(1)
        return out
    return base, "uint8_nhwc", flipped


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_strip_fault_is_not_correct(kind, monkeypatch):
    out = _run("sg2-w-render", monkeypatch, seconds=0.5, fault=_strip_fault(kind))
    assert out["correct"] is False


def test_mesh_run_over_four_processes(tmp_path):
    """The four-GPU cell's run on four CPU processes over gloo: correct
    when sound, not correct when the sketch's exchange between the ranks
    is left out."""
    cell = tiny_cell("sg2-convs2-fit-mesh4")
    harness.pin_env(cell.mix)
    out = harness.run_cell(cell, 2**31 + 9, 0.0, False, device="cpu")
    assert out["correct"] is True and out["device"]["count"] == 4
    cell.mix = {**cell.mix, "fault": ["ganspace_tpu_torch.parallel.mesh", "Mesh.reduce_scatter",
                                      "benchmark.tests.faults:reduce_scatter_left_out"]}
    assert harness.run_cell(cell, 2**31 + 9, 0.0, False, device="cpu")["correct"] is False
