"""The StyleGAN3-T cell rehearsed on the CPU at tiny widths (32 px,
channel_max 16, all 14 layers): it resolves by name, the strip loop's
reference agrees with the program's strips, a whole run comes out
``correct`` and a broken one does not, a traced run records the filtered
leaky ReLU's calls, and the frame's work matches a count by hand."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, work
from benchmark.metrics import _flrelu

NAME = "sg3t-w-render"


def tiny_cell() -> harness.Cell:
    cell = harness.resolve(NAME)
    cell.cfg = {**cell.cfg, "resolution": 32, "channel_max": 16}
    mix = copy.deepcopy(cell.mix)
    mix.update(components=8, trace_from=1, trace_strips=2, check_strips=3)
    cell.mix = mix
    return cell


def test_cell_resolves_with_its_metrics():
    cell = harness.resolve(NAME)
    assert cell.cfg["model"] == "stylegan3" and cell.mix["loop"] == "strip"
    assert cell.cfg["reduced"] == [] and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "render_frames_per_s", "render_strip_ms_p95", "setup_s"}
    assert "flrelu_roofline.render" in cell.readers
    assert "modconv_roofline.render" in cell.readers
    assert "upconv_roofline.render" not in cell.readers


def test_strip_matches_the_program(tmp_path):
    cell = tiny_cell()
    harness.pin_env(cell.mix)
    drv = cell.loop.Loop(harness.Context(cell, 2**31 + 17, torch.device("cpu"), Path(tmp_path)))
    drv.setup()
    for i in range(3):
        got = np.stack(drv._strip(i))
        want = drv.reference_frames(i)
        assert got.shape == want.shape == (5, 32, 32, 3) and got.dtype == np.uint8
        assert np.count_nonzero(got != want) <= 2
        assert np.abs(got.astype(int) - want).max() <= 1
    assert np.count_nonzero(want[0] != want[-1]) > want[0].size // 10


def test_sound_and_broken_runs(monkeypatch):
    cell = tiny_cell()
    harness.pin_env(cell.mix)
    out = harness.run_cell(cell, 2**31 + 5, 0.0, False, device="cpu")
    json.loads(json.dumps(out, allow_nan=False))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert {"setup_s", "render_frames_per_s", "render_strip_ms_p95"} == set(out["metrics"])
    from ganspace_tpu_torch.models import base
    quant = base.uint8_nhwc

    def flipped(img):                      # the red channel's low bit of frame 0
        u = quant(img)
        u[0, ..., 0] ^= np.uint8(1)
        return u
    window = cell.loop.Loop.window

    def broken(self, *a, **k):
        monkeypatch.setattr(base, "uint8_nhwc", flipped)
        return window(self, *a, **k)
    monkeypatch.setattr(cell.loop.Loop, "window", broken)
    assert harness.run_cell(cell, 2**31 + 5, 0.0, False, device="cpu")["correct"] is False


def test_traced_strips_record_the_filtered_lrelu(tmp_path):
    cell = tiny_cell()
    harness.pin_env(cell.mix)
    drv = cell.loop.Loop(harness.Context(cell, 9, torch.device("cpu"), Path(tmp_path)))
    drv.setup()
    from benchmark.trace import Profiled
    ranges = {}
    for reader in cell.readers.values():
        ranges.update(reader.RANGES)
    win = drv.window(0.0, True, lambda: Profiled(ranges))
    calls = win.trace.calls["flrelu"]
    assert len(calls) == 2 * 15                     # two strips, 15 layers each
    assert all(_flrelu.cost(a, k)[0] > 0 for a, k in calls)
    assert len(win.trace.calls["modconv"]) == 2 * 14
    assert win.unit_flops == 2 * 5 * cell.model.frame_flops(cell.cfg, cell.mix)


def test_frame_flops_match_a_count_by_hand():
    """L10_1044_81 at 1024 px: the 3x3 conv 128 -> 81 at 534 px; the up
    filter's 24 taps on the x4 zero-stuffed map meet 6 samples each (its
    two passes over the 530 rows the padding keeps, then 2098 columns, of
    2098 outputs);
    the down filter's 12 taps at 1044 of 2098 outputs on each axis."""
    from benchmark.models import stylegan3
    cfg = json.loads((harness.ROOT / "benchmark/configs/StyleGAN3-T-FFHQ-1024.json").read_text())
    conv = 2.0 * 534 * 534 * 81 * 9 * 128
    assert work.modconv3x3(1, 128, 81, 534, 534)[0] == conv
    kept, hits = _flrelu._up_hits(534, 4, 24, -6, -9)
    assert kept == 530 and hits == 2098 * 6
    fir = 2.0 * 81 * (530 * 2098 * 6 + 2098 * 2098 * 6) + 2.0 * 81 * 12 * (2098 * 1044 + 1044 ** 2)
    flop, nbytes = _flrelu.filtered_lrelu(1, 81, 534, 534, 24, 12, 4, 2, (-6, -9))
    assert flop == fir and nbytes == 4 * (81 * (534 ** 2 + 1044 ** 2) + 81 + 36)
    upto9 = stylegan3._flops(cfg, stop_at="L9_532_128", mapping=False)
    upto10 = stylegan3._flops(cfg, stop_at="L10_1044_81", mapping=False)
    assert upto10 - upto9 == pytest.approx(work.linear(1, 512, 128) + conv + fir, rel=1e-12)
    # the 14 modulated 3x3 convs of a frame: 570 GFLOP
    convs = sum(work.modconv3x3(1, c, co, n + 2, n + 2)[0] for c, co, n in (
        (512, 512, 36), (512, 512, 36), (512, 512, 36), (512, 512, 52), (512, 512, 52),
        (512, 512, 84), (512, 512, 148), (512, 323, 148), (323, 203, 276), (203, 128, 276),
        (128, 81, 532), (81, 51, 1044), (51, 32, 1044), (32, 32, 1044)))
    assert convs / 1e9 == pytest.approx(570.245, abs=0.001)
    assert convs < stylegan3.frame_flops(cfg, {}) < convs * 1.1
