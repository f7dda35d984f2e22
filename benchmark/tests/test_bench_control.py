"""On the card: the control, the reference computed with TF32 on and put in
the program's place, fails each cell's limits, and the program passes
them, at the cells' widths and a reduced number of samples or strips."""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness


def _loop(name, **mix):
    cell = harness.resolve(name)
    cell.mix = {**cell.mix, **mix}
    harness.pin_env(cell.mix)
    tmp = tempfile.TemporaryDirectory(prefix="ganspace-control-")
    drv = cell.loop.Loop(harness.Context(cell, 2**31 + 99, torch.device("cuda"),
                                         Path(tmp.name)))
    drv.setup()
    return cell, drv, tmp


def _fails(cell, numbers):
    return [k for k, v in numbers.items() if v > cell.limits[k]["limit"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name, n", [("sg2-convs2-fit", 25600), ("biggan512-genz-fit", 200000)])
def test_fit_control_fails_and_program_passes(name, n, cuda):
    cell, drv, tmp = _loop(name, n=n)
    with tmp:
        path = Path(tmp.name) / "fit.npz"
        drv._fit(n, 1234, path)
        with np.load(path) as d:
            got = {k: d[k] for k in d.files if k != "_meta"}
        ref = drv.reference_fit(1234)
        assert _fails(cell, drv.judge(ref, got)) == []
        control = drv.judge(ref, drv.as_output(drv.reference_fit(1234, tf32=True)))
        assert _fails(cell, control), control


@pytest.mark.cuda
def test_strip_control_fails_and_program_passes(cuda):
    cell, drv, tmp = _loop("sg2-w-render")
    with tmp:
        off = {"program": 0, "control": 0}
        total = 0
        for i in range(2):
            want = drv.reference_frames(i)
            off["program"] += int(np.count_nonzero(np.stack(drv._strip(i)) != want))
            off["control"] += int(np.count_nonzero(drv.reference_frames(i, tf32=True) != want))
            total += want.size
        limit = cell.limits["pixels_off"]["limit"]
        assert 100.0 * off["program"] / total <= limit
        assert 100.0 * off["control"] / total > limit
