"""The plain references agree with the program at tiny widths on the CPU:
StyleGAN2's tap and strip, BigGAN-deep's gen_z, the decomposition."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell


def _ctx(cell, seed, tmp):
    harness.pin_env(cell.mix)
    return harness.Context(cell, seed, torch.device("cpu"), Path(tmp))


@pytest.mark.parametrize("name, layer", [("sg2-convs2-fit", "convs.2"),
                                         ("sg2-convs2-fit", "conv1"),
                                         ("biggan512-genz-fit", "generator.gen_z")])
def test_tap_matches_the_program(name, layer, tmp_path):
    cell = tiny_cell(name)
    cell.mix = {**cell.mix, "layer": layer}
    ctx = _ctx(cell, 11, tmp_path)
    weights = cell.model.make_weights(cell.cfg, 11, "cpu")
    inst = cell.model.build_port(cell.cfg, weights, cell.mix, "cpu")
    z = cell.model.latent_block(cell.cfg, cell.mix, 5, 0, 16, "cpu")
    inst.retain_layer(layer)
    inst.model.partial_forward(z, layer)
    got = inst.retained_features()[layer].reshape(16, -1)
    want = cell.model.reference(cell.cfg, weights, cell.mix).tap(z, layer)
    assert got.shape == want.shape == (16, cell.model.tap_dim(cell.cfg, layer))
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    del ctx


def test_strip_matches_the_program(tmp_path):
    cell = tiny_cell("sg2-w-render")
    drv = cell.loop.Loop(_ctx(cell, 23, tmp_path))
    drv.setup()
    for i in range(3):
        got = np.stack(drv._strip(i))
        want = drv.reference_frames(i)
        assert got.shape == want.shape == (5, 32, 32, 3) and got.dtype == np.uint8
        assert np.count_nonzero(got != want) <= 2
        assert np.abs(got.astype(int) - want).max() <= 1
    # the edit moves the frames: the strip is not one image five times
    assert np.count_nonzero(want[0] != want[-1]) > want[0].size // 10


@pytest.mark.parametrize("name", ["sg2-convs2-fit", "biggan512-genz-fit"])
def test_fit_matches_the_program(name, tmp_path):
    cell = tiny_cell(name)
    drv = cell.loop.Loop(_ctx(cell, 31, tmp_path))
    drv.setup()
    path = tmp_path / "fit.npz"
    drv._fit(cell.mix["n"], 77, path)
    with np.load(path) as d:
        out = {k: d[k] for k in d.files}
    ref = drv.reference_fit(77)
    numbers = drv.judge(ref, out)
    assert set(numbers) == set(cell.limits)
    assert all(v < 1e-4 for v in numbers.values()), numbers
    # the reference's own output judges itself exact to float64 rounding
    assert all(v < 1e-9 for v in drv.judge(ref, drv.as_output(ref)).values())
