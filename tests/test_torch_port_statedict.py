"""The port's ``utils/statedict`` against the JAX package's: the cases of
``tests/test_small_infra.py``, npz files written by either package read by
the other, and torch tensors as leaves."""

import numpy as np
import pytest
import torch

from ganspace_tpu.utils import statedict as jax_sd

from ganspace_tpu_torch import utils as port_utils
from ganspace_tpu_torch.utils import statedict as sd


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree():
    return {"a": {"w": np.ones((2, 3)), "b": np.zeros(4)},
            "layers": [np.full(2, 7.0), np.full(2, 8.0)]}


def _assert_flat_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_statedict_roundtrip(tmp_path):
    tree = _tree()
    flat = sd.flatten_tree(tree)
    assert set(flat) == {"a.w", "a.b", "layers.0", "layers.1"}
    nested = sd.unflatten_tree(flat)
    assert np.array_equal(nested["a"]["w"], tree["a"]["w"])
    assert np.array_equal(nested["layers"]["1"], tree["layers"][1])
    p = sd.save_state_dict(tmp_path / "s.npz", tree)
    loaded = sd.load_state_dict(p)
    assert np.array_equal(loaded["a.w"], tree["a"]["w"])
    loaded_nested = sd.load_state_dict(p, nested=True)
    assert np.array_equal(loaded_nested["a"]["b"], tree["a"]["b"])


def test_numpy_state_dict():
    out = sd.numpy_state_dict({"w": torch.ones(2, 2), "b": np.zeros(3)})
    assert isinstance(out["w"], np.ndarray) and out["w"].shape == (2, 2)
    assert isinstance(out["b"], np.ndarray) and out["b"].shape == (3,)


def test_flatten_matches_jax():
    tree = {**_tree(), "nested": ({"x": np.arange(3.0)}, [np.eye(2, dtype=np.float32)])}
    for prefix, sep in (("", "."), ("model", "/")):
        got = sd.flatten_tree(tree, prefix, sep)
        _assert_flat_equal(got, jax_sd.flatten_tree(tree, prefix, sep))
        assert sd.unflatten_tree(got, sep).keys() == jax_sd.unflatten_tree(got, sep).keys()


@pytest.mark.parametrize("writer,reader", [(jax_sd, sd), (sd, jax_sd)],
                         ids=["jax-to-port", "port-to-jax"])
def test_npz_crosses_packages(tmp_path, writer, reader):
    tree = {**_tree(), "i": np.arange(5, dtype=np.int64), "h": np.ones(3, np.float16)}
    path = writer.save_state_dict(tmp_path / "x" / "state.npz", tree)
    _assert_flat_equal(reader.load_state_dict(path), writer.load_state_dict(path))
    nested, ref = reader.load_state_dict(path, nested=True), writer.load_state_dict(
        path, nested=True)
    assert np.array_equal(nested["layers"]["0"], ref["layers"]["0"])


def test_torch_tensor_leaves(tmp_path):
    w = torch.randn(3, 4, requires_grad=True)
    tree = {"w": w, "blocks": [torch.arange(4), {"b": torch.zeros(2, dtype=torch.float64)}]}
    flat = sd.flatten_tree(tree)
    assert set(flat) == {"w", "blocks.0", "blocks.1.b"}
    assert all(isinstance(v, np.ndarray) for v in flat.values())
    assert np.array_equal(flat["w"], w.detach().numpy())
    assert flat["blocks.0"].dtype == np.int64 and flat["blocks.1.b"].dtype == np.float64
    loaded = jax_sd.load_state_dict(sd.save_state_dict(tmp_path / "t.npz", tree))
    _assert_flat_equal(loaded, flat)


def test_package_exports():
    for name in ("flatten_tree", "unflatten_tree", "save_state_dict",
                 "load_state_dict", "numpy_state_dict"):
        assert getattr(port_utils, name) is getattr(sd, name)
        assert name in port_utils.__all__
