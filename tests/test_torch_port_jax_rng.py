"""The JAX package's draws, handed to the port's dissection seams so that a
CPU test can hold the two packages to equal results: the quantile sketch's
coin flips (``ganspace_tpu/stats/running.py:111-132, 196``) and the label
sampler's Gumbel noise (``ganspace_tpu/dissection/dissect.py:256, 292``).
The other dissection test files import these; the tests here hold them to
the JAX package's key sequences written out step by step."""

import importlib
from functools import partial

import numpy as np
import torch
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@partial(jax.jit, static_argnums=1)
def _chain_flips(key, n):
    """bernoulli(sub) for sub of ``key, sub = split(key)``, n times."""
    def step(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.bernoulli(sub)
    return jax.lax.scan(step, key, None, length=n)[1]


def jax_flip_source(seed: int):
    """The port's ``flip_source`` with the JAX sketch's flips: one split of
    ``PRNGKey(seed)`` per flush, then one split per (chunk, level)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(n_chunks: int, depth: int) -> np.ndarray:
        state["key"], sub = jax.random.split(state["key"])
        return np.asarray(_chain_flips(sub, n_chunks * depth)).reshape(n_chunks, depth)
    return draw


def jax_label_noise(seed: int, batch_index: int, shape, device) -> torch.Tensor:
    """The port's ``label_noise`` with JAX's Gumbel draw of batch
    ``batch_index``: ``PRNGKey(seed)`` split once per batch."""
    key = jax.random.PRNGKey(seed)
    for _ in range(batch_index + 1):
        key, sub = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape)))).to(device)


def use_jax_draws(monkeypatch) -> None:
    """Swap both seams of the port for the JAX package's draws."""
    from ganspace_tpu_torch.stats import running
    monkeypatch.setattr(running, "flip_source", jax_flip_source)
    monkeypatch.setattr(port_dissect_module(), "label_noise", jax_label_noise)


def port_dissect_module():
    """``ganspace_tpu_torch.dissection.dissect``, the module (the package
    exports a function of the same name)."""
    return importlib.import_module("ganspace_tpu_torch.dissection.dissect")


def jax_dissect_module():
    """``ganspace_tpu.dissection.dissect``, the module."""
    return importlib.import_module("ganspace_tpu.dissection.dissect")


def test_flips_replay_the_jax_sketch_keys():
    """Per flush one split of the sketch's key, then per (chunk, level) one
    split and a bernoulli draw, as ``_sketch_insert`` does."""
    draw = jax_flip_source(5)
    key = jax.random.PRNGKey(5)
    for n_chunks in (3, 2):
        key, sub = jax.random.split(key)
        want = np.zeros((n_chunks, 4), bool)
        for c in range(n_chunks):
            for l in range(4):
                sub, s2 = jax.random.split(sub)
                want[c, l] = bool(jax.random.bernoulli(s2))
        assert np.array_equal(draw(n_chunks, 4), want)


def test_label_noise_replays_the_jax_batch_keys():
    key = jax.random.PRNGKey(2)
    for i in range(3):
        key, sub = jax.random.split(key)
        want = np.asarray(jax.random.gumbel(sub, (2, 7)))
        assert np.array_equal(jax_label_noise(2, i, (2, 7), "cpu").numpy(), want)
