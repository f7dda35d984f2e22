"""Checkpoint import in the port against the JAX package, on the CPU.

Each test fabricates a reference-format checkpoint from the JAX package's
seeded ``init_params`` at a small configuration (as
``tests/test_torch_import.py`` and ``tests/test_tf_import.py`` do), puts it
in a temporary ``$GANCONTROL_CHECKPOINT_DIR`` under a test class added to
both packages' ``CONFIGS``, and builds both models with ``params=None``.
The parameters must be equal bit for bit, and the images agree to < 1e-4
relative (the bar of ``tests/test_torch_parity.py``)."""

import pickle

import numpy as np
import pytest
import torch

from ganspace_tpu.models import stylegan as jax_sg1
from ganspace_tpu.models import stylegan2 as jax_sg2
from test_tf_import import _install_fake_nvlabs_modules, _network_state, _sg1_tf_vars

from ganspace_tpu_torch.models import checkpoints
from ganspace_tpu_torch.models import stylegan as torch_sg1
from ganspace_tpu_torch.models import stylegan2 as torch_sg2

SG2_CHANNELS = ((4, 32), (8, 32), (16, 16))
SG1_FMAP_BASE = 128
RES = 16


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture
def ckpt_dir(tmp_path, monkeypatch):
    root = tmp_path / "ckpt"
    (root / "stylegan").mkdir(parents=True)
    (root / "stylegan2").mkdir()
    monkeypatch.setenv("GANCONTROL_CHECKPOINT_DIR", str(root))
    for configs in (jax_sg1.CONFIGS, torch_sg1.CONFIGS, jax_sg2.CONFIGS, torch_sg2.CONFIGS):
        monkeypatch.setitem(configs, "testclass", RES)
    return root


def _expect_same_params(port, jax_params):
    state = port.state_dict()
    assert set(state) == set(jax_params)
    for k, v in jax_params.items():
        assert np.array_equal(state[k].numpy(), np.asarray(v)), k


def _sg2_pair(truncation=1.0):
    jax_model = jax_sg2.StyleGAN2("testclass", truncation=truncation,
                                  cfg=jax_sg2.SG2Config(resolution=RES, channels=SG2_CHANNELS))
    port = torch_sg2.StyleGAN2("testclass", truncation=truncation, device="cpu",
                               cfg=torch_sg2.SG2Config(resolution=RES, channels=SG2_CHANNELS))
    return jax_model, port


def _sg1_pair():
    jax_model = jax_sg1.StyleGAN(
        "testclass", cfg=jax_sg1.SG1Config(resolution=RES, fmap_base=SG1_FMAP_BASE))
    port = torch_sg1.StyleGAN(
        "testclass", device="cpu",
        cfg=torch_sg1.SG1Config(resolution=RES, fmap_base=SG1_FMAP_BASE))
    return jax_model, port


def _expect_same_images(jax_model, port, seed):
    z = np.random.RandomState(seed).randn(2, 512).astype(np.float32)
    ref = np.asarray(jax_model.forward(z))
    got = port.forward(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (2, 3, RES, RES)
    assert _rel(got, ref) < 1e-4


def test_stylegan2_rosinality_pt_loads_as_in_jax(ckpt_dir, capsys):
    """The rosinality ``.pt`` (grouped-conv leading dim, noise and blur
    buffers, a non-zero ``latent_avg``): the same params and latent_avg in
    both packages, and the same images under truncation 0.7."""
    params = jax_sg2.init_params(jax_sg2.SG2Config(resolution=RES, channels=SG2_CHANNELS),
                                 seed=3)
    state = {}
    for k, v in params.items():
        t = torch.tensor(v)
        state[k] = t[None] if k.endswith(".conv.weight") else t   # [1, out, in, k, k]
    state["convs.0.conv.blur.kernel"] = torch.ones(4, 4)
    state["noises.noise_0"] = torch.zeros(1, 1, 4, 4)
    latent_avg = np.random.RandomState(4).randn(512).astype(np.float32)
    torch.save({"g_ema": state, "latent_avg": torch.from_numpy(latent_avg)},
               ckpt_dir / "stylegan2" / f"stylegan2_testclass_{RES}.pt")

    jax_model, port = _sg2_pair(truncation=0.7)
    out = capsys.readouterr()
    assert "no checkpoint" not in out.out + out.err
    _expect_same_params(port, {k: np.asarray(v) for k, v in jax_model.params.items()})
    _expect_same_params(port, params)
    assert np.array_equal(port.latent_avg.numpy(), np.asarray(jax_model.latent_avg))
    assert np.array_equal(port.latent_avg.numpy(), latent_avg)
    _expect_same_images(jax_model, port, seed=5)
    # truncation toward a non-zero latent_avg shows in the image
    loose = torch_sg2.StyleGAN2("testclass", device="cpu",
                                cfg=torch_sg2.SG2Config(resolution=RES, channels=SG2_CHANNELS))
    z = torch.from_numpy(np.random.RandomState(5).randn(2, 512).astype(np.float32))
    assert _rel(loose.forward(z).numpy(), port.forward(z).numpy()) > 1e-2


def test_stylegan_lernapparat_pt_loads_as_in_jax(ckpt_dir):
    """The lernapparat ``.pt`` state dict (with its fixed blur buffer)."""
    params = jax_sg1.init_params(
        jax_sg1.SG1Config(resolution=RES, fmap_base=SG1_FMAP_BASE), seed=1)
    state = {k: torch.tensor(v) for k, v in params.items()}
    state["g_synthesis.blocks.8x8.conv0_up.intermediate.kernel"] = torch.ones(1, 1, 3, 3)
    torch.save(state, ckpt_dir / "stylegan" / f"stylegan_testclass_{RES}.pt")

    jax_model, port = _sg1_pair()
    _expect_same_params(port, {k: np.asarray(v) for k, v in jax_model.params.items()})
    _expect_same_params(port, params)
    _expect_same_images(jax_model, port, seed=6)


@pytest.mark.parametrize("name", [f"stylegan_testclass_{RES}.pkl",
                                  f"karras2019stylegan-testclass-{RES}x{RES}.pkl"])
def test_stylegan_nvlabs_pickle_loads_as_in_jax(ckpt_dir, monkeypatch, name):
    """The NVlabs ``(G, D, Gs)`` pickle under either of its two names, read
    without TensorFlow through the fake ``dnnlib`` modules."""
    Network = _install_fake_nvlabs_modules(monkeypatch)
    cfg = jax_sg1.SG1Config(resolution=RES, fmap_base=SG1_FMAP_BASE)
    params = jax_sg1.init_params(cfg, seed=7)
    mapping, synthesis = _sg1_tf_vars(params, cfg)
    synthesis["noise3"] = np.zeros((1, 1, 8, 8), np.float32)
    synthesis["lod"] = np.float32(0.0)
    gs = Network(_network_state(
        "Gs", {"lod": np.float32(0.0), "dlatent_avg": np.zeros((512,), np.float32)},
        components={"mapping": Network(_network_state("G_mapping", mapping)),
                    "synthesis": Network(_network_state("G_synthesis", synthesis))}))
    g, d = Network(_network_state("G", {})), Network(_network_state("D", {}))
    (ckpt_dir / "stylegan" / name).write_bytes(pickle.dumps((g, d, gs), protocol=2))

    jax_model, port = _sg1_pair()
    _expect_same_params(port, {k: np.asarray(v) for k, v in jax_model.params.items()})
    _expect_same_params(port, params)
    _expect_same_images(jax_model, port, seed=8)


@pytest.mark.parametrize("family", ["StyleGAN2", "StyleGAN"])
def test_miss_notes_the_path_and_keeps_the_seeded_init(ckpt_dir, capsys, family):
    """No file: a notice on stderr naming the path the reference layout
    gives, nothing on stdout, and the seeded random weights as before."""
    if family == "StyleGAN2":
        cfg = torch_sg2.SG2Config(resolution=RES, channels=SG2_CHANNELS)
        port = torch_sg2.StyleGAN2("testclass", cfg=cfg, init_seed=9, device="cpu")
        want = torch_sg2.init_params(cfg, seed=9)
        rel = f"stylegan2/stylegan2_testclass_{RES}.pt"
    else:
        cfg = torch_sg1.SG1Config(resolution=RES, fmap_base=SG1_FMAP_BASE)
        port = torch_sg1.StyleGAN("testclass", cfg=cfg, init_seed=9, device="cpu")
        want = torch_sg1.init_params(cfg, 9)
        rel = f"stylegan/stylegan_testclass_{RES}.pt"
    out = capsys.readouterr()
    assert out.out == ""
    assert str(ckpt_dir / rel) in out.err and "seeded random initialization" in out.err
    _expect_same_params(port, want)


def test_default_root_is_the_jax_packages(monkeypatch):
    """Without the variable both packages look in the same directory."""
    from ganspace_tpu.models import checkpoints as jax_checkpoints
    monkeypatch.delenv("GANCONTROL_CHECKPOINT_DIR", raising=False)
    assert checkpoints.checkpoint_root() == jax_checkpoints.checkpoint_root().resolve()
