"""ProGAN and DCGAN checkpoints in the port, read without the JAX package,
against the JAX package's importers on the same synthetic files: the
GANDissect ``.pth``, the old ``features.N.*`` naming, the karras2018
tfutil pickle (the stubs of ``tests/test_tf_import.py``) and the
pytorch_GAN_zoo save (the GNet replica of ``tests/test_torch_import.py``),
each giving an identical parameter dict; then both constructors picking
the files up from ``$GANCONTROL_CHECKPOINT_DIR``, and a miss."""

import pickle

import numpy as np
import pytest
import torch

from ganspace_tpu.models import dcgan as jax_dc
from ganspace_tpu.models import proggan as jax_pg
from ganspace_tpu.models import tf_import as jax_tf
from ganspace_tpu.models import torch_import as jax_ti

from ganspace_tpu_torch.models import checkpoints, tf_import, torch_import
from ganspace_tpu_torch.models import dcgan as torch_dc
from ganspace_tpu_torch.models import proggan as torch_pg

from test_tf_import import _install_fake_nvlabs_modules, _network_state, _progan_tf_vars
from test_torch_import import _ZooGNet


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


SIZES = (64, 32, 32, 16)


def _expect_identical(got, ref):
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k


def _progan_params(seed=2):
    return jax_pg.init_params(jax_pg.ProGANConfig(SIZES), seed)


def _old_pt_state(params):
    """The old PyTorch naming of ``params``: ``features.N`` and ``output``."""
    state = {}
    for i, (name, *_) in enumerate(jax_pg.ProGANConfig(SIZES).layer_plan()):
        prefix = "output" if name.startswith("output") else f"features.{i}"
        state[f"{prefix}.conv.weight"] = torch.from_numpy(params[f"{name}.conv.weight"])
        state[f"{prefix}.wscale.b"] = torch.from_numpy(params[f"{name}.wscale.b"])
    return state


@pytest.mark.parametrize("wrapped", [False, True], ids=["state-dict", "state_dict-key"])
def test_import_progan_pth_matches_jax(tmp_path, wrapped):
    params = _progan_params()
    state = {k: torch.from_numpy(v) for k, v in params.items()}
    path = tmp_path / "bedroom_lsun.pth"
    torch.save({"state_dict": state} if wrapped else state, path)
    got, sizes = torch_import.import_progan(path)
    ref, ref_sizes = jax_ti.import_progan(torch.load(path, weights_only=False))
    assert sizes == ref_sizes == SIZES
    _expect_identical(got, ref)
    _expect_identical(got, params)


def test_import_progan_old_pt_naming_matches_jax(tmp_path):
    params = _progan_params(seed=4)
    path = tmp_path / "old.pth"
    torch.save(_old_pt_state(params), path)
    got, sizes = torch_import.import_progan(path)           # sniffs features.N.*
    ref, ref_sizes = jax_tf.import_progan_old_pt(_old_pt_state(params))
    assert sizes == ref_sizes == SIZES
    _expect_identical(got, ref)
    again, _ = tf_import.import_progan_old_pt(_old_pt_state(params))
    _expect_identical(again, ref)


def _progan_pickle(monkeypatch, path, params):
    Network = _install_fake_nvlabs_modules(monkeypatch, module="tfutil")
    tf = _progan_tf_vars(params, len(jax_pg.ProGANConfig(SIZES).layer_plan()) - 1)
    net = Network(_network_state("Gs", tf))
    net._state.pop("components", None)
    path.write_bytes(pickle.dumps((net, net, net), protocol=2))


def test_import_progan_tf_pickle_matches_jax(monkeypatch, tmp_path):
    params = _progan_params(seed=6)
    path = tmp_path / "karras2018-progan.pkl"
    _progan_pickle(monkeypatch, path, params)
    got, sizes = tf_import.import_progan_tf(path)
    ref, ref_sizes = jax_tf.import_progan_tf(str(path))
    assert sizes == ref_sizes == SIZES
    _expect_identical(got, ref)
    _expect_identical(got, params)


def _zoo_checkpoint(seed=3):
    """A pytorch_GAN_zoo hub save of the GNet replica, with non-trivial
    eval-mode batch-norm statistics."""
    torch.manual_seed(seed)
    net = _ZooGNet(dim_latent=32, dim_g=8, depth=2)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.3, 0.3)
            m.running_var.uniform_(0.5, 1.5)
    net.eval()
    return net, {"config": {"dimLatentVector": 32}, "netG": net.state_dict(), "netD": {}}


def test_import_ganzoo_dcgan_matches_jax_and_the_zoo_forward(tmp_path):
    net, ckpt = _zoo_checkpoint()
    path = tmp_path / "DCGAN.pth"
    torch.save(ckpt, path)
    got, cfg = torch_import.import_ganzoo_dcgan(path)
    ref, ref_cfg = jax_ti.import_ganzoo_dcgan(ckpt)
    _expect_identical(got, ref)
    assert (cfg.latent_dim, cfg.cond_dim, cfg.base_channels, cfg.resolution) == \
        (ref_cfg.latent_dim, ref_cfg.cond_dim, ref_cfg.base_channels, ref_cfg.resolution) \
        == (12, 20, 32, 32)
    model = torch_dc.GANZooModel("DCGAN-test", cfg=cfg, params=got, device="cpu")
    z = torch.from_numpy(np.random.RandomState(0).randn(3, 32).astype(np.float32))
    with torch.no_grad():
        want = 0.5 * (net(z) + 1)
    assert float((model.forward(z) - want).abs().max()) < 1e-5


def test_import_ganzoo_dcgan_is_name_agnostic():
    rs = np.random.RandomState(1)
    state = {
        "g.first.weight": torch.tensor(rs.randn(24, 16, 4, 4), dtype=torch.float32),
        "g.norm.weight": torch.ones(16), "g.norm.bias": torch.zeros(16),
        "g.norm.running_mean": torch.zeros(16), "g.norm.running_var": torch.ones(16),
        "g.norm.num_batches_tracked": torch.tensor(0),
        "g.last.weight": torch.tensor(rs.randn(16, 3, 4, 4), dtype=torch.float32),
    }
    got, cfg = torch_import.import_ganzoo_dcgan(state)
    ref, ref_cfg = jax_ti.import_ganzoo_dcgan(state)
    _expect_identical(got, ref)
    assert (cfg.z_total, cfg.resolution) == (ref_cfg.z_total, ref_cfg.resolution) == (24, 8)
    with pytest.raises(ValueError, match="fewer than two"):
        torch_import.import_ganzoo_dcgan({"g.first.weight": state["g.first.weight"]})


# -- the constructors under $GANCONTROL_CHECKPOINT_DIR ------------------------

@pytest.fixture
def ckpt_dir(tmp_path, monkeypatch):
    root = tmp_path / "checkpoints"
    for sub in ("progan", "ganzoo"):
        (root / sub).mkdir(parents=True)
    monkeypatch.setenv("GANCONTROL_CHECKPOINT_DIR", str(root))
    return root


def _expect_same_params(port, flat):
    state = port.state_dict()
    assert set(state) == set(flat)
    for k, v in flat.items():
        assert np.array_equal(state[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("suffix", [".pth", ".pkl"])
def test_progan_constructor_loads_the_file_as_in_jax(ckpt_dir, monkeypatch, suffix):
    params = _progan_params(seed=5)
    path = ckpt_dir / "progan" / f"kitchen_lsun{suffix}"
    if suffix == ".pth":
        torch.save({k: torch.from_numpy(v) for k, v in params.items()}, path)
    else:
        _progan_pickle(monkeypatch, path, params)
    assert checkpoints.locate_progan("kitchen") == (path, "progan/kitchen_lsun.pth")
    jax_model = jax_pg.ProGAN("kitchen")
    port = torch_pg.ProGAN("kitchen", device="cpu")
    assert port.cfg.sizes == jax_model.cfg.sizes == SIZES
    _expect_same_params(port, params)
    z = port.sample_latent(2, seed=3)
    ref = np.asarray(jax_model.forward(z.numpy()))
    got = port.forward(z).numpy()
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) < 1e-4


def test_dcgan_constructor_loads_the_file_as_in_jax(ckpt_dir):
    _, ckpt = _zoo_checkpoint(seed=4)
    torch.save(ckpt, ckpt_dir / "ganzoo" / "DCGAN.pth")
    assert checkpoints.locate_ganzoo("DCGAN") == (ckpt_dir / "ganzoo" / "DCGAN.pth",
                                                  "ganzoo/DCGAN.pth")
    jax_model = jax_dc.GANZooModel("DCGAN")
    port = torch_dc.GANZooModel("DCGAN", device="cpu")
    assert port.cfg.resolution == jax_model.cfg.resolution == 32
    _expect_same_params(port, {k: np.asarray(v) for k, v in jax_model.params.items()})
    z = port.sample_latent(3)
    ref = np.asarray(jax_model.forward(z.numpy()))
    got = port.forward(z).numpy()
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) < 1e-4


@pytest.mark.parametrize("family", ["ProGAN", "DCGAN"])
def test_miss_notes_the_path_and_keeps_the_seeded_init(ckpt_dir, capsys, family):
    """No file: a notice on stderr naming the path the reference layout
    gives, nothing on stdout, and the seeded random weights."""
    if family == "ProGAN":
        port = torch_pg.ProGAN("kitchen", resolution=8, init_seed=9, device="cpu")
        want = torch_pg.init_params(torch_pg.ProGANConfig.for_resolution(8), 9)
        rel = "progan/kitchen_lsun.pth"
    else:
        port = torch_dc.GANZooModel("DCGAN", init_seed=9, device="cpu")
        want = torch_dc.init_params(torch_dc.DCGANConfig(), 9)
        rel = "ganzoo/DCGAN.pth"
    out = capsys.readouterr()
    assert out.out == ""
    assert str(ckpt_dir / rel) in out.err and "seeded random initialization" in out.err
    _expect_same_params(port, want)
