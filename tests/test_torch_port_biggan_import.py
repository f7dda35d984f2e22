"""BigGAN checkpoints in the port: the HuggingFace ``.bin`` and the TF-Hub
variable dump, read without the JAX package, against the JAX package's
importers bit for bit; ``locate_biggan``'s miss and hit under a temporary
``$GANCONTROL_CHECKPOINT_DIR``; and the constructor's lookup order (the
``.bin``, then the TF dump, then the seeded init), as the JAX package's."""

import numpy as np
import pytest
import torch

from ganspace_tpu.models import biggan as jax_bg
from ganspace_tpu.models import tf_import as jax_tf
from ganspace_tpu.models import torch_import as jax_ti

from ganspace_tpu_torch.models import biggan as torch_bg
from ganspace_tpu_torch.models import checkpoints, tf_import, torch_import

from test_tf_import import _biggan_stats_list, _biggan_tf_vars


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


TINY = dict(output_dim=32, z_dim=16, channel_width=8,
            layers=((False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2)),
            attention_layer_position=2)


def _params(seed=2):
    return jax_bg.BigGANConfig(**TINY), jax_bg.init_params(jax_bg.BigGANConfig(**TINY), seed)


def _hf_state(params, with_v: bool, seed=0):
    """The HuggingFace layout of ``params``: every conv and linear of the
    generator (the class embedding excepted) as ``weight_orig`` with unit
    ``weight_u`` and, with ``with_v``, ``weight_v`` vectors, so that the
    baked weight differs from ``weight_orig`` (sigma != 1)."""
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in params.items():
        if k.endswith(".weight") and k != "embeddings.weight" and not k.startswith(
                "generator.bn."):
            base = k[:-len(".weight")]
            w_mat = 3.0 * v.reshape(v.shape[0], -1)
            # one power-iteration step from a random u0, as torch keeps them
            vv = w_mat.T @ rs.randn(w_mat.shape[0]).astype(np.float32)
            vv /= np.linalg.norm(vv)
            u = w_mat @ vv
            state[f"{base}.weight_orig"] = torch.from_numpy(3.0 * v)
            state[f"{base}.weight_u"] = torch.from_numpy(u / np.linalg.norm(u))
            if with_v:
                state[f"{base}.weight_v"] = torch.from_numpy(vv)
        else:
            state[k] = torch.from_numpy(v)
    return state


@pytest.mark.parametrize("with_v", [True, False], ids=["u-and-v", "u-only"])
def test_import_biggan_matches_jax_bit_for_bit(with_v, tmp_path):
    _, params = _params()
    state = _hf_state(params, with_v)
    ref = jax_ti.import_biggan(state)
    path = tmp_path / "pytorch_model.bin"
    torch.save(state, path)
    for src in (state, path):
        got = torch_import.import_biggan(src)
        assert set(got) == set(ref) == set(params)
        for k in ref:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], ref[k]), k
    # sigma != 1: the baked weights are not the stored ones
    assert not np.allclose(got["generator.gen_z.weight"], 3.0 * params["generator.gen_z.weight"])
    w, u = params["generator.conv_to_rgb.weight"] * 3.0, state["generator.conv_to_rgb.weight_u"]
    assert np.array_equal(torch_import.bake_spectral_norm(w, u.numpy(), None),
                          jax_ti.bake_spectral_norm(w, u.numpy(), None))


def test_import_biggan_tf_matches_jax_bit_for_bit(tmp_path):
    cfg, params = _params()
    port_cfg = torch_bg.BigGANConfig(**TINY)
    tf = _biggan_tf_vars(params, cfg, np.random.RandomState(11))
    stats = _biggan_stats_list(params, cfg, np.random.RandomState(3))
    ref = jax_tf.import_biggan_tf(tf, cfg=cfg, batch_stats=stats)
    got = tf_import.import_biggan_tf(tf, cfg=port_cfg, batch_stats=stats)
    path = tmp_path / "tf_weights.npz"
    np.savez(path, **tf, **{f"stats_{i}": s for i, s in enumerate(stats)})
    from_npz = tf_import.import_biggan_tf(str(path), cfg=port_cfg)
    no_stats = tf_import.import_biggan_tf(tf, cfg=port_cfg)
    ref_no_stats = jax_tf.import_biggan_tf(tf, cfg=cfg)
    assert set(got) == set(from_npz) == set(ref) == set(params) == set(no_stats)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
        assert np.array_equal(from_npz[k], ref[k]), k
        assert np.array_equal(no_stats[k], ref_no_stats[k]), k
    w, u0 = params["generator.conv_to_rgb.weight"], np.squeeze(tf["Generator/conv_to_rgb/u0"])
    assert np.array_equal(tf_import.bake_spectral_norm_tf(w, u0), jax_tf.bake_spectral_norm_tf(w, u0))


def test_tf_depth_inference_matches_jax():
    cfg, params = _params()
    tf = _biggan_tf_vars(params, cfg, np.random.RandomState(4))
    for module in (tf_import, jax_tf):
        with pytest.raises(ValueError, match="GBlocks"):
            module._biggan_config_for_vars(tf)       # 4 blocks: no public config
    narrow = jax_bg.BigGANConfig(channel_width=4)    # the 128-px plan's 10 blocks
    tf128 = _biggan_tf_vars(jax_bg.init_params(narrow, 0), narrow, np.random.RandomState(5))
    got, ref = tf_import._biggan_config_for_vars(tf128), jax_tf._biggan_config_for_vars(tf128)
    assert got.output_dim == ref.output_dim == 128 and got.layers == ref.layers


def test_locate_biggan_miss_and_hit(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("GANCONTROL_CHECKPOINT_DIR", str(tmp_path))
    rel = "biggan-deep-512/pytorch_model.bin"
    assert checkpoints.locate_biggan(512) == (None, None, rel)
    checkpoints.note_random_init("BigGAN-512", rel)
    assert str(tmp_path / rel) in capsys.readouterr().err
    (tmp_path / "biggan-deep-512").mkdir()
    np.savez(tmp_path / "biggan-deep-512" / "tf_weights.npz", x=np.zeros(1))
    assert checkpoints.locate_biggan(512) == (
        None, tmp_path / "biggan-deep-512" / "tf_weights.npz", rel)
    (tmp_path / rel).write_bytes(b"")
    assert checkpoints.locate_biggan(512) == (tmp_path / rel, None, rel)


@pytest.mark.parametrize("fmt", ["bin", "tf"])
def test_constructor_loads_what_it_finds_as_jax_does(fmt, tmp_path, monkeypatch, capsys):
    """A 32-px model built with ``params=None`` from a checkpoint directory
    holding the ``.bin`` (and a TF dump it must not read) or the TF dump
    alone: the same weights as the JAX package's constructor, bit for bit,
    and the same images; an empty directory gives the seeded init."""
    cfg, params = _params(seed=4)
    monkeypatch.setenv("GANCONTROL_CHECKPOINT_DIR", str(tmp_path))
    d = tmp_path / "biggan-deep-32"
    d.mkdir()
    np.savez(d / "tf_weights.npz",
             **_biggan_tf_vars(params, cfg, np.random.RandomState(9)),
             **{f"stats_{i}": s for i, s in
                enumerate(_biggan_stats_list(params, cfg, np.random.RandomState(3)))})
    if fmt == "bin":
        torch.save(_hf_state(params, with_v=True), d / "pytorch_model.bin")
    jax_model = jax_bg.BigGAN(32, "husky", cfg=cfg)
    port = torch_bg.BigGAN(32, "husky", cfg=torch_bg.BigGANConfig(**TINY), device="cpu")
    state = port.state_dict()
    assert set(state) == set(jax_model.params)
    for k, v in jax_model.params.items():
        assert np.array_equal(state[k].numpy(), np.asarray(v)), k
    z = np.array(jax_model.sample_latent(2, seed=1))
    img, ref = port.forward(torch.from_numpy(z)).numpy(), np.asarray(jax_model.forward(z))
    assert float(np.abs(img - ref).max() / np.abs(ref).max()) < 1e-4
    assert "no checkpoint" not in capsys.readouterr().err

    monkeypatch.setenv("GANCONTROL_CHECKPOINT_DIR", str(tmp_path / "empty"))
    seeded = torch_bg.BigGAN(32, "husky", cfg=torch_bg.BigGANConfig(**TINY), device="cpu",
                             init_seed=4)
    assert "no checkpoint" in capsys.readouterr().err
    for k, v in params.items():
        assert np.array_equal(seeded.state_dict()[k].numpy(), v), k
