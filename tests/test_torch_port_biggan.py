"""The port's BigGAN-deep against the JAX package's on identical weights.

Two small generators: ``tests/helpers.py``'s tiny config (32 px, z 16,
width 8, attention at module 2) and a narrow one on the real 128-px layer
plan (width 4, attention at 64 px).  On the CPU each kernel wrapper takes its
plain version, so these tests hold the model around the kernels against the
JAX package: the image and every tap of ``tap_names()`` to < 1e-4 relative,
with the JAX package's space-to-depth tail on (``GANSPACE_S2D=1``) and off,
at truncation 1.0 and 0.7 (the interpolated batch-norm statistics); the
relu stop rule and the channel-drop skip; the host latents bit for bit; the
class by id, alias and WNID, also through ``get_model(inst=...)``;
layer-wise latents over every slot; the pure tap function; and the nearest-up
composite kernel and the stride-1 3x3 conv against the JAX package's ops."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganspace_tpu.models import biggan as jax_bg
from ganspace_tpu.models import get_model as jax_get_model
from ganspace_tpu.models.base import InstrumentedModel as JaxInstrumented
from ganspace_tpu.ops import s2d
from ganspace_tpu.ops.pallas.blockconv import conv3x3_blocks_pallas
from ganspace_tpu.sampling import truncated_latents as jax_truncated_latents

from ganspace_tpu_torch import sampling
from ganspace_tpu_torch.models import biggan as torch_bg
from ganspace_tpu_torch.models import get_instrumented_model, get_model
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.ops.modconv import conv3x3, upsample_conv

TINY = dict(output_dim=32, z_dim=16, channel_width=8,
            layers=((False, 16, 16), (True, 16, 8), (True, 8, 4), (True, 4, 2)),
            attention_layer_position=2)
NARROW_128 = dict(channel_width=4)         # LAYERS_128, attention at 64 px
CONFIGS = {"tiny": TINY, "narrow128": NARROW_128}
REL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    """Small models gain nothing from many intra-op threads, and under
    several test workers many threads per worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(name="tiny", truncation=1.0, seed=3, class_name="husky"):
    cfg_kw = CONFIGS[name]
    params = jax_bg.init_params(jax_bg.BigGANConfig(**cfg_kw), seed)
    jax_model = jax_bg.BigGAN(128, class_name, truncation=truncation,
                              cfg=jax_bg.BigGANConfig(**cfg_kw), params=params)
    port = torch_bg.BigGAN(128, class_name, truncation=truncation,
                           cfg=torch_bg.BigGANConfig(**cfg_kw), params=params, device="cpu")
    return jax_model, port


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_bit_identical(name):
    ref = jax_bg.init_params(jax_bg.BigGANConfig(**CONFIGS[name]), 7)
    got = torch_bg.init_params(torch_bg.BigGANConfig(**CONFIGS[name]), 7)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_configs_taps_and_latent_slots():
    for res in (128, 256, 512):
        cfg, ref = torch_bg.BigGANConfig.for_resolution(res), jax_bg.BigGANConfig.for_resolution(res)
        assert cfg.module_plan() == ref.module_plan()
        assert cfg.n_latents == ref.n_latents
    assert torch_bg.BigGANConfig.for_resolution(512).n_latents == 15
    assert torch_bg.CLASS_ALIASES == jax_bg.CLASS_ALIASES
    jax_model, port = _pair("narrow128")
    assert port.tap_names() == jax_model.tap_names()
    assert set(port.state_dict()) == set(jax_model.params)
    assert port.get_max_latents() == jax_model.get_max_latents() == 11
    assert port.name == jax_model.name == "BigGAN-128-husky-t1.0"
    for layer in (None, "embeddings", "generator.gen_z", "generator.layers.9.conv_1",
                  "generator.layers.8", "generator.conv_to_rgb"):
        assert port._n_layers_for(layer) == jax_model._n_layers_for(layer)


def test_full_width_512_builds_on_the_cpu_when_asked(monkeypatch, tmp_path):
    """BigGAN-512 at full width: 58.69 M parameters, 15 latent slots; the
    entry points refuse without a card and build on the CPU when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("GANCONTROL_CHECKPOINT_DIR", str(tmp_path))
    for build in (lambda: get_model("BigGAN-512", "husky"),
                  lambda: torch_bg.BigGAN(512, "husky")):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    model = get_model("BigGAN-512", "husky", device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert model.device.type == "cpu" and n == 58_690_241 and 4 * n / 2 ** 20 > 223.8
    assert model.get_max_latents() == 15 and model.name == "BigGAN-512-husky-t1.0"
    ref = jax_bg.init_params(jax_bg.BigGANConfig.for_resolution(512), 0)
    assert sum(v.size for v in ref.values()) == n


def _run_both(pair, zs, taps, edit=None):
    """(port, JAX) image and retained taps of one forward over ``zs`` (one
    latent or a list, one per slot)."""
    jax_model, port = pair
    jinst, tinst = JaxInstrumented(jax_model), InstrumentedModel(port)
    jinst.retain_layers(taps)
    tinst.retain_layers(taps)
    if edit is not None:
        jinst.edit_layer(edit[0], offset=edit[1])
        tinst.edit_layer(edit[0], offset=edit[1])
    ref_img = np.asarray(jax_model.forward(zs))
    tz = [torch.tensor(z) for z in zs] if isinstance(zs, list) else torch.tensor(zs)
    img = port.forward(tz).numpy()
    out = {"image": (img, ref_img)}
    for t in taps:
        out[t] = (tinst.retained_features()[t].numpy(), np.asarray(jinst.retained_features()[t]))
    jinst.close()
    tinst.close()
    return out


@pytest.mark.parametrize("name,s2d_on,truncation", [
    ("tiny", "1", 1.0), ("tiny", "1", 0.7), ("tiny", "0", 1.0), ("tiny", "0", 0.7),
    ("narrow128", "1", 0.7), ("narrow128", "0", 1.0)])
def test_image_and_every_tap_match_jax(monkeypatch, name, s2d_on, truncation):
    monkeypatch.setenv("GANSPACE_S2D", s2d_on)
    pair = _pair(name, truncation)
    z = pair[0].sample_latent(3, seed=5)
    launches = (conv3x3.launches, upsample_conv.launches)
    out = _run_both(pair, np.asarray(z), pair[1].tap_names())
    assert (conv3x3.launches, upsample_conv.launches) == launches  # CPU: plain versions
    for tap, (got, ref) in out.items():
        assert got.shape == ref.shape, tap
        assert np.isfinite(got).all(), tap
        assert _rel(got, ref) < REL, (tap, _rel(got, ref))
    res = pair[1].resolution
    assert out["image"][0].shape == (3, 3, res, res)
    cfg = pair[1].cfg
    assert out["generator.conv_to_rgb"][0].shape[1] == cfg.channel_width * cfg.layers[-1][2]


def test_relu_stop_rule_and_channel_drop_skip():
    """A ``...relu`` tap keeps the block's last relu (the one after bn_3) in
    a partial forward too, as the reference's hook does; a block whose
    output is narrower than its input adds the first half of its input's
    channels, nearest-upsampled."""
    jax_model, port = _pair("tiny")
    z = jax_model.sample_latent(2, seed=9)
    zt = torch.tensor(np.asarray(z))
    base = "generator.layers.1"                          # up, 128 -> 64 channels
    taps = [f"{base}.relu", f"{base}.bn_3", f"{base}.conv_3", base, "generator.layers.0"]
    full = _run_both((jax_model, port), np.asarray(z), taps)
    inst = InstrumentedModel(port)
    inst.retain_layer(f"{base}.relu")
    port.partial_forward(zt, f"{base}.relu")
    relu = inst.retained_features()[f"{base}.relu"]
    jinst = JaxInstrumented(jax_model)
    jinst.retain_layer(f"{base}.relu")
    jax_model.partial_forward(z, f"{base}.relu")
    assert torch.equal(relu, torch.relu(torch.from_numpy(full[f"{base}.bn_3"][0])))
    assert torch.equal(relu, torch.from_numpy(full[f"{base}.relu"][0]))
    assert _rel(relu, np.asarray(jinst.retained_features()[f"{base}.relu"])) < REL
    assert torch.equal(port.pure_acts_fn(f"{base}.relu")(zt), relu.reshape(2, -1))

    x0 = torch.from_numpy(full["generator.layers.0"][0])          # [2, 128, 4, 4]
    skip = x0[:, :64].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    out = torch.from_numpy(full[f"{base}.conv_3"][0]) + skip
    assert torch.equal(out, torch.from_numpy(full[base][0]))
    assert full[base][0].shape == (2, 64, 8, 8)


@pytest.mark.parametrize("layer", ["generator.gen_z", "generator.layers.1.bn_2",
                                   "generator.layers.2", "generator.relu"])
def test_activation_edit_matches_jax(layer):
    pair = _pair("tiny", 0.7)
    z = np.array(pair[0].sample_latent(2, seed=4))
    inst = InstrumentedModel(pair[1])
    inst.retain_layer(layer)
    pair[1].partial_forward(torch.from_numpy(z), layer)
    shape = tuple(inst.retained_features()[layer].shape)
    inst.close()
    offset = 0.5 * np.random.RandomState(5).randn(*shape).astype(np.float32)
    out = _run_both(pair, z, ("generator.layers.4", "generator.conv_to_rgb"),
                    edit=(layer, offset))
    for name, (got, ref) in out.items():
        assert _rel(got, ref) < REL, (name, _rel(got, ref))


def test_conv_to_rgb_three_rows_unless_tapped():
    """Untapped, ``conv_to_rgb`` computes the image's three channels only;
    retained or edited, all of them: the image is the same either way, and
    an edit of the channels past the third leaves it unchanged."""
    pair = _pair("tiny", 0.7)
    port = pair[1]
    z = np.array(pair[0].sample_latent(2, seed=6))
    ref = np.asarray(pair[0].forward(z))
    plain = port.forward(torch.from_numpy(z))
    inst = InstrumentedModel(port)
    inst.retain_layer("generator.conv_to_rgb")
    tapped = port.forward(torch.from_numpy(z))
    rgb = inst.retained_features()["generator.conv_to_rgb"]
    assert rgb.shape == (2, 16, 32, 32)
    offset = torch.zeros(rgb.shape[1:])
    offset[3:] = 5.0
    inst.close()
    inst.edit_layer("generator.conv_to_rgb", offset=offset)
    edited = port.forward(torch.from_numpy(z))
    inst.close()
    assert _rel(plain, ref) < REL and _rel(tapped, ref) < REL
    assert torch.equal(edited, tapped)
    assert _rel(plain, tapped) < 1e-6
    assert torch.equal(tapped, 0.5 * (torch.tanh(rgb[:, :3]) + 1))


@pytest.mark.parametrize("n,dim,truncation,seed", [(1, 128, 1.0, 0), (7, 16, 0.7, 123),
                                                   (64, 128, 0.4, 2 ** 31 - 2)])
def test_truncated_latents_bit_identical(n, dim, truncation, seed):
    ref = jax_truncated_latents(n, dim, truncation, seed)
    got = sampling.truncated_latents(n, dim, truncation, seed)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)
    assert np.abs(got).max() <= 2 * truncation


def test_host_latent_streams_bit_identical():
    """The seedless host draws: ``sample_latent`` after ``seed_host_rng(s)``
    and the prefetched batches equal the JAX package's after
    ``np.random.seed(s)``."""
    jax_model, port = _pair("tiny", 0.7)
    np.random.seed(1)
    ref = [np.array(jax_model.sample_latent(4))] + [
        np.asarray(z) for z in jax_model.sample_latents_prefetched(3, 5)]
    port.seed_host_rng(1)
    got = [port.sample_latent(4)] + port.sample_latents_prefetched(3, 5, keep_on="cpu")
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), r)


def test_device_truncated_draw_bounded_and_distributed():
    """The per-block draw: never outside +-2 truncation, block i depends on i
    alone, and its moments are those of truncation * TruncNormal(-2, 2)."""
    from scipy.stats import truncnorm
    _, port = _pair("tiny", 0.7)
    fn = port.device_latents_fn()
    blocks = port.sample_latents_device(3, 20000, seed=1)
    again = fn(sampling.block_generator(1, sampling.STREAM_MAIN, 2, "cpu"), 20000)
    assert torch.equal(again, blocks[2]) and not torch.equal(blocks[0], blocks[1])
    z = torch.cat(blocks).reshape(-1).double()
    assert float(z.abs().max()) <= 2 * 0.7
    mean, var = truncnorm.stats(-2, 2, moments="mv")
    assert abs(float(z.mean())) < 3e-3
    assert abs(float(z.std()) - 0.7 * math.sqrt(var)) < 2e-3
    assert abs(float(z.mean()) - 0.7 * mean) < 3e-3
    assert port._gaussian_latent_dim() is None


@pytest.mark.parametrize("class_id,index,outclass", [
    (250, 250, "class250"), ("husky", 250, "husky"), ("Golden Retriever", 207, "golden_retriever"),
    ("n02110185", 250, "n02110185"), ("tabby", 281, "tabby"), ("class980", 980, "class980")])
def test_set_output_class_matches_jax(class_id, index, outclass):
    jax_model, port = _pair("tiny")
    jax_model.set_output_class(class_id)
    port.set_output_class(class_id)
    assert port.outclass == jax_model.outclass == outclass
    assert np.array_equal(port.v_class.numpy(), np.asarray(jax_model.v_class))
    assert int(port.v_class.argmax()) == index
    z = np.array(jax_model.sample_latent(2, seed=1))
    assert _rel(port.forward(torch.from_numpy(z)).numpy(), np.asarray(jax_model.forward(z))) < REL
    port.set_output_class(None)                       # no preference: kept
    assert port.outclass == outclass
    with pytest.raises(RuntimeError):
        port.set_output_class("no such imagenet class")
    with pytest.raises(RuntimeError):
        port.set_output_class(2.5)


def test_get_model_inst_reuse_changes_the_class():
    """``get_model(name, class, inst=...)`` returns the same BigGAN with the
    new class, as the JAX package does; ``get_instrumented_model`` with it
    closes the old instrumentation; another network is built anew."""
    jax_model, port = _pair("tiny")
    inst = InstrumentedModel(port)
    inst.retain_layer("generator.gen_z")
    again = get_model("BigGAN-128", "tabby", device="cpu", inst=inst)
    ref = jax_get_model("BigGAN-128", "tabby", inst=JaxInstrumented(jax_model))
    assert again is port and ref is jax_model
    assert port.outclass == jax_model.outclass == "tabby"
    assert int(port.v_class.argmax()) == 281
    got = get_instrumented_model("BigGAN-128", 250, "generator.gen_z", device="cpu",
                                 inst=inst)
    assert got.model is port and port.outclass == "class250"
    assert inst.retained_features() == {}
    assert got.feature_shape["generator.gen_z"] == (1, 4 * 4 * 16 * 8)
    assert port.get_conditional_state(None) is port.v_class
    c = torch.zeros(1, 1000)
    c[0, 7] = 1.0
    port.set_conditional_state(None, c)
    assert torch.equal(port.v_class, c)


def test_layerwise_latents_over_every_slot():
    """The reference's layer-wise contract (``tests/test_layerwise_z.py``):
    one latent copied into every slot reproduces the single-latent forward,
    and a latent changed in one slot moves the image as the JAX package's
    does, for every slot."""
    jax_model, port = _pair("tiny", 0.7)
    n = port.get_max_latents()
    assert n == 5
    z = np.array(jax_model.sample_latent(2, seed=3))
    other = np.array(jax_model.sample_latent(2, seed=4))
    single = port.forward(torch.from_numpy(z))
    assert torch.equal(port.forward(n * [torch.from_numpy(z)]), single)
    for slot in range(n):
        zs = [z] * n
        zs[slot] = other
        got = port.forward([torch.from_numpy(a) for a in zs])
        ref = np.asarray(jax_model.forward(zs))
        assert _rel(got, ref) < REL, slot
        assert not torch.equal(got, single), slot
    with pytest.raises(ValueError, match="latents"):
        port.forward([torch.from_numpy(z)] * (n - 1))


@pytest.mark.parametrize("layer", ["embeddings", "generator.gen_z", "generator.layers.1.conv_1",
                                   "generator.layers.2", "generator.layers.3.relu",
                                   "generator.conv_to_rgb"])
def test_pure_acts_matches_partial_forward_and_jax(layer):
    jax_model, port = _pair("tiny", 0.7)
    z = np.array(jax_model.sample_latent(4, seed=11))
    got = port.pure_acts_fn(layer)(torch.from_numpy(z))
    inst = InstrumentedModel(port)
    inst.retain_layer(layer)
    port.partial_forward(torch.from_numpy(z), layer)
    retained = inst.retained_features()[layer].reshape(4, -1)
    inst.close()
    jinst = JaxInstrumented(jax_model)
    jinst.retain_layer(layer)
    jax_model.partial_forward(z, layer)
    ref = np.asarray(jinst.retained_features()[layer]).reshape(4, -1)
    assert got.shape == retained.shape == ref.shape
    assert torch.equal(got, retained)
    assert _rel(got, ref) < REL, _rel(got, ref)


@pytest.mark.parametrize("b,c,co,hw", [(2, 16, 16, 4), (1, 8, 12, 7), (3, 32, 32, 16)])
def test_nearest_up_composite_matches_jax(b, c, co, hw):
    """An up-block's ``conv_1``, nearest 2x then a 3x3 conv, as the stride-2
    mode's transposed conv with the 4x4 composite kernel (padding 1): against
    the JAX package's ``nearestup_conv_blocks(pixel_input=True)`` and against
    the upsample-then-conv it replaces."""
    rs = np.random.RandomState(b + c + co + hw)
    x = rs.randn(b, c, hw, hw).astype(np.float32)
    w = (rs.randn(co, c, 3, 3) / math.sqrt(9 * c)).astype(np.float32)
    ref = np.asarray(s2d.blocks_to_nchw(s2d.nearestup_conv_blocks(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), pixel_input=True)))
    ck = torch_bg.nearest_up_kernel(torch.from_numpy(w))
    assert ck.shape == (co, c, 4, 4)
    launches = upsample_conv.launches
    got = upsample_conv(torch.from_numpy(x), ck, pad=1).numpy()
    assert upsample_conv.launches == launches              # CPU: the plain version
    assert got.shape == ref.shape == (b, co, 2 * hw, 2 * hw)
    assert _rel(got, ref) < 1e-5
    up = torch.from_numpy(x).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    direct = torch.nn.functional.conv2d(up, torch.from_numpy(w), padding=1).numpy()
    assert _rel(got, direct) < 1e-5


def test_up_block_keeps_its_composite_kernel():
    """The composite kernel is built once per weight and rebuilt after the
    weight changes."""
    _, port = _pair("tiny")
    block = port.generator.layers[1]
    assert block.up
    first, cache = block.w1.nearest_up(torch.float32)
    assert torch.equal(first, torch_bg.nearest_up_kernel(block.conv_1.weight))
    assert block.w1.nearest_up(torch.float32)[0] is first
    with torch.no_grad():
        block.conv_1.weight.mul_(2.0)
    again, _ = block.w1.nearest_up(torch.float32)
    assert again is not first and torch.allclose(again, 2.0 * first)


@pytest.mark.parametrize("b,hw,c,co", [(2, 4, 16, 16), (1, 8, 32, 32), (2, 16, 8, 8)])
def test_conv3x3_matches_pallas_blockconv(b, hw, c, co):
    """BigGAN's stride-1 3x3 convs (``conv_1`` of the blocks that keep their
    size, ``conv_2``, ``conv_to_rgb``) are the TPU kernel's own function:
    kernel B's plain mode against ``conv3x3_blocks_pallas`` in interpret
    mode, the call site ``biggan.py:290`` reaches."""
    rs = np.random.RandomState(hw + c)
    x = rs.randn(b, c, 2 * hw, 2 * hw).astype(np.float32)
    w = (rs.randn(co, c, 3, 3) / math.sqrt(9 * c)).astype(np.float32)
    ref = np.asarray(s2d.blocks_to_nchw(conv3x3_blocks_pallas(
        s2d.nchw_to_blocks(jnp.asarray(x)), jnp.asarray(w), interpret=True)))
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == ref.shape == (b, co, 2 * hw, 2 * hw)
    assert _rel(got, ref) < 1e-5
