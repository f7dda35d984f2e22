"""The port's ``makesample``, ``ganseg`` and ``allunitsample`` commands,
its image writer pool and ``unregister_model`` against the JAX package's.

``makesample`` on the default DCGAN (64 px; both packages build the same
seeded weights) writes JAX's files, each PNG within one uint8 level of
JAX's (the two float32 forwards may round a pixel the other way), and the
gallery page; the dispatcher's cases of ``tests/test_runners_tools.py``;
the four cases of ``tests/test_native.py`` on the port's pool, which
builds from its own source into ``build/``.  ``ganseg`` (the color
segmenter, and the unified one on the JAX tests' TINY net) and
``allunitsample`` on a tiny DCGAN registered in both packages with the
same weights: the same files, images within one uint8 level (so the same
top-k samples), segmentation halves equal but at near-tie pixels.
"""

import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ganspace_tpu import models as jax_models
from ganspace_tpu.models import dcgan as jax_dc
from ganspace_tpu.tools.allunitsample import main as jax_allunitsample
from ganspace_tpu.tools.ganseg import main as jax_ganseg
from ganspace_tpu.tools.makesample import main as jax_makesample

from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.__main__ import main as dispatch
from ganspace_tpu_torch.models import dcgan as torch_dc
from ganspace_tpu_torch.native import ImageWriterPool
from ganspace_tpu_torch.tools.makesample import main as makesample

MAX_LEVELS = 1


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_makesample_cli_matches_jax(tmp_path):
    args = ["--model", "DCGAN", "--size", "5", "--batch", "3"]
    assert jax_makesample(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert makesample(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "port").glob("image_*.png"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("image_*.png"))
    assert len(names) == 5
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / name), dtype=np.int16)
        ref = np.asarray(Image.open(tmp_path / "jax" / name), dtype=np.int16)
        assert got.shape == ref.shape == (64, 64, 3)
        assert np.abs(got - ref).max() <= MAX_LEVELS, name
    # the gallery page alongside (reference tool/makesample.py:97)
    page = (tmp_path / "port" / "+lightbox.html").read_text()
    assert "image_00004.png" in page and "<script" in page
    assert "http" not in page.split("</title>")[1]
    assert page == (tmp_path / "jax" / "+lightbox.html").read_text()


def test_package_entry_point(tmp_path, capsys):
    assert dispatch(["--help"]) == 0
    out = capsys.readouterr().out
    assert "visualize" in out and "makesample" in out
    assert dispatch(["nope"]) == 2
    assert dispatch(["makesample", "--model", "DCGAN", "--size", "2", "--batch", "2",
                     "--outdir", str(tmp_path), "--device", "cpu"]) == 0
    assert len(list(tmp_path.glob("image_*.png"))) == 2


def test_makesample_refuses_missing_card(tmp_path):
    """The default device is the card, which this command never trades for
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        makesample(["--model", "DCGAN", "--size", "1", "--outdir", str(tmp_path)])


def test_async_png_roundtrip(tmp_path):
    rs = np.random.RandomState(0)
    imgs = {f"im{i}.png": rs.randint(0, 256, (37, 53, 3), dtype=np.uint8)
            for i in range(8)}
    with ImageWriterPool(4) as pool:
        assert pool.native, "native build expected in this environment"
        for name, img in imgs.items():
            pool.save_png(tmp_path / name, img)
        pool.wait()
        assert pool.errors() == 0
    for name, img in imgs.items():
        assert np.array_equal(np.asarray(Image.open(tmp_path / name)), img), name


def _idat_stream(path) -> bytes:
    """The concatenated IDAT data of a PNG: its one zlib stream."""
    data, pos, out = Path(path).read_bytes(), 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            out += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


# raw scanline bytes (h * (3 w + 1)) just over the 8 MiB split threshold,
# and an uneven multiple of the 4 MiB piece: both deflate in pieces
@pytest.mark.parametrize("rows", [2730, 4777])
def test_split_deflate_png_roundtrip(tmp_path, rows):
    rs = np.random.RandomState(rows)
    img = (rs.randint(0, 4, (rows, 1024, 3))
           + np.arange(1024)[None, :, None] // 8).astype(np.uint8)
    assert rows * (3 * 1024 + 1) > 8 << 20
    with ImageWriterPool(2) as pool:
        assert pool.native, "native build expected in this environment"
        pool.save_png(tmp_path / "big.png", img)
        pool.wait()
        assert pool.errors() == 0
    assert np.array_equal(np.asarray(Image.open(tmp_path / "big.png")), img)
    # zlib checks the combined Adler-32 of the pieces
    raw = zlib.decompress(_idat_stream(tmp_path / "big.png"))
    scanlines = np.concatenate([np.zeros((rows, 1), np.uint8), img.reshape(rows, -1)], 1)
    assert raw == scanlines.tobytes()


def test_grayscale_and_rgba(tmp_path):
    rs = np.random.RandomState(1)
    gray = rs.randint(0, 256, (16, 16), dtype=np.uint8)
    rgba = rs.randint(0, 256, (16, 16, 4), dtype=np.uint8)
    with ImageWriterPool(2) as pool:
        pool.save_png(tmp_path / "g.png", gray)
        pool.save_png(tmp_path / "a.png", rgba)
        pool.wait()
        assert pool.errors() == 0
    assert np.array_equal(np.asarray(Image.open(tmp_path / "g.png")), gray)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), rgba)


def test_raw_write_and_error_count(tmp_path):
    with ImageWriterPool(2) as pool:
        pool.save_raw(tmp_path / "blob.bin", b"hello fastio")
        # invalid directory -> counted error, no exception
        pool.save_raw(tmp_path / "no_such_dir" / "x.bin", b"nope")
        pool.wait()
        assert pool.errors() == 1
    assert (tmp_path / "blob.bin").read_bytes() == b"hello fastio"


def test_rejects_float(tmp_path):
    with ImageWriterPool(1) as pool:
        with pytest.raises(ValueError):
            pool.save_png(tmp_path / "f.png", np.zeros((4, 4, 3), np.float32))


def test_pool_builds_from_own_source_into_build_dir():
    """The library is the port's own, keyed by its source, under build/."""
    from ganspace_tpu_torch import native
    from ganspace_tpu_torch.ops._build import BUILD_DIR
    lib = native._build()
    assert lib is not None
    path = native._lib_path()
    assert path.parent == BUILD_DIR and path.is_file()
    assert native._SRC == Path(native.__file__).parent / "src" / "fastio.cpp"
    assert not list(native._SRC.parent.glob("*.so"))


def test_pool_falls_back_to_pil(tmp_path, monkeypatch, capsys):
    """Without a compiler the pool says so and writes through PIL."""
    from ganspace_tpu_torch import native
    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "_CMD", ("no-such-compiler",) + native._CMD[1:])
    img = np.random.RandomState(2).randint(0, 256, (9, 7, 3), dtype=np.uint8)
    with ImageWriterPool(2) as pool:
        assert not pool.native
        pool.save_png(tmp_path / "p.png", img)
        pool.wait()
        assert pool.errors() == 0
    assert "using PIL fallback" in capsys.readouterr().out
    assert np.array_equal(np.asarray(Image.open(tmp_path / "p.png")), img)


def test_unregister_model():
    from ganspace_tpu_torch.models import (get_model, register_model,
                                           unregister_model)
    from ganspace_tpu_torch.models.dcgan import DCGANConfig, GANZooModel

    def factory(output_class, device, **kw):
        return GANZooModel("DCGAN", cfg=DCGANConfig(resolution=16, base_channels=64),
                           device=device)

    register_model("MyGAN", factory)
    try:
        assert get_model("MyGAN", device="cpu").get_latent_dims() > 0
    finally:
        unregister_model("MyGAN")
    with pytest.raises(RuntimeError, match="Unknown model"):
        get_model("MyGAN", device="cpu")
    unregister_model("MyGAN")                  # a second time: no error


@pytest.fixture
def tiny_dcgan(monkeypatch):
    """TinyDCGAN (16 px) registered in both packages with the same weights."""
    cfg = dict(resolution=16, base_channels=64)
    params = jax_dc.init_params(jax_dc.DCGANConfig(**cfg), 3)
    jax_model = jax_dc.GANZooModel(cfg=jax_dc.DCGANConfig(**cfg), params=params)
    port = torch_dc.GANZooModel(cfg=torch_dc.DCGANConfig(**cfg), params=params, device="cpu")
    monkeypatch.setitem(jax_models._CUSTOM_MODELS, "TinyDCGAN", lambda oc, **kw: jax_model)
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})
    torch_models.register_model("TinyDCGAN", lambda oc, device, **kw: port)


def _pngs(root):
    return sorted(p.name for p in root.glob("*.png"))


def _img(path):
    return np.asarray(Image.open(path), dtype=np.int16)


@pytest.mark.parametrize("segmenter", ["color", "unified"])
def test_ganseg_matches_jax(segmenter, tiny_dcgan, tmp_path, monkeypatch):
    if segmenter == "unified":
        from functools import partial

        from ganspace_tpu import dissection as jax_dissection
        from ganspace_tpu.dissection import segmodel as jsm
        from ganspace_tpu_torch import dissection as port_dissection
        from ganspace_tpu_torch.dissection import segmodel as tsm

        from test_torch_port_segmenter import tiny_upernet
        for pkg, m in ((jax_dissection, jsm), (port_dissection, tsm)):
            monkeypatch.setattr(pkg, "UnifiedParsingSegmenter",
                                partial(pkg.UnifiedParsingSegmenter, cfg=tiny_upernet(m),
                                        segsizes=(32,)))
    args = ["--model", "TinyDCGAN", "--size", "5", "--batch", "3", "--segmenter", segmenter]
    assert jax_ganseg(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert dispatch(["ganseg", *args, "--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = _pngs(tmp_path / "port")
    assert names == _pngs(tmp_path / "jax") and len(names) == 5
    for name in names:
        got, ref = _img(tmp_path / "port" / name), _img(tmp_path / "jax" / name)
        assert got.shape == ref.shape == (16, 32, 3)
        assert np.abs(got[:, :16] - ref[:, :16]).max() <= MAX_LEVELS, name
        same = np.all(got[:, 16:] == ref[:, 16:], axis=-1)
        assert same.mean() >= (1.0 if segmenter == "color" else 0.99), name
    assert (tmp_path / "port" / "+lightbox.html").read_text() == \
        (tmp_path / "jax" / "+lightbox.html").read_text()


def test_allunitsample_matches_jax(tiny_dcgan, tmp_path):
    args = ["--model", "TinyDCGAN", "--layer", "deconv1", "--samples", "12", "--batch", "4",
            "--topk", "3"]
    assert jax_allunitsample(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert dispatch(["allunitsample", *args, "--outdir", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    names = _pngs(tmp_path / "port")
    assert names == _pngs(tmp_path / "jax") and len(names) > 1
    for name in names:
        got, ref = _img(tmp_path / "port" / name), _img(tmp_path / "jax" / name)
        assert got.shape == ref.shape == (16, 48, 3)
        assert np.abs(got - ref).max() <= MAX_LEVELS, name
