"""The port's video writer, lightbox page and ``visualize --video`` against
the JAX package's: the same GIF frames, the same gallery page, and the same
output tree from the CLI on a tiny registered StyleGAN."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from ganspace_tpu import models as jax_models
from ganspace_tpu.apps import visualize as jax_visualize
from ganspace_tpu.models import stylegan as jax_sg1
from ganspace_tpu.tools.lightbox import write_lightbox as jax_write_lightbox
from ganspace_tpu.utils import video as jax_video

from ganspace_tpu_torch import models as torch_models
from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.models import stylegan as torch_sg1
from ganspace_tpu_torch.tools.lightbox import write_lightbox
from ganspace_tpu_torch.utils import video


@pytest.fixture(autouse=True)
def _few_threads():
    """These small models gain nothing from many intra-op threads, and under
    several test workers per machine many threads per worker oversubscribe
    the cores; the previous count is restored after each test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _frames(n=7, size=(12, 20), seed=0):
    rs = np.random.RandomState(seed)
    floats = [rs.rand(*size, 3).astype(np.float32) * 1.2 - 0.1 for _ in range(n)]
    return floats, [(255 * rs.rand(*size, 3)).astype(np.uint8) for _ in range(n)]


def _read_gif(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


@pytest.mark.parametrize("kind", ["float", "uint8", "sweep"])
def test_make_gif_frames_match_jax(tmp_path, kind):
    """The port converts each distinct frame to its palette once, on
    threads; the file must still be JAX's byte for byte (a sweep is its
    frames out and back, the same arrays twice)."""
    floats, ints = _frames()
    frames = {"float": floats, "uint8": ints, "sweep": ints + ints[::-1]}[kind]
    ref = jax_video.make_gif(frames, 5, tmp_path / "jax.mp4")
    got = video.make_gif(frames, 5, tmp_path / "port.mp4")
    assert ref is None and got == tmp_path / "port.gif"
    ref_frames, got_frames = _read_gif(tmp_path / "jax.gif"), _read_gif(got)
    # PIL merges the two identical frames at a sweep's turn into one
    assert len(got_frames) == len(ref_frames) == len(frames) - (kind == "sweep")
    for g, r in zip(got_frames, ref_frames):
        assert g.tobytes() == r.tobytes()
    assert got.read_bytes() == (tmp_path / "jax.gif").read_bytes()


def test_make_mp4_falls_back_to_gif_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    _, ints = _frames(n=3)
    assert video.make_mp4(ints, 1, tmp_path / "sweep.mp4") == tmp_path / "sweep.gif"
    assert len(_read_gif(tmp_path / "sweep.gif")) == 3


@pytest.mark.parametrize("images", [None, ["b.jpg", "a.png"]], ids=["scan", "given"])
def test_write_lightbox_matches_jax(tmp_path, images):
    for sub in ("jax", "port"):
        d = tmp_path / sub
        d.mkdir()
        for name in ("a.png", "b.jpg", "c.gif", "notes.txt"):
            (d / name).write_bytes(b"x")
    ref = jax_write_lightbox(tmp_path / "jax", title="StyleGAN <summ>", images=images)
    got = write_lightbox(tmp_path / "port", title="StyleGAN <summ>", images=images)
    assert got.name == ref.name == "+lightbox.html"
    assert got.read_text() == ref.read_text()


def test_visualize_video_tree_matches_jax(tmp_path, monkeypatch):
    """``--video`` on a tiny StyleGAN in W at ``g_mapping``: both CLIs hand
    the same sweeps to their writer under the same names and write the
    same grids and lightbox pages.  The writer itself is held to JAX's
    above; here it records its frames and writes an empty GIF (encoding
    44 sweeps of 300 frames would take most of the test's time)."""
    monkeypatch.setenv("GANSPACE_DEVICE_RNG", "0")
    cfg = dict(resolution=16, fmap_base=256)
    params = jax_sg1.init_params(jax_sg1.SG1Config(**cfg), 3)
    jax_model = jax_sg1.StyleGAN("ffhq", cfg=jax_sg1.SG1Config(**cfg), params=params)
    port = torch_sg1.StyleGAN("ffhq", cfg=torch_sg1.SG1Config(**cfg), params=params,
                              device="cpu")
    monkeypatch.setitem(jax_models._CUSTOM_MODELS, "TinyStyleGAN", lambda oc, **kw: jax_model)
    monkeypatch.setattr(torch_models, "_CUSTOM_MODELS", {})   # restored afterwards
    torch_models.register_model("TinyStyleGAN", lambda oc, device, **kw: port)
    sweeps = {"jax": {}, "torch": {}}

    def writer(side):
        def write(imgs, duration_secs, outname):
            out = Path(outname).with_suffix(".gif")
            sweeps[side][out.name] = np.stack([np.asarray(f) for f in imgs])
            out.write_bytes(b"")
            return out
        return write
    monkeypatch.setattr(jax_visualize, "make_mp4", writer("jax"))
    monkeypatch.setattr(visualize, "make_mp4", writer("torch"))
    args = ["--model", "TinyStyleGAN", "--class", "ffhq", "--layer", "g_mapping",
            "--use_w", "--est", "ipca", "-c", "1", "-n", "1024", "-b", "256", "--video"]

    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "jax"))
    jax_visualize.main(args + ["--mesh", "1"])
    monkeypatch.setenv("GANSPACE_OUTPUT_DIR", str(tmp_path / "torch"))
    result = visualize.main(args + ["--device", "cpu"])

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in (root / "out").rglob("*")
                      if p.is_file())

    names = tree(tmp_path / "torch")
    assert names == tree(tmp_path / "jax")
    base = "out/StyleGAN-ffhq/g_mapping/ipca"
    assert f"{base}/comp/W_sigma6.0_comp0.gif" in names
    assert f"{base}/inst/W_sigma2.0_img9_comp0.gif" in names
    assert {f"{base}/{d}/+lightbox.html" for d in ("comp", "inst", "summ")} <= set(names)
    # 2 sigmas x 1 edit mode x (1 component + 10 samples x 1 component)
    assert len(result.videos) == len(sweeps["torch"]) == 22
    assert sorted(sweeps["torch"]) == sorted(sweeps["jax"])
    for name, frames in sweeps["torch"].items():
        ref = sweeps["jax"][name]
        assert frames.shape == ref.shape == (300, 16, 16, 3) and frames.dtype == np.uint8
        assert np.array_equal(frames, frames[::-1])          # out and back
        assert np.abs(frames.astype(int) - ref).max() <= 1, name   # uint8 rounding
    assert result.images == 22 * 150 + (1 + 1 + 10) * 5
