"""Video/GIF writers (copy of ``ganspace_tpu/utils/video.py``, reference
``visualize.py:41-76``).

``make_mp4`` pipes raw RGB frames into ffmpeg/libx264 exactly like the
reference when ffmpeg is on PATH; otherwise it falls back to an animated GIF
(PIL) so sweep videos still render in minimal environments.  Both return
the path they wrote.
"""

from __future__ import annotations

import os
import shutil
import subprocess as sp
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
from PIL import Image

# clip+round quantization, uint8 passthrough: the same rule as the
# on-device readback (imaging.uint8_nhwc), so a sweep rendered as float or
# as uint8 writes byte-identical frames.
from ganspace_tpu_torch.imaging import to_uint8 as _u8


def _palette_frame(img) -> Image.Image:
    """One frame as PIL's GIF writer converts an RGB frame: to an adaptive
    256-color palette (``GifImagePlugin._normalize_mode``)."""
    return Image.fromarray(_u8(img)).convert("P", palette=Image.Palette.ADAPTIVE)


def make_gif(imgs, duration_secs: float, outname) -> Path:
    # The palette conversion is nearly all of the writer's time.  It runs
    # here first, once per distinct frame object (a sweep is its frames and
    # the same frames reversed) and on several threads (PIL's quantizer
    # releases the GIL); PIL then keeps the palette frames as they are, so
    # the file is the one it writes from the RGB frames, byte for byte.
    distinct = {id(x): x for x in imgs}
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        converted = dict(zip(distinct, pool.map(_palette_frame, distinct.values())))
    head, *tail = [converted[id(x)] for x in imgs]
    ms_per_frame = 1000 * duration_secs / len(imgs)
    out = Path(outname).with_suffix(".gif")
    head.save(str(out), format="GIF", append_images=tail, save_all=True,
              duration=ms_per_frame, loop=0)
    return out


def make_mp4(imgs, duration_secs: float, outname) -> Path:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        print(f"ffmpeg not found; writing GIF instead for {outname}")
        return make_gif(imgs, duration_secs, outname)

    assert len(imgs[0].shape) == 3, "Invalid shape of frame data"
    h, w = imgs[0].shape[0:2]
    fps = max(1, int(len(imgs) / duration_secs))

    # ffmpeg -s takes WIDTHxHEIGHT (the reference passes HxW, visualize.py:61,
    # harmless for its square frames; fixed here as in the JAX package).
    out = Path(outname).with_suffix(".mp4")
    command = [
        ffmpeg, "-y", "-f", "rawvideo", "-vcodec", "rawvideo",
        "-s", f"{w}x{h}", "-pix_fmt", "rgb24",
        "-r", f"{fps}", "-i", "-", "-an", "-c:v", "libx264",
        "-preset", "slow", "-crf", "17", str(out),
    ]
    frame_data = np.concatenate([_u8(x).reshape(-1) for x in imgs])
    with sp.Popen(command, stdin=sp.PIPE, stdout=sp.PIPE, stderr=sp.PIPE) as p:
        ret = p.communicate(frame_data.tobytes())
        if p.returncode != 0:
            print(ret[1].decode("utf-8"))
            raise sp.CalledProcessError(p.returncode, command)
    return out
