"""What the ranks of ``tests/test_torch_port_mesh.py`` run.

Each function is ``fn(mesh, spec)`` for ``parallel.launch``: a spawned rank
imports this module (torch and the port, never JAX) and returns a dict of
numpy arrays.  The parent runs the same calls on one process and holds the
two against each other."""

import os
from contextlib import contextmanager

import numpy as np
import torch

from ganspace_tpu_torch.apps import visualize
from ganspace_tpu_torch.config import Config
from ganspace_tpu_torch.decomposition import get_or_compute
from ganspace_tpu_torch.models import register_model
from ganspace_tpu_torch.models import stylegan2 as sg2
from ganspace_tpu_torch.models.base import InstrumentedModel
from ganspace_tpu_torch.parallel import mesh as meshlib

CHANNELS = ((4, 64), (8, 64), (16, 32), (32, 32))
#: the sketch-tier tap: 64 channels at 8 px, D = 4096, through the sketch
#: tier below GANSPACE_IPCA_MOMENTS_MAX_D
TAP, TAP_ENV = "convs.0", {"GANSPACE_IPCA_MOMENTS_MAX_D": "1024", "GANSPACE_FUSED_ACTS": "1",
                           "GANSPACE_IPCA_REFINE": "always", "GANSPACE_DEVICE_RNG": "1"}
TAP_CFG = dict(layer=TAP, estimator="ipca", components=8, n=2048, batch_size=256)
W_CFG = dict(layer="style", estimator="ipca", components=8, n=8192, use_w=True)


def tiny_model(use_w: bool = False) -> sg2.StyleGAN2:
    cfg = sg2.SG2Config(resolution=32, channels=CHANNELS)
    return sg2.StyleGAN2("ffhq", cfg=cfg, params=sg2.init_params(cfg, seed=3), use_w=use_w,
                         device="cpu")


@contextmanager
def environ(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fit(mesh, outdir: str, cfg: dict, **env) -> dict:
    """``get_or_compute`` on the tiny model: the cache's arrays, its
    ``_meta`` and its filename."""
    model = tiny_model()
    config = Config(model="StyleGAN2", output_class="ffhq", device="cpu", **cfg)
    with environ(GANSPACE_OUTPUT_DIR=outdir, **env):
        path = get_or_compute(config, InstrumentedModel(model), mesh=mesh)
    with np.load(path, allow_pickle=False) as d:
        out = {k: d[k] for k in d.files}
    out["name"] = path.name
    return out


def render_inputs():
    """A batch of 8 latents, its W+ list and a per-row activation offset."""
    model = tiny_model()
    z = model.sample_latent(8, seed=5)
    zl = [model.sample_latent(8, seed=5) for _ in range(model.get_max_latents())]
    offset = torch.linspace(-1.0, 1.0, 8 * 64 * 8 * 8).reshape(8, 64, 8, 8)
    return model, z, zl, offset


def render(model, z, zl, offset) -> dict:
    inst = InstrumentedModel(model)
    out = {"z": model.sample_np(z), "w_plus": model.sample_np(zl),
           "odd": model.sample_np(z[:5], uint8=True)}
    inst.edit_layer(TAP, offset=offset)
    out["edited"] = model.sample_np(z)
    inst.remove_edits()
    return out


def helpers(mesh) -> dict:
    """The sharding helpers and the Chan merge on rank-dependent data."""
    rs = np.random.RandomState(mesh.rank)
    x = torch.from_numpy(rs.randn(6, 8).astype(np.float32))
    count, mean, m2 = mesh.chan_merge(6, x.mean(0), (x - x.mean(0)).T @ (x - x.mean(0)))
    vcount, vmean, vm2 = mesh.chan_merge(6, x.mean(0), ((x - x.mean(0)) ** 2).sum(0))
    return {"odd": meshlib.shard_batch(torch.arange(5), mesh).numpy(),
            "even": meshlib.shard_batch(torch.arange(8), mesh).numpy(),
            "resharded": meshlib.reshard_for_estimator(x, mesh).numpy(),
            "count": count, "mean": mean.numpy(), "m2": m2.numpy(),
            "vcount": vcount, "vmean": vmean.numpy(), "vm2": vm2.numpy()}


def data_axis(mesh, outdir: str) -> dict:
    """Everything ``--mesh 2`` is held to: the helpers, the W fit on both
    RNG streams, the sketch tier at a conv tap, the render and the CLI."""
    out = {"helpers": helpers(mesh),
           "w_host": fit(mesh, f"{outdir}/w_host", W_CFG, GANSPACE_DEVICE_RNG="0"),
           "w_device": fit(mesh, f"{outdir}/w_device", W_CFG, GANSPACE_DEVICE_RNG="1"),
           "tap": fit(mesh, f"{outdir}/tap", TAP_CFG, **TAP_ENV)}
    model, z, zl, offset = render_inputs()
    model.place_on_mesh(mesh)
    out["render"] = render(model, z, zl, offset)
    register_model("TinyStyleGAN2", lambda oc, device, **kw: tiny_model())
    args = Config().from_args(["--model", "TinyStyleGAN2", "--class", "ffhq", "--use_w",
                               "--layer", "style", "--est", "ipca", "-c", "4", "-n", "2048",
                               "-b", "1024", "--device", "cpu"])
    with environ(GANSPACE_OUTPUT_DIR=f"{outdir}/cli", GANSPACE_DEVICE_RNG="0"):
        result = visualize.run(args, mesh)
    out["cli"] = {"cache": str(result.cache), "images": result.images}
    out["modules"] = imported_modules(mesh)
    return out


def model_axis(mesh, outdir: str) -> dict:
    """``--mesh 1x2``: the sketch tier with the features over the model axis."""
    return {"tap": fit(mesh, f"{outdir}/tap_1x2", TAP_CFG, **TAP_ENV)}


def imported_modules(mesh) -> list:
    """The top-level packages a spawned rank has imported."""
    import sys
    return sorted({m.split(".")[0] for m in sys.modules})
