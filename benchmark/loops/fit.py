"""Fits back to back through ``decomposition.compute``: a closed loop with
one client, the call the visualize CLI's ``get_or_compute`` makes on a
cache miss.

Fit ``i`` samples under its own seed, drawn from ``--seed`` and ``i``, and
writes its cache under the run's temporary directory; the file is kept
(renamed) when the fit is the one the check keeps, a reservoir of one
drawn from the seed, and deleted otherwise.  The window closes when the fit
running at ``--seconds`` ends, and that fit counts.  ``--trace 1``
profiles one whole fit (the mix's ``trace_fit``); the phases of the
others feed the fit pipeline's metrics.
"""

from __future__ import annotations

import math
import os
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import sketch

INT32_MAX = 2**31 - 1
CHECKS = ("mean", "var_ratio", "eig_residual", "lat_comp")


def fit_seed(seed: int, i: int) -> int:
    """The sampling seed of fit ``i`` (``i = -1``: the warm-up): in [1, 2^31)."""
    return int(np.random.default_rng([seed % 2**64, 1, i + 1]).integers(1, INT32_MAX))


@contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@dataclass
class Window:
    seconds: float = 0.0
    units: int = 0
    failed: int = 0
    samples: int = 0
    phases: list = field(default_factory=list)
    trace: object = None
    unit_flops: float = 0.0


class Loop:
    name = "fit"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix, self.model = ctx.cfg, ctx.mix, ctx.model
        self.kept = None

    # -- set-up ------------------------------------------------------------
    def setup(self):
        ctx, mix = self.ctx, self.mix
        self.weights = self.model.make_weights(self.cfg, ctx.seed, ctx.device)
        self.inst = self.model.build_port(self.cfg, self.weights, mix, ctx.device)
        from ganspace_tpu_torch.decomposition import get_max_batch_size
        self.batch = mix.get("batch") or get_max_batch_size(self.inst, layer_name=mix["layer"])
        self.n_total = mix["n"] // self.batch * self.batch
        self.d = self.model.tap_dim(self.cfg, mix["layer"])
        # the same shapes as the window's fits: the fused stream forced on
        # for a few blocks
        with _env(GANSPACE_FUSED_ACTS="1"):
            self._fit(mix["warmup_blocks"] * self.batch, fit_seed(ctx.seed, -1),
                      ctx.tmp / "warmup.npz")
        Path(ctx.tmp / "warmup.npz").unlink(missing_ok=True)

    def _config(self, n: int, seed: int):
        from ganspace_tpu_torch.config import Config
        mix, cfg = self.mix, self.cfg
        return Config(model=cfg["port_model"], output_class=mix.get("class") or cfg["port_class"],
                      layer=mix["layer"], estimator=mix["estimator"],
                      components=mix["components"], n=n, batch_size=mix.get("batch"),
                      use_w=False, seed=seed, dtype=cfg["dtype"], device=str(self.ctx.device))

    def _fit(self, n: int, seed: int, path: Path) -> dict:
        from ganspace_tpu_torch.decomposition import compute
        return compute(self._config(n, seed), path, self.inst, mesh=self.ctx.mesh)

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float, trace: bool, profiled) -> Window:
        ctx, win = self.ctx, Window()
        keep_rng = np.random.default_rng([ctx.seed % 2**64, 3])
        trace_at = self.mix["trace_fit"] if trace else -1
        mesh = ctx.mesh
        t0 = time.perf_counter()
        i = 0
        while True:
            seed, path = fit_seed(ctx.seed, i), ctx.tmp / f"fit{i}.npz"
            ts = time.perf_counter()
            try:
                if i == trace_at:
                    with profiled() as prof:
                        phases = self._fit(self.mix["n"], seed, path)
                    win.trace = prof.summary
                    win.unit_flops = self.n_total * self.flops_per_sample()
                else:
                    phases = self._fit(self.mix["n"], seed, path)
                    win.phases.append({**phases, "wall": time.perf_counter() - ts})
                win.samples += self.n_total
                if keep_rng.random() * (i + 1 - win.failed) < 1.0:
                    if path.exists():                    # rank 0 writes the cache
                        os.replace(path, ctx.tmp / "kept.npz")
                    self.kept = (i, seed)
            except Exception as e:                       # a fit that fails counts
                if mesh is not None:
                    raise                                # the other ranks cannot go on
                win.failed += 1
                print(f"fit {i} failed: {e!r}", flush=True)
                traceback.print_exc()
            finally:
                path.unlink(missing_ok=True)
            win.units += 1
            i += 1
            stop = time.perf_counter() - t0 >= seconds and (trace_at < 0 or i > trace_at)
            if mesh.decide(stop) if mesh is not None else stop:   # rank 0's clock
                break
        win.seconds = time.perf_counter() - t0
        print(f"window: {win.units} fits, {win.samples} samples in {win.seconds:.3f} s",
              flush=True)
        return win

    def flops_per_sample(self) -> float:
        """The generator's forward to the tap, the sketch's two products and
        the regression's cross-moments, once per sample."""
        l = sketch.sketch_size(self.mix["components"], self.d)
        zdim = self.model.latent_dim(self.cfg)
        return (self.model.sample_flops(self.cfg, self.mix) + 4.0 * self.d * l
                + 2.0 * self.d * zdim)

    def end_to_end(self, win: Window) -> dict:
        return {"fit_samples_per_s": (win.samples / win.seconds, "samples/s")}

    def free(self):
        self.inst.close()
        del self.inst

    # -- the check -------------------------------------------------------------
    def check(self) -> dict:
        """The kept fit against the reference fit of the same samples (every
        number infinite when no fit finished).  On a mesh every rank takes
        its share of the reference and rank 0, which holds the cache,
        judges; the other ranks return nothing."""
        if self.kept is None:
            return dict.fromkeys(CHECKS, math.inf)
        ref = self.reference_fit(self.kept[1])
        kept = self.ctx.tmp / "kept.npz"
        if not kept.exists():
            return {}
        with np.load(kept) as d:
            out = {k: d[k] for k in d.files if k != "_meta"}
        return self.judge(ref, out)

    def reference_fit(self, seed: int, tf32: bool = False) -> sketch.Fit:
        ctx, mix = self.ctx, self.mix
        ref = self.model.reference(self.cfg, self.weights, mix)
        n_blocks = self.n_total // self.batch
        group = max(1, mix["reference_rows"] // self.batch)

        def blocks(j):
            zs = [self.model.latent_block(self.cfg, mix, seed, k, self.batch, ctx.device)
                  for k in range(j * group, min((j + 1) * group, n_blocks))]
            z = torch.cat(zs)
            return ref.tap(z, mix["layer"]), z
        mesh = ctx.mesh
        return sketch.fit(blocks, math.ceil(n_blocks / group), mix["components"], self.d,
                          ctx.device, tf32=tf32,
                          share=(mesh.rank, mesh.size) if mesh is not None else (0, 1))

    @staticmethod
    def judge(ref: sketch.Fit, out: dict) -> dict:
        return sketch.judge(ref, out["act_mean"], out["act_comp"], out["act_stdev"],
                            out["var_ratio"], out["lat_comp"])

    @staticmethod
    def as_output(fit: sketch.Fit) -> dict:
        """A reference fit in the cache's form (the control's output)."""
        return {"act_mean": fit.mean.cpu().numpy(), "act_comp": fit.comp.cpu().numpy(),
                "act_stdev": np.sqrt(fit.explained), "var_ratio": fit.ratio,
                "lat_comp": fit.lat_comp.cpu().numpy()}
