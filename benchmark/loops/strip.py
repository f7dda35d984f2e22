"""Edit strips back to back through ``edit.create_strip_centered``: a
closed loop with one client, as the visualize CLI renders a strip.

Strip ``i`` draws its latent seed and its component from ``--seed`` and
``i``; a request is the latent's sampling (the mapping, in W) and the
strip, and ends when its uint8 frames are in host memory.  The window
closes when the strip running at ``--seconds`` ends, and that strip
counts.  A reservoir drawn from the seed keeps ``check_strips`` strips
for the check.  ``--trace 1`` profiles the strips ``trace_from`` to
``trace_from + trace_strips`` as one stretch.

The W-space components (unit rows, orthonormal), their mean and their
stdevs are inputs the benchmark makes from the seed: the render's work does
not depend on their values.
"""

from __future__ import annotations

import statistics
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.reference import ieee, sampling
from benchmark.reference.stylegan2 import centered_strip_ws, to_uint8

INT32_MAX = 2**31 - 1


@dataclass
class Window:
    seconds: float = 0.0
    units: int = 0
    failed: int = 0
    frames: int = 0
    latencies: list = field(default_factory=list)
    phases: list = field(default_factory=list)
    trace: object = None
    unit_flops: float = 0.0


def p95(values) -> float:
    """The 95th percentile (the exclusive method of ``statistics.quantiles``)."""
    return statistics.quantiles(values, n=100)[94] if len(values) > 1 else values[0]


class Loop:
    name = "strip"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix, self.model = ctx.cfg, ctx.mix, ctx.model
        self.kept = []

    def setup(self):
        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        self.weights = self.model.make_weights(cfg, ctx.seed, ctx.device)
        self.inst = self.model.build_port(cfg, self.weights, mix, ctx.device)
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed((ctx.seed + 1) % 2**63)
        c, wd = mix["components"], self.model.latent_dim(cfg)
        q, _ = torch.linalg.qr(torch.randn(wd, c, generator=gen, device=ctx.device))
        self.dirs = q.T.contiguous()
        self.mean = 0.5 * torch.randn(wd, generator=gen, device=ctx.device)
        self.stdev = 0.5 + torch.rand(c, generator=gen, device=ctx.device)
        self._strip(-1)

    def plan(self, i: int):
        """(latent seed, component) of strip ``i``."""
        rng = np.random.default_rng([self.ctx.seed % 2**64, 2, i + 1])
        return int(rng.integers(1, INT32_MAX)), int(rng.integers(self.mix["components"]))

    def _strip(self, i: int):
        from ganspace_tpu_torch.edit import create_strip_centered
        mix = self.mix
        z_seed, r = self.plan(i)
        w = self.inst.model.sample_latent(1, seed=z_seed)
        d, s = self.dirs[r:r + 1], self.stdev[r]
        return create_strip_centered(self.inst, mix["edit"], mix["layer"], [w], d, d, s, s,
                                     self.mean, self.mean, mix["sigma"], mix["layer_start"],
                                     mix["layer_end"], mix["frames"], as_uint8=True)[0]

    def window(self, seconds: float, trace: bool, profiled) -> Window:
        mix, win = self.mix, Window()
        keep_rng = np.random.default_rng([self.ctx.seed % 2**64, 3])
        k = mix["check_strips"]
        first, last = ((mix["trace_from"], mix["trace_from"] + mix["trace_strips"])
                       if trace else (-1, -1))
        prof = None
        t0 = time.perf_counter()
        i = 0
        while True:
            if i == first:
                prof = profiled().__enter__()
            ts = time.perf_counter()
            try:
                frames = self._strip(i)
                win.latencies.append(time.perf_counter() - ts)
                win.frames += len(frames)
                done = i + 1 - win.failed
                if len(self.kept) < k:
                    self.kept.append((i, frames))
                elif keep_rng.random() * done < k:
                    self.kept[int(keep_rng.integers(k))] = (i, frames)
            except Exception as e:                       # a strip that fails counts
                win.failed += 1
                print(f"strip {i} failed: {e!r}", flush=True)
                traceback.print_exc()
            win.units += 1
            i += 1
            if i == last:
                prof.__exit__(None, None, None)
                win.trace = prof.summary
                win.unit_flops = ((last - first) * mix["frames"]
                                  * self.model.frame_flops(self.cfg, mix))
            if time.perf_counter() - t0 >= seconds and i >= last:
                break
        win.seconds = time.perf_counter() - t0
        print(f"window: {win.units} strips, {win.frames} frames in {win.seconds:.3f} s",
              flush=True)
        return win

    def end_to_end(self, win: Window) -> dict:
        return {"render_frames_per_s": (win.frames / win.seconds, "frames/s"),
                "render_strip_ms_p95": (1e3 * p95(win.latencies), "ms")}

    def free(self):
        self.inst.close()
        del self.inst

    def reference_frames(self, i: int, tf32: bool = False) -> np.ndarray:
        """Strip ``i`` by the reference: [frames, H, W, 3] uint8."""
        mix, cfg = self.mix, self.cfg
        ref = self.model.reference(cfg, self.weights, mix)
        z_seed, r = self.plan(i)
        with torch.no_grad(), ieee(tf32):
            z = torch.from_numpy(sampling.host_gaussian(z_seed, cfg["w_dim"])).to(self.ctx.device)
            w = ref.mapping(z)
            end = mix["layer_end"] if mix["layer_end"] >= 0 else ref.n_latent
            ws = centered_strip_ws(w, self.dirs[r], float(self.stdev[r]), self.mean,
                                   mix["sigma"], mix["frames"], ref.n_latent,
                                   mix["layer_start"], end)
            return to_uint8(ref.synthesis(ws)).cpu().numpy()

    def check(self) -> dict:
        """The kept strips against the reference's: the share of uint8 values
        that differ (infinite when no strip finished)."""
        if not self.kept:
            return {"pixels_off": float("inf")}
        off = total = 0
        for i, frames in self.kept:
            want = self.reference_frames(i)
            got = np.stack(frames)
            off += int(np.count_nonzero(got != want))
            total += want.size
        return {"pixels_off": 100.0 * off / total}
