#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``ganspace_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: require CUDA and print the card's name and power limit;
2. build: compile the CUDA kernels from ``ganspace_tpu_torch/csrc``;
3. the 3xTF32 tensor-core step of ``csrc/tf32x3.cuh`` on one 16x8x8 tile;
4. kernel A (centered Gram) against its plain PyTorch version, on the card,
   with a wide-range case and a determinism check, and at the fused W
   stream's block shapes (5120 and 65536 rows of 512);
5. kernel B (modulated 3x3 conv) against its plain version, at the nine
   plain-3x3 shapes of 1024-px StyleGAN2 synthesis at the render's batch of
   5 (and at a batch of 2, for comparison with earlier runs), at the conv-tap
   path's two shapes (batch 128 at 4 and 8 px), plus a ragged and a
   wide-range case and a determinism check;
6. the W path in the default environment (device RNG, the fused W stream):
   ``visualize --model StyleGAN2 --class ffhq --use_w --layer style --est
   ipca -c 80 -n 40960`` on the full-width FFHQ-1024 generator (seeded
   random weights), with its launch counts, its cache and its grids checked;
7. the W fit alone at ``-n 1000000`` (15 blocks of 65536 and 4 of 4096);
8. the host-RNG W fit (``GANSPACE_DEVICE_RNG=0``) at ``-n 40960``, under
   seed 1 and seed 7: the statistical gate holds the device stream's
   components against the host stream's, judged by the host seed-1-vs-7
   control;
9. the conv-tap path in the default environment: ``visualize --model
   StyleGAN2 --class ffhq --layer convs.2 --est ipca -c 80 -n 50000`` in Z
   space (D = 512 * 16 * 16 = 131072; the fused activation stream of 390
   blocks of 128 with the sketch tier's refine pass, the regression's and
   the baselines' moments riding it; activation- and latent-mode grids),
   with its exact kernel-B launch count, its phase times, its cache and its
   grids checked; then the fused-regression gate: the same 390 blocks
   regenerated, the explicit normal equations solved against the run's
   components; then the upsampling convolution's repeatability and its
   time under cuDNN's deterministic algorithms;
10. the conv-tap fit alone at ``-n 20000``: the pre-sampled device stream
   with the regression sweep, the fused activation stream forced below its
   threshold (``GANSPACE_FUSED_ACTS=1``, timed against it), then the
   host-RNG one under seed 1 and seed 7, with the fused stream's
   components beside the seed control (reported, not gated);
11. one fit block of the pre-sampled conv-tap path and 16 blocks of the
   fused activation stream under ``torch.profiler`` (device time by kernel,
   busy share of the wall time), then the sketch tier on the card against exact
   PCA: a rank-2048 stream at D = 131072 with a slowly decaying spectrum,
   whose exact sample PCA is a 2048-dimensional float64 problem; the
   single-pass sketch must miss the bar there and the refined one pass it;
12. the sketch tier on the card against the same stream and Omega on the
   CPU (D = 32768);
13. one 1024-px image, one batch of ``convs.2`` activations and the latent
   regression (``linreg_lstsq`` on the host-RNG conv-tap fit's components)
   through the card (kernels) against the same model on the CPU (plain
   versions).

Kernel times are medians over launches by CUDA events, each launch after a
write of a 128 MB buffer that evicts the 50 MB L2 (in the render each
layer's weight is read once per forward, cold).  Beside each kernel stand
its plain version, the one PyTorch call that computes the same function
(``library_ms``, timed here only; the port never calls it) and its bound:
the larger of its FLOP over the 3xTF32 peak (495 / 3 = 165 TFLOP/s; the
kernels compute float32 products as 3xTF32) and its bytes (each input read
once, each output written once) over 3.35 TB/s, the H100 SXM's published
peaks at 700 W.  The FFMA bound (67 TFLOP/s) is printed beside it.

The last lines are a JSON summary of the kernels, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

MAIN_ARGS = ["--model", "StyleGAN2", "--class", "ffhq", "--use_w", "--layer",
             "style", "--est", "ipca", "-c", "80", "-n", "40960"]
W_N, W_N_1M = 40960, 1_000_000
# The fused W stream's blocks, from decomposition._compute: nb_w =
# min(65536, max(NB, n_total // 8)), whole nb_w blocks, then the remainder in
# NB = 4096 blocks.  At n = 40960: 8 blocks of 5120.  At n = 1M: n_total =
# 999424, 15 blocks of 65536 and 4 of 4096.
N_W_STREAM_BLOCKS, N_W_1M_BLOCKS = 8, 15 + 4
N_FIT_BLOCKS = 10                      # host stream: 40960 samples in blocks of 4096
N_CONV_LAUNCHES = 9 * 168              # 9 plain 3x3 convs per strip, 168 strips
# The statistical gate of the device stream: errors of the device-vs-host
# pair over errors of the host seed-1-vs-seed-7 control, each ratio under
# its bar.  ``cut_*``: 1 - the least principal-angle cosine between the
# top-m subspaces, at every m where the host spectrum has a relative gap of
# at least GATE_GAP (so near-degenerate eigenspaces are compared as
# wholes), their mean and their worst; ``median_cos``: the median over all
# components of 1 - |cos|; ``var_ratio``: the largest |difference|.  The
# bars were set before the first chip run, with room over the ratios of
# fits under other seeds on the CPU.  ``tests/test_torch_port_device_rng.py``
# prints those readings and plants a fault, a stream that repeats one block:
# it misses the three subspace bars by 2.3-4.1x on the W stream and by
# 2.1-6.3x at a conv tap (``var_ratio`` alone misses it on the W stream).
GATE_GAP = 0.05
GATE_RATIOS = {"cut_mean": 2.0, "cut_max": 3.0, "median_cos": 2.5, "var_ratio": 4.0}
# The conv-tap path at the JAX package's bench size (bench.py:119-182), on
# the fused activation stream: n_total = 49920, 390 blocks of one batch.
CONV50_N = 50000
CONV_ARGS = ["--model", "StyleGAN2", "--class", "ffhq", "--layer", "convs.2",
             "--est", "ipca", "-c", "80", "-n", str(CONV50_N)]
CONV_BATCH = 128          # heuristic batch at convs.2: 256 MiB / (131072 * 16 B)
CONV50_BLOCKS = CONV50_N // CONV_BATCH                         # 390
FUSED_REG_COS = 0.999
REGEN_REL = 1e-6          # a regenerated block's activations, max|d| / max|ref|
# The conv-tap fit at n = 20000, under the fused stream's 20000-sample
# threshold: the pre-sampled stream, from decomposition._compute:
CONV_N = 20000
CONV_NB = 2000            # max(batch, 2000, 3c)
CONV_N_TOTAL = CONV_N // CONV_BATCH * CONV_BATCH
CONV_BLOCKS = -(-CONV_N_TOTAL // CONV_NB)                      # 10
CONV20_FUSED_BLOCKS = CONV_N_TOTAL // CONV_BATCH               # 156, GANSPACE_FUSED_ACTS=1
CONV_FWD_PER_BLOCK = -(-CONV_NB // CONV_BATCH)                 # 16
CONV_FWD_REGRESSION = max(10_000, CONV_N) // CONV_BATCH        # 156
CONV_ACT_SHAPE = (80, 1, 512, 16, 16)
CONV_STRIPS = 12 * 14     # per edit mode: 12 grids of 14 rows
# kernel B per partial forward to convs.2 (conv1 at 4 px, convs.1 at 8 px)
# and per full forward (conv1 and convs.1, 3, ..., 15)
B_PER_TAP_FORWARD, B_PER_FORWARD = 2, 9
# the sketch gates: streams (g * spec) @ Q, Q [2048, D] with orthonormal
# rows, spec = 0.993^i: rank 6.4 l with a slow tail, where one sketch pass
# leaves the top 80 unresolved (min |cos| ~0.05-0.4 at a small D) and the
# refine pass resolves them (~1 - 1e-5)
GATE_D, GATE_CPU_D, GATE_RANK, GATE_DECAY, GATE_C = 131072, 32768, 2048, 0.993, 80
GATE_NB, GATE_BLOCKS, GATE_CPU_BLOCKS = 2000, 10, 4
GATE_COS, GATE_CPU_COS, TAP_REL, REG_COS = 0.999, 0.9999, 1e-4, 0.9999
NPZ_KEYS = {"act_comp", "act_mean", "act_stdev", "lat_comp", "lat_mean",
            "lat_stdev", "var_ratio", "random_stdevs", "_meta"}
# (N, D, explicit mu): the main path's block, then tests/test_pallas_moments.py's
GRAM_CASES = [(4096, 512, False), (300, 130, False), (77, 515, False),
              (256, 128, True)]
# the fused W stream's blocks at n = 40960 and n = 1M
GRAM_STREAM_SHAPES = [(5120, 512), (65536, 512)]
# (C, resolution): conv1 and convs.1, 3, ..., 15 of 1024-px synthesis
SYNTH_SHAPES = ((512, 4), (512, 8), (512, 16), (512, 32), (512, 64),
                (256, 128), (128, 256), (64, 512), (32, 1024))
RENDER_BATCH = 5                        # one strip of 5 frames per forward
# (B, C, Co, H, W): the render's shapes, the same at B = 2, then a ragged
# case: Co off the 64-channel tile, a map off the power-of-two pixel tiles
CONV_CASES = [(RENDER_BATCH, c, c, r, r) for c, r in SYNTH_SHAPES]
CONV_CASES_B2 = [(2, c, c, r, r) for c, r in SYNTH_SHAPES]
CONV_RAGGED = (2, 48, 40, 37, 23)
# the conv-tap path's shapes: conv1 (4 px) and convs.1 (8 px) at its batch
CONV_TAP_CASES = [(CONV_BATCH, 512, 512, 4, 4), (CONV_BATCH, 512, 512, 8, 8)]
# wide-range cases: X = 1e3 randn + 1e2 for A, s spanning 1e-2..1e2 for B
GRAM_WIDE = (4096, 512)
CONV_WIDE = [(RENDER_BATCH, 512, 512, 8, 8), (RENDER_BATCH, 512, 512, 64, 64)]
# 3xTF32 tensor-core sums against cuDNN's / cuBLAS's IEEE float32 sums: as
# accurate, in another order (tests/test_torch_port_tf32x3.py).
GRAM_ABS, GRAM_REL = 1e-4, 1e-5         # max|d| <= 1e-5 max|ref| + 1e-4
CONV_REL = 1e-5                         # max|d| / max|ref|
TILE_REL = 1e-6                         # one 16x8x8 step against float64
IMAGE_REL = 1e-3                        # 1024 px, 18 layers deep (fullres bar)
# H100 SXM published peaks at 700 W (NVIDIA H100 datasheet)
PEAK_3XTF32 = 495e12 / 3                # TF32 tensor cores, three passes
PEAK_FFMA = 67e12                       # float32 outside the tensor cores
PEAK_BYTES = 3.35e12
FLUSH_BYTES = 128 << 20                 # > the 50 MB L2
SLEEP_CYCLES = 200_000                  # ~0.1 ms at the H100's clock


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


_flush: torch.Tensor | None = None


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    each after a write that evicts the L2 and a ~0.1 ms device sleep, both
    outside the timed events: the sleep keeps the card busy while the host
    enqueues ``fn``, so the time is the device's and not the host's."""
    global _flush
    if _flush is None:
        _flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flop: float, nbytes: float) -> dict:
    """The least time for the work (3xTF32 FLOP or bytes), and the FFMA one."""
    t_flop, t_bytes = flop / PEAK_3XTF32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_flop, t_bytes),
            "bound_by": "operations" if t_flop >= t_bytes else "bytes",
            "bound_ffma_ms": max(flop / PEAK_FFMA * 1e3, t_bytes)}


def timed(ms: float, plain_ms: float, library_ms: float, bnd: dict) -> dict:
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bnd,
            "bound_share": bnd["bound_ms"] / ms}


def build():
    from ganspace_tpu_torch.ops._build import load_kernels
    lib = load_kernels()
    log(f"build: {lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")
    return lib


def check_tile(gen: torch.Generator) -> None:
    """The 3xTF32 step alone: fragment layouts and the split."""
    from ganspace_tpu_torch.ops.tf32x3 import tile_3xtf32
    a = torch.randn(16, 8, generator=gen, device="cuda")
    b = torch.randn(8, 8, generator=gen, device="cuda")
    got = tile_3xtf32(a, b).double()
    ref = a.double() @ b.double().T
    rel = float((got - ref).abs().max() / ref.abs().max())
    log(f"tf32x3 tile 16x8x8 against float64: rel {rel:.3e} (bar {TILE_REL:.0e})")
    if not rel < TILE_REL:
        raise AssertionError(f"3xTF32 tile: rel err {rel} >= {TILE_REL}")


def gram_bar(ref: torch.Tensor) -> float:
    return GRAM_REL * float(ref.abs().max()) + GRAM_ABS


def check_centered_gram(gen: torch.Generator) -> dict:
    from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
    timing = None
    cases = [(n, d, explicit, False) for n, d, explicit in GRAM_CASES]
    cases.append((*GRAM_WIDE, False, True))
    for n, d, explicit, wide in cases:
        x = torch.randn(n, d, generator=gen, device="cuda")
        x = x * 1e3 + 1e2 if wide else x * 2.0 + 0.5
        mu = torch.randn(d, generator=gen, device="cuda") if explicit else None
        got = centered_gram(x, mu)
        ref = centered_gram_plain(x, mu)
        torch.cuda.synchronize()
        err, bar = float((got - ref).abs().max()), gram_bar(ref)
        log(f"centered_gram N={n} D={d} mu={'given' if explicit else 'mean'}"
            f"{' wide-range' if wide else ''}: max|d|={err:.3e} (bar {bar:.3e})")
        if not err <= bar:
            raise AssertionError(f"centered_gram {n}x{d}: max|d| {err} > {bar}")
        if timing is None:                      # the host stream's block
            if not torch.equal(got, centered_gram(x, mu)):
                raise AssertionError("centered_gram: two launches differ")
            timing = gram_timing(x, err)
    # the fused W stream's blocks; the wrapper launches the kernel at every
    # shape (no plain fallback on the card)
    shapes = {}
    for n, d in GRAM_STREAM_SHAPES:
        x = torch.randn(n, d, generator=gen, device="cuda") * 2.0 + 0.5
        launches = centered_gram.launches
        got = centered_gram(x, x.mean(dim=0))
        if centered_gram.launches != launches + 1:
            raise AssertionError(f"centered_gram {n}x{d}: the kernel did not launch")
        ref = centered_gram_plain(x, x.mean(dim=0))
        torch.cuda.synchronize()
        err, bar = float((got - ref).abs().max()), gram_bar(ref)
        log(f"centered_gram N={n} D={d} (fused W stream block): max|d|={err:.3e} "
            f"(bar {bar:.3e})")
        if not err <= bar:
            raise AssertionError(f"centered_gram {n}x{d}: max|d| {err} > {bar}")
        if not torch.equal(got, centered_gram(x, x.mean(dim=0))):
            raise AssertionError(f"centered_gram {n}x{d}: two launches differ")
        shapes[f"{n}x{d}"] = gram_timing(x, err)
        del x, got, ref
    timing["shapes"] = shapes
    return timing


def gram_timing(x: torch.Tensor, err: float) -> dict:
    """Kernel A, its plain version and cuBLAS at one shape, beside the bound;
    the main path passes the block mean (estimators/ipca.py)."""
    from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
    n, d = x.shape
    mean = x.mean(dim=0)
    xc = x - mean
    row = timed(median_ms(lambda: centered_gram(x, mean)),
                median_ms(lambda: centered_gram_plain(x, mean)),
                median_ms(lambda: xc.T @ xc),
                bound(n * d * (d + 1), 4 * (n * d + d + d * d)))
    row["max_abs_err"] = err
    log(f"  N={n} D={d}: two launches bit-identical; kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, cuBLAS xc.T @ xc {row['library_ms']:.4f} "
        f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; FFMA "
        f"{row['bound_ffma_ms']:.4f} ms), share {row['bound_share']:.3f}")
    return row


def conv_inputs(gen: torch.Generator, case, wide: bool = False):
    from ganspace_tpu_torch.ops.modconv import demodulation
    b, c, co, h, w = case
    x = torch.randn(b, c, h, w, generator=gen, device="cuda")
    wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
    if wide:                                    # |s| from 1e-2 to 1e2
        s = 10.0 ** (4.0 * torch.rand(b, c, generator=gen, device="cuda") - 2.0)
    else:
        s = 1.0 + 0.5 * torch.randn(b, c, generator=gen, device="cuda")
    return x, wt, s, demodulation(wt, s)


def conv_err(got: torch.Tensor, ref: torch.Tensor, case, what: str):
    """(max|d|, max|d| / max|ref|); raises above the bar."""
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel < CONV_REL:
        raise AssertionError(f"modconv3x3 {case}{what}: rel err {rel} >= {CONV_REL}")
    return err, rel


def conv_bound(case) -> dict:
    b, c, co, h, w = case
    return bound(2.0 * b * h * w * co * 9 * c,
                 4.0 * (b * c * h * w + co * c * 9 + b * c + b * co + b * co * h * w))


def conv_row(case, x, wt, s, d) -> tuple[dict, str]:
    """Kernel, plain and cuDNN times of one shape beside its bound."""
    import torch.nn.functional as F
    from ganspace_tpu_torch.ops.modconv import modconv3x3, modconv3x3_plain
    xs = x * s[:, :, None, None]
    row = timed(median_ms(lambda: modconv3x3(x, wt, s, d)),
                median_ms(lambda: modconv3x3_plain(x, wt, s, d)),
                median_ms(lambda: F.conv2d(xs, wt, padding=1)),
                conv_bound(case))
    return row, (f" kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                 f" cuDNN {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                 f" ms ({row['bound_by']}; FFMA {row['bound_ffma_ms']:.4f} ms),"
                 f" share {row['bound_share']:.3f}")


def check_modconv3x3(gen: torch.Generator) -> dict:
    from ganspace_tpu_torch.ops.modconv import modconv3x3, modconv3x3_plain
    worst, worst_rel = 0.0, 0.0
    total = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_ffma_ms", "flop_ms"), 0.0)
    for case in CONV_CASES + [CONV_RAGGED]:
        x, wt, s, d = conv_inputs(gen, case)
        got = modconv3x3(x, wt, s, d)
        ref = modconv3x3_plain(x, wt, s, d)
        torch.cuda.synchronize()
        err, rel = conv_err(got, ref, case, "")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        b, c, co, h, w = case
        line = f"modconv3x3 B={b} C={c} Co={co} {h}x{w}: rel={rel:.3e} (bar {CONV_REL:.0e})"
        if case != CONV_RAGGED:
            row, times = conv_row(case, x, wt, s, d)
            for k in total:
                if k != "flop_ms":
                    total[k] += row[k]
            if row["bound_by"] == "operations":
                total["flop_ms"] += row["bound_ms"]
            line += times
        log(line)
        del x, got, ref
    tap = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    for case in CONV_TAP_CASES:
        x, wt, s, d = conv_inputs(gen, case)
        got = modconv3x3(x, wt, s, d)
        err, rel = conv_err(got, modconv3x3_plain(x, wt, s, d), case, "")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        row, times = conv_row(case, x, wt, s, d)
        for k in tap:
            tap[k] += row[k]
        b, c, co, h, w = case
        log(f"modconv3x3 B={b} C={c} Co={co} {h}x{w} (conv-tap path): "
            f"rel={rel:.3e} (bar {CONV_REL:.0e}){times}")
        del x, got
    for case in CONV_WIDE:
        x, wt, s, d = conv_inputs(gen, case, wide=True)
        got = modconv3x3(x, wt, s, d)
        err, rel = conv_err(got, modconv3x3_plain(x, wt, s, d), case, " wide-range")
        if not torch.equal(got, modconv3x3(x, wt, s, d)):
            raise AssertionError(f"modconv3x3 {case}: two launches differ")
        log(f"modconv3x3 {case} s in [1e-2, 1e2]: rel={rel:.3e}; two launches "
            f"bit-identical")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        del x, got
    for case in CONV_CASES_B2:                  # for comparison with earlier runs
        x, wt, s, d = conv_inputs(gen, case)
        ms = median_ms(lambda: modconv3x3(x, wt, s, d))
        plain_ms = median_ms(lambda: modconv3x3_plain(x, wt, s, d))
        log(f"modconv3x3 B=2 C={case[1]} {case[3]}x{case[4]}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        del x
    flop_ms = total.pop("flop_ms")
    bytes_ms = total["bound_ms"] - flop_ms
    result = {"max_abs_err": worst, "max_rel_err": worst_rel, **total,
              "bound_by": "operations" if flop_ms >= bytes_ms else "bytes",
              "bound_share": total["bound_ms"] / total["ms"],
              "conv_tap_shapes": tap}
    log(f"modconv3x3, the nine synthesis shapes at B={RENDER_BATCH}: kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, cuDNN "
        f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms (FFMA "
        f"{total['bound_ffma_ms']:.4f} ms), share {result['bound_share']:.3f}")
    log(f"modconv3x3, the two conv-tap shapes at B={CONV_BATCH}: kernel "
        f"{tap['ms']:.4f} ms, plain {tap['plain_ms']:.4f} ms, cuDNN "
        f"{tap['library_ms']:.4f} ms, bound {tap['bound_ms']:.4f} ms")
    return result


def conv_tap_launches(refined: bool, fused_blocks: int, cli: bool) -> int:
    """Kernel-B launches of a conv-tap run: the shape annotation (a CLI run
    builds its model) and the probe, one tap forward each; the fit pass and
    the refine pass when it ran (one tap forward per block of the fused
    stream of ``fused_blocks`` blocks, 16 per NB block of the pre-sampled
    one when ``fused_blocks`` is 0); the regression sweep unless the
    regression rode the stream; then, in a CLI run, per activation-mode
    strip one tap forward (the centering) and one full forward, per
    latent-mode strip one full forward."""
    if fused_blocks:
        fit_fwd, reg_fwd = fused_blocks, 0
    else:
        fit_fwd, reg_fwd = CONV_BLOCKS * CONV_FWD_PER_BLOCK, CONV_FWD_REGRESSION
    strips = CONV_STRIPS if cli else 0
    tap_forwards = (1 + int(cli) + fit_fwd * (2 if refined else 1) + reg_fwd
                    + strips)
    return B_PER_TAP_FORWARD * tap_forwards + 2 * B_PER_FORWARD * strips


@contextlib.contextmanager
def environ(**kw):
    """Set environment variables for a region, then restore them."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_launches() -> None:
    from ganspace_tpu_torch.ops.modconv import modconv3x3
    from ganspace_tpu_torch.ops.moments import centered_gram
    centered_gram.launches = 0
    modconv3x3.launches = 0


def read_launches() -> dict:
    from ganspace_tpu_torch.ops.modconv import modconv3x3
    from ganspace_tpu_torch.ops.moments import centered_gram
    return {"centered_gram": centered_gram.launches,
            "modconv3x3": modconv3x3.launches}


def load_cache(path) -> tuple[dict, dict]:
    """(arrays, _meta) of a component cache, its keys, finiteness and
    orthonormal ``act_comp`` rows checked."""
    with np.load(path, allow_pickle=False) as data:
        if set(data.files) != NPZ_KEYS:
            raise AssertionError(f"npz keys {sorted(data.files)}")
        arrays = {k: data[k] for k in NPZ_KEYS - {"_meta"}}
        meta = json.loads(bytes(data["_meta"].item()).decode())
    for k, a in arrays.items():
        if not np.isfinite(a).all():
            raise AssertionError(f"npz {k} is not finite")
    comp = arrays["act_comp"].reshape(80, -1)
    gram_err = float(np.abs(comp @ comp.T - np.eye(80)).max())
    if gram_err > 1e-4:
        raise AssertionError(f"act_comp rows not orthonormal: {gram_err}")
    arrays["gram_err"] = gram_err
    return arrays, meta


def expect_meta(meta: dict, what: str, **want) -> None:
    got = {k: meta.get(k) for k in want}
    if got != want:
        raise AssertionError(f"{what}: _meta {got}, expected {want}")


def fit_only(inst, layer: str, n: int, seed: int = 0, **env) -> dict:
    """``get_or_compute`` alone (no render) on ``inst``'s model, its launch
    counts, cache, wall seconds (device drained) and phase seconds."""
    from ganspace_tpu_torch.config import Config
    from ganspace_tpu_torch.decomposition import get_or_compute
    use_w = inst.model.latent_space_name() == "W"
    config = Config(model="StyleGAN2", output_class="ffhq", layer=layer,
                    estimator="ipca", components=80, n=n, use_w=use_w,
                    seed=seed or None, device="cuda")
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out, **env):
        phases = {}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        path = get_or_compute(config, inst, phases=phases)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        arrays, meta = load_cache(path)
    return {"launches": launches, "arrays": arrays, "meta": meta,
            "seconds": seconds, "phases": phases}


def fmt_phases(phases: dict) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())


def run_main_path(gpu: str) -> tuple[dict, dict]:
    """The W CLI run in the default environment: (its launch counts, its
    npz arrays)."""
    from ganspace_tpu_torch.apps import visualize

    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        reset_launches()
        result = visualize.main(list(MAIN_ARGS))
        launches = read_launches()
        log(f"main path launches: {launches}")
        if launches["centered_gram"] != N_W_STREAM_BLOCKS:
            raise AssertionError(f"centered_gram launched {launches['centered_gram']} "
                                 f"times, expected one per fused W block "
                                 f"({N_W_STREAM_BLOCKS})")
        if launches["modconv3x3"] != N_CONV_LAUNCHES:
            raise AssertionError(f"modconv3x3 launched {launches['modconv3x3']} "
                                 f"times, expected 9 per strip ({N_CONV_LAUNCHES})")
        arrays, meta = load_cache(result.cache)
        if arrays["act_comp"].reshape(80, -1).shape != (80, 512):
            raise AssertionError(f"act_comp shape {arrays['act_comp'].shape}")
        if not (np.diff(arrays["var_ratio"]) <= 1e-7).all():
            raise AssertionError("var_ratio is not descending")
        expect_meta(meta, "W path", device_rng=True, fused_linreg=False)
        # the four rows of the finish bundle: stdev, var_ratio, lat_stdev and
        # the random baselines from the moments that rode the stream
        for k in ("act_stdev", "var_ratio", "lat_stdev", "random_stdevs"):
            if arrays[k].shape != (80,) or not (arrays[k] > 0).all():
                raise AssertionError(f"{k}: not 80 positive values")
        summ = Path(out, "out", "StyleGAN2-ffhq", "style", "ipca", "summ")
        grids = sorted(p.name for p in summ.glob("*.jpg"))
        expected = (["components_W.jpg", "random_dirs_W.jpg"]
                    + [f"samp{i}_real_W.jpg" for i in range(10)])
        if grids != sorted(expected):
            raise AssertionError(f"summ grids {grids}")
        log(f"npz ok: keys, finite, |C C^T - I| = {arrays['gram_err']:.2e}, "
            f"_meta device_rng true, four baseline rows; {len(grids)} grids")
    fit_rate = W_N / result.fit_seconds
    render_rate = result.images / result.render_seconds
    log(f"fit: {result.fit_seconds:.3f} s, {fit_rate:.1f} samples/s; phases: "
        f"{fmt_phases(result.phases)} [{gpu}]")
    log(f"render: {result.images} images at 1024 px in "
        f"{result.render_seconds:.3f} s, {render_rate:.2f} images/s [{gpu}]")
    return launches, arrays


def run_w_fit_1m(gpu: str, inst) -> dict:
    """The W fit alone at n = 1M on the fused W stream."""
    run = fit_only(inst, "style", W_N_1M)
    log(f"W fit at n = {W_N_1M}: launches {run['launches']}")
    if run["launches"]["centered_gram"] != N_W_1M_BLOCKS:
        raise AssertionError(f"centered_gram launched {run['launches']['centered_gram']} "
                             f"times at n = 1M, expected {N_W_1M_BLOCKS}")
    expect_meta(run["meta"], "W fit at 1M", device_rng=True)
    n_total = W_N_1M // 4096 * 4096
    log(f"W fit at n = {W_N_1M} (n_total {n_total}): {run['seconds']:.3f} s, "
        f"{W_N_1M / run['seconds']:.1f} samples/s; phases: "
        f"{fmt_phases(run['phases'])} [{gpu}]")
    return run["launches"]


def min_angle_err(a: np.ndarray, b: np.ndarray, m: int) -> float:
    """1 - the least principal-angle cosine between the spans of the first
    ``m`` rows of ``a`` and of ``b``."""
    s = np.linalg.svd(a[:m].astype(np.float64) @ b[:m].astype(np.float64).T,
                      compute_uv=False)
    return float(1.0 - s.min())


def stream_gate(pair, control, stdev) -> tuple[list, dict, dict, dict]:
    """(cuts, errors of ``pair``, errors of ``control``, their ratios): each
    pair is two caches' arrays fitted on the same weights and n; the cuts m
    fall where ``stdev``'s spectrum has a relative gap >= GATE_GAP."""
    lam = np.asarray(stdev, np.float64) ** 2
    c = len(lam)
    cuts = [m for m in range(1, c) if (lam[m - 1] - lam[m]) / lam[m - 1] >= GATE_GAP]
    if not cuts:
        raise AssertionError("stream gate: the spectrum has no resolved cut")

    def errors(a, b):
        ca, cb = a["act_comp"].reshape(c, -1), b["act_comp"].reshape(c, -1)
        cut = [min_angle_err(ca, cb, m) for m in cuts]
        cos = np.abs(np.sum(ca.astype(np.float64) * cb, axis=1))
        return {"cut_mean": float(np.mean(cut)), "cut_max": float(np.max(cut)),
                "median_cos": float(np.median(1.0 - cos)),
                "var_ratio": float(np.abs(a["var_ratio"] - b["var_ratio"]).max())}
    err, ctrl = errors(*pair), errors(*control)
    ratios = {k: err[k] / max(ctrl[k], 1e-12) for k in err}
    return cuts, err, ctrl, ratios


def check_w_stream_gate(gpu: str, inst, device_arrays: dict) -> tuple[dict, dict]:
    """The host-RNG W fit (seed 1, the earlier path) and its seed-7 control,
    then the device stream's components against the host stream's."""
    runs = {}
    for seed in (0, 7):
        run = fit_only(inst, "style", W_N, seed=seed, GANSPACE_DEVICE_RNG=0)
        if run["launches"]["centered_gram"] != N_FIT_BLOCKS:
            raise AssertionError(f"centered_gram launched {run['launches']['centered_gram']} "
                                 f"times on the host W path, expected {N_FIT_BLOCKS}")
        expect_meta(run["meta"], "host W fit", device_rng=False)
        log(f"host-RNG W fit, seed {seed or 1}: {run['seconds']:.3f} s, "
            f"{W_N / run['seconds']:.1f} samples/s; launches {run['launches']}; "
            f"phases: {fmt_phases(run['phases'])} [{gpu}]")
        runs[seed] = run
    host, ctrl = runs[0]["arrays"], runs[7]["arrays"]
    cuts, err, ctrl_err, ratios = stream_gate((host, device_arrays), (host, ctrl),
                                              host["act_stdev"])
    log(f"W stream gate (n = {W_N}, c = 80, {len(cuts)} cuts at a relative gap "
        f">= {GATE_GAP}: {cuts}): device vs host "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + "; host seed 1 vs 7 " + ", ".join(f"{k} {v:.3e}" for k, v in ctrl_err.items())
        + "; ratios " + ", ".join(f"{k} {v:.3f} (bar {GATE_RATIOS[k]})"
                                  for k, v in ratios.items()))
    bad = [k for k, v in ratios.items() if not v <= GATE_RATIOS[k]]
    if bad:
        raise AssertionError(f"device W stream misses the control's bar on {bad}")
    return runs[0]["launches"], runs[7]["launches"]


def run_conv_tap_path(gpu: str) -> tuple[dict, dict]:
    """The conv-tap CLI run at n = 50000 on the fused activation stream:
    (its launch counts, its npz arrays).  The regression must ride the
    stream: the separate sweep is replaced by a function that raises."""
    from ganspace_tpu_torch import decomposition
    from ganspace_tpu_torch.apps import visualize

    def no_sweep(*args, **kwargs):
        raise AssertionError("the regression sweep ran on the fused stream")

    log(f"conv-tap path: -n {CONV50_N}, the JAX package's bench size")
    sweep = decomposition.regression
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        decomposition.regression = no_sweep
        try:
            reset_launches()
            result = visualize.main(list(CONV_ARGS))
            launches = read_launches()
        finally:
            decomposition.regression = sweep
        log(f"conv-tap path launches: {launches}")
        arrays, meta = load_cache(result.cache)
        log(f"_meta: refine_skipped={meta['refine_skipped']} "
            f"refine_stats={meta['refine_stats']}")
        expect_meta(meta, "conv-tap path", device_rng=True, fused_linreg=True)
        if meta.get("refine_skipped") not in (True, False):
            raise AssertionError(f"_meta {meta}: no refine decision")
        expected = conv_tap_launches(refined=not meta["refine_skipped"],
                                     fused_blocks=CONV50_BLOCKS, cli=True)
        if launches["modconv3x3"] != expected:
            raise AssertionError(f"modconv3x3 launched {launches['modconv3x3']} "
                                 f"times on the conv-tap path, expected {expected}")
        if launches["centered_gram"] != 0:
            raise AssertionError("centered_gram is not on the conv-tap path")
        if arrays["act_comp"].shape != CONV_ACT_SHAPE:
            raise AssertionError(f"act_comp shape {arrays['act_comp'].shape}")
        lat = arrays["lat_comp"].reshape(80, -1)
        if np.abs(np.linalg.norm(lat, axis=1) - 1.0).max() > 1e-5:
            raise AssertionError("lat_comp rows are not unit rows")
        summ = Path(out, "out", "StyleGAN2-ffhq", "convs.2", "ipca", "summ")
        grids = sorted(p.name for p in summ.glob("*.jpg"))
        names = ["components", "random_dirs"] + [f"samp{i}_real" for i in range(10)]
        if grids != sorted(f"{n}_{m}.jpg" for n in names for m in ("ACT", "Z")):
            raise AssertionError(f"summ grids {grids}")
        log(f"conv-tap npz ok: keys, finite, act_comp {CONV_ACT_SHAPE}, "
            f"|C C^T - I| = {arrays['gram_err']:.2e}, _meta device_rng and "
            f"fused_linreg true, no regression sweep; {len(grids)} grids")
    log(f"conv-tap fit: {result.fit_seconds:.3f} s, "
        f"{CONV50_N / result.fit_seconds:.1f} samples/s; phases: "
        f"{fmt_phases(result.phases)} [{gpu}]")
    log(f"conv-tap render: {result.images} images at 1024 px in "
        f"{result.render_seconds:.3f} s, "
        f"{result.images / result.render_seconds:.2f} images/s [{gpu}]")
    return launches, arrays


def check_fused_regression(gpu: str, model, arrays: dict) -> None:
    """The fused stream's 390 blocks regenerated from their per-block
    generators: the explicit normal equations G = sum a^T a, R = sum a^T z
    over them (a the stdev-scaled coordinates against the run's own
    components, float64) solved exactly, against ``lat_comp`` from
    ``regression_from_moments``.  Block 0 drawn again at the end must repeat
    its latents bit for bit (the per-block generator) and its activations to
    REGEN_REL: cuDNN's transposed convolution, the tap forward's upsampling,
    sums in no fixed order."""
    from ganspace_tpu_torch.decomposition import acts_stream_block
    from ganspace_tpu_torch.sampling import SEED_SAMPLING
    comp = torch.from_numpy(arrays["act_comp"].reshape(80, -1)).cuda()
    mean = torch.from_numpy(arrays["act_mean"].reshape(1, -1)).cuda()
    stdev = torch.from_numpy(arrays["act_stdev"]).cuda()
    block = acts_stream_block(model, "convs.2", CONV_BATCH, SEED_SAMPLING)
    t0 = time.perf_counter()
    first = block(0)
    g = torch.zeros((80, 80), dtype=torch.float64, device="cuda")
    r = torch.zeros((80, 512), dtype=torch.float64, device="cuda")
    for i in range(CONV50_BLOCKS):
        acts, z = first if i == 0 else block(i)
        coords = (((acts - mean) @ comp.T) / stdev).double()
        g += coords.T @ coords
        r += coords.T @ z.double()
    again = block(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    same = torch.equal(again[1], first[1])
    acts_rel = float((again[0] - first[0]).abs().max() / first[0].abs().max())
    exact = torch.linalg.solve(g, r).cpu().numpy()
    cos = _min_abs_cos(torch.from_numpy(arrays["lat_comp"].reshape(80, -1)),
                       torch.from_numpy(exact))
    log(f"fused regression vs the explicit solve over the same {CONV50_BLOCKS} "
        f"regenerated blocks: lat_comp min |cos| {cos:.7f} (bar {FUSED_REG_COS}); "
        f"block 0 regenerated: latents bit for bit {same}, activations rel "
        f"{acts_rel:.3e} (bar {REGEN_REL:.0e}); {seconds:.2f} s [{gpu}]")
    if not (cos > FUSED_REG_COS and same and acts_rel <= REGEN_REL):
        raise AssertionError("the fused regression or the block regeneration failed")


def check_upsample_determinism(gpu: str) -> None:
    """The tap forward's two upsampling convolutions (cuDNN transposed convs
    at batch 128, 512 channels, 4 -> 9 and 8 -> 17 px): how many of four
    repeats match the first launch bit for bit, and their time with cuDNN's
    deterministic algorithms forced, the price of a bit-reproducible
    stream.  Reported, not gated."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(3)
    for res in (4, 8):
        x = torch.randn(CONV_BATCH, 512, res, res, generator=gen, device="cuda")
        w = torch.randn(512, 512, 3, 3, generator=gen, device="cuda") / (9 * 512) ** 0.5

        def up():
            return F.conv_transpose2d(x, w, stride=2)
        y = up()
        repeats = sum(torch.equal(y, up()) for _ in range(4))
        ms = median_ms(up)
        old = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            det_ms = median_ms(up)
            det_same = torch.equal(up(), up())
        finally:
            torch.backends.cudnn.deterministic = old
        log(f"upsampling conv B={CONV_BATCH} C=512 {res} px: {repeats}/4 repeats "
            f"bit-identical, {ms:.4f} ms; cuDNN deterministic {det_ms:.4f} ms, "
            f"repeats bit-identical {det_same} [{gpu}]")


def run_conv_fit(gpu: str, inst, device_rng: bool, fused: bool = False,
                 seed: int = 0) -> dict:
    """The conv-tap fit alone at n = 20000: the pre-sampled stream (device
    or host draws) with the refine and regression sweeps, or with ``fused``
    the fused activation stream below its threshold
    (``GANSPACE_FUSED_ACTS=1``: 156 blocks of 128, no regression sweep)."""
    env = {"GANSPACE_DEVICE_RNG": int(device_rng)}
    if fused:
        env["GANSPACE_FUSED_ACTS"] = 1
    run = fit_only(inst, "convs.2", CONV_N, seed=seed, **env)
    meta = run["meta"]
    what = (f"conv-tap fit at n = {CONV_N}, "
            + ("fused stream" if fused else "device RNG" if device_rng else "host RNG")
            + (f", seed {seed}" if seed else ""))
    expect_meta(meta, what, device_rng=device_rng, fused_linreg=fused)
    expected = conv_tap_launches(refined=not meta["refine_skipped"],
                                 fused_blocks=CONV20_FUSED_BLOCKS if fused else 0,
                                 cli=False)
    if run["launches"]["modconv3x3"] != expected:
        raise AssertionError(f"{what}: modconv3x3 launched "
                             f"{run['launches']['modconv3x3']} times, expected {expected}")
    log(f"{what}: {run['seconds']:.3f} s, {CONV_N / run['seconds']:.1f} samples/s; "
        f"launches {run['launches']}; refine_skipped {meta['refine_skipped']}; "
        f"phases: {fmt_phases(run['phases'])} [{gpu}]")
    return run


def report_conv_stream_gate(gpu: str, fused: dict, host: dict, ctrl: dict) -> None:
    """The fused activation stream's components at n = 20000 against the
    host stream's, beside the host seed-1-vs-7 control: reported, not gated.
    The bars were set on the W spectrum; the random-init ``convs.2``
    spectrum is near-degenerate (few resolved cuts, so noisy ratios), and
    the conv-tap stream is gated on the CPU against the JAX package
    (``tests/test_torch_port_device_rng.py``)."""
    try:
        cuts, err, ctrl_err, ratios = stream_gate(
            (host["arrays"], fused["arrays"]), (host["arrays"], ctrl["arrays"]),
            host["arrays"]["act_stdev"])
    except AssertionError as e:
        log(f"conv-tap stream gate (reported): {e}")
        return
    log(f"conv-tap stream gate (n = {CONV_N}, reported, not gated; {len(cuts)} cuts "
        f"{cuts}): fused vs host " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + "; host seed 1 vs 7 " + ", ".join(f"{k} {v:.3e}" for k, v in ctrl_err.items())
        + "; ratios " + ", ".join(f"{k} {v:.3f} (W bar {GATE_RATIOS[k]})"
                                  for k, v in ratios.items()) + f" [{gpu}]")


def _device_us(event) -> float:
    return (getattr(event, "self_device_time_total", 0)
            or getattr(event, "self_cuda_time_total", 0))


def profile_run(gpu: str, what: str, fn) -> None:
    """Device time by kernel over one call of ``fn`` (after a warm-up call),
    and the device's busy share of its wall time (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if _device_us(e) > 0 and "CUDA" in str(getattr(e, "device_type", ""))]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    if not rows:
        log(f"{what} profile: the profiler reported no device time")
        return
    log(f"{what} profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}) [{gpu}]")
    for e in sorted(rows, key=_device_us, reverse=True)[:12]:
        log(f"  {_device_us(e) / 1e3:8.3f} ms {_device_us(e) / 1e3 / busy_ms:6.1%}"
            f"  x{e.count:<4d} {e.key[:90]}")


def profile_conv_tap_blocks(gpu: str) -> None:
    """One fit block of the pre-sampled conv-tap path (16 tap forwards at
    batch 128, their concatenation, one sketch update), then 16 blocks of
    the fused activation stream (each one tap forward and the sketch,
    regression and random-projection updates of ``fit_stream``)."""
    from ganspace_tpu_torch.decomposition import acts_stream_block
    from ganspace_tpu_torch.estimators.ipca import (
        IPCAEstimator, NystromState, nystrom_update, sketch_test_matrix)
    from ganspace_tpu_torch.models import get_instrumented_model
    from ganspace_tpu_torch.sampling import SEED_SAMPLING, random_directions_device
    inst = get_instrumented_model("StyleGAN2", "ffhq", "convs.2", torch.device("cuda"))
    model = inst.model
    inst.retain_layer("convs.2")
    zs = [model.sample_latent(CONV_BATCH, seed=s) for s in range(CONV_FWD_PER_BLOCK)]
    d, l = 512 * 16 * 16, 4 * 80
    t0 = time.perf_counter()
    omega = sketch_test_matrix(d, l).cuda()
    torch.cuda.synchronize()
    log(f"Omega [{d}, {l}] drawn on the host and uploaded (once per sketch-tier "
        f"fit): {time.perf_counter() - t0:.3f} s [{gpu}]")
    state = NystromState(0.0, torch.zeros(d, device="cuda"),
                         torch.zeros((), device="cuda"),
                         torch.zeros(d, l, device="cuda"))

    def block():
        chunks = []
        for z in zs:
            model.partial_forward(z, "convs.2")
            chunks.append(inst.retained_features()["convs.2"].reshape(CONV_BATCH, -1))
        return nystrom_update(state, torch.cat(chunks)[:CONV_NB], omega)
    profile_run(gpu, f"conv-tap block (pre-sampled, one NB={CONV_NB} block)", block)

    acts = acts_stream_block(model, "convs.2", CONV_BATCH, SEED_SAMPLING)
    dirs = random_directions_device(80, d, "cuda")
    # one estimator: the warm-up call draws Omega and allocates the state,
    # the profiled call streams blocks only
    est = IPCAEstimator(80, refine="never")

    def fused():
        est.fit_stream(acts, CONV_FWD_PER_BLOCK, with_reg=True, rand_dirs=dirs)
    profile_run(gpu, f"conv-tap fused stream ({CONV_FWD_PER_BLOCK} blocks of "
                     f"{CONV_BATCH}, one pass)", fused)


def _decay_stream(d: int, seed: int):
    """(Q [rank, D] with orthonormal rows, blocks of g * spec [NB, rank]) on
    the card, spec = 0.993^i: the stream is block @ Q."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.linalg.qr(torch.randn(d, GATE_RANK, generator=gen, device="cuda",
                                    dtype=torch.float64))[0]
    q = q.T.contiguous().float()
    spec = GATE_DECAY ** torch.arange(GATE_RANK, device="cuda", dtype=torch.float32)
    blocks = [torch.randn(GATE_NB, GATE_RANK, generator=gen, device="cuda") * spec
              for _ in range(GATE_BLOCKS)]
    return q, blocks


def _sketch_fit(xs, device: str):
    """The decomposition's sweep order with refine forced: pass, refine,
    pass.  Returns the first-pass and the refined components."""
    from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
    est = IPCAEstimator(GATE_C, refine="always")
    for x in xs():
        est.fit_partial(x.to(device))
    if est._nystrom is None:
        raise AssertionError("the stream did not take the sketch tier")
    first = est.get_components(device=True)[0]
    if not (est.should_refine() and est.begin_refine()):
        raise AssertionError("the sketch tier did not arm its refine pass")
    for x in xs():
        est.fit_partial(x.to(device))
    return first, est.get_components(device=True)[0]


def _min_abs_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))
    return float(cos.abs().min())


def check_sketch_gate(gpu: str) -> None:
    """The rank-2048 stream at D = 131072 on the card: the single-pass and
    the refined components against the exact sample PCA (a 2048 x 2048
    float64 eigh).  The single pass must miss the bar, or the stream could
    not tell a working refine from a broken one."""
    from ganspace_tpu_torch.estimators.ipca import NystromState, nystrom_update
    q, blocks = _decay_stream(GATE_D, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, comp = _sketch_fit(lambda: (g @ q for g in blocks), "cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    g = torch.cat(blocks).double()
    g -= g.mean(0)
    evecs = torch.linalg.eigh((g.T @ g).cpu())[1]
    exact = evecs[:, -GATE_C:].flip(1).T.cuda() @ q.double()
    cos_first, cos = _min_abs_cos(first, exact), _min_abs_cos(comp, exact)
    del g, exact
    # one sketch update alone at this shape: x @ Omega and x^T (x Omega)
    x = blocks[0] @ q
    omega = torch.randn(GATE_D, 4 * GATE_C, device="cuda")
    state = NystromState(0.0, torch.zeros(GATE_D, device="cuda"),
                         torch.zeros((), device="cuda"),
                         torch.zeros(GATE_D, 4 * GATE_C, device="cuda"))
    upd_ms = median_ms(lambda: nystrom_update(state, x, omega), reps=10)
    flop = 2 * 2.0 * GATE_NB * GATE_D * 4 * GATE_C
    log(f"sketch gate: rank {GATE_RANK}, stdev {GATE_DECAY}^i, at D={GATE_D}, "
        f"{GATE_BLOCKS} blocks of {GATE_NB}, c={GATE_C}, two passes {fit_s:.3f} s: "
        f"min |cos| vs exact PCA single pass {cos_first:.6f} (must miss the bar), "
        f"refined {cos:.6f} (bar {GATE_COS}); one sketch update {upd_ms:.3f} ms "
        f"({flop / upd_ms / 1e9:.1f} TFLOP/s IEEE f32) [{gpu}]")
    if not cos > GATE_COS:
        raise AssertionError(f"sketch tier on the card: min |cos| {cos} <= {GATE_COS}")
    if not cos_first < GATE_COS:
        raise AssertionError(f"single-pass sketch already at {cos_first}: the "
                             f"stream cannot show what the refine pass does")


def check_sketch_vs_cpu() -> None:
    """The same rank-2048 stream and Omega at D = 32768 through the sketch
    tier with refine on the card and on the CPU."""
    q, blocks = _decay_stream(GATE_CPU_D, seed=2)
    xs = [g @ q for g in blocks[:GATE_CPU_BLOCKS]]
    xs_cpu = [x.cpu() for x in xs]
    comp_gpu = _sketch_fit(lambda: iter(xs), "cuda")[1]
    comp_cpu = _sketch_fit(lambda: iter(xs_cpu), "cpu")[1]
    cos = _min_abs_cos(comp_gpu, comp_cpu)
    log(f"sketch tier card vs CPU at D={GATE_CPU_D}, {GATE_CPU_BLOCKS} blocks: "
        f"min |cos| {cos:.7f} (bar {GATE_CPU_COS})")
    if not cos > GATE_CPU_COS:
        raise AssertionError(f"sketch tier card vs CPU: min |cos| {cos}")


def check_vs_cpu(conv_npz: dict, gen_seed: int = 7) -> None:
    """One W through the full-width generator on the card and on the CPU,
    then a batch of Z to the ``convs.2`` tap, then the latent regression of
    the conv-tap run's components."""
    from types import SimpleNamespace
    from ganspace_tpu_torch.decomposition import linreg_lstsq
    from ganspace_tpu_torch.models.base import InstrumentedModel
    from ganspace_tpu_torch.models.stylegan2 import SG2Config, StyleGAN2, init_params
    params = init_params(SG2Config(), seed=0)
    gpu_model = StyleGAN2("ffhq", use_w=True, params=params, device="cuda")
    cpu_model = StyleGAN2("ffhq", use_w=True, params=params, device="cpu")
    w = gpu_model.sample_latent(1, seed=gen_seed)
    w_cpu = cpu_model.sample_latent(1, seed=gen_seed)
    w_err = float((w.cpu() - w_cpu).abs().max() / w_cpu.abs().max())
    img = gpu_model.forward(w).cpu()
    ref = cpu_model.forward(w.cpu())
    if not (torch.isfinite(img).all() and img.shape == (1, 3, 1024, 1024)):
        raise AssertionError(f"image shape {tuple(img.shape)} or non-finite")
    rel = float((2 * img - 2 * ref).abs().max() / (2 * ref - 1).abs().max())
    log(f"1024 px image, card vs CPU: W rel {w_err:.3e}, image rel {rel:.3e} "
        f"(bar {IMAGE_REL:.0e})")
    if not (w_err < 1e-4 and rel < IMAGE_REL):
        raise AssertionError("card and CPU disagree on the 1024 px image")

    z = cpu_model.sample_latent(CONV_BATCH, seed=gen_seed + 1)
    taps, insts = [], []
    for model in (gpu_model, cpu_model):
        model.use_z()
        inst = InstrumentedModel(model)
        inst.retain_layer("convs.2")
        model.partial_forward(z.to(model.device), "convs.2")
        taps.append(inst.retained_features()["convs.2"].cpu())
        insts.append(inst)
    tap_rel = float((taps[0] - taps[1]).abs().max() / taps[1].abs().max())
    log(f"convs.2 activation {tuple(taps[1].shape)}, card vs CPU: rel "
        f"{tap_rel:.3e} (bar {TAP_REL:.0e})")
    if not tap_rel < TAP_REL:
        raise AssertionError("card and CPU disagree on the convs.2 activation")

    # the regression sweep's least 10000 samples (n = 0), at the path's batch
    config = SimpleNamespace(batch_size=CONV_BATCH, layer="convs.2", n=0)
    comp = conv_npz["act_comp"].reshape(GATE_C, -1)
    mean, stdev = conv_npz["act_mean"].reshape(1, -1), conv_npz["act_stdev"]
    regs, secs = [], []
    for inst in insts:
        t0 = time.perf_counter()
        regs.append(linreg_lstsq(comp, mean, stdev, inst, config))
        secs.append(time.perf_counter() - t0)
    (zc_gpu, zm_gpu), (zc_cpu, zm_cpu) = regs
    cos = _min_abs_cos(torch.from_numpy(zc_gpu), torch.from_numpy(zc_cpu))
    mean_err = float(np.abs(zm_gpu - zm_cpu).max())
    log(f"linreg_lstsq of the conv-tap components ({10_000 // CONV_BATCH * CONV_BATCH} "
        f"samples, batch {CONV_BATCH}), card vs CPU: lat_comp min |cos| "
        f"{cos:.7f} (bar {REG_COS}), lat_mean max|d| {mean_err:.2e}; card "
        f"{secs[0]:.2f} s, CPU {secs[1]:.2f} s")
    if not (cos > REG_COS and mean_err < 1e-5):
        raise AssertionError("card and CPU disagree on the latent regression")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # fails outside a checkout: the package sits beside this script
    from ganspace_tpu_torch.ops.precision import ieee_f32

    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} [{gpu}], torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with ieee_f32():
        check_tile(gen)
        gram = check_centered_gram(gen)
        conv = check_modconv3x3(gen)
    from ganspace_tpu_torch.models import get_instrumented_model
    launches = {}
    t0 = time.perf_counter()
    launches["w_style_cli"], w_device = run_main_path(gpu)
    log(f"W path wall time: {time.perf_counter() - t0:.1f} s")
    # one model per latent space for the fit-only runs (the CLI's weights)
    w_inst = get_instrumented_model("StyleGAN2", "ffhq", "style", torch.device("cuda"),
                                    use_w=True)
    launches["w_fit_1m"] = run_w_fit_1m(gpu, w_inst)
    launches["w_fit_host"], launches["w_fit_host_seed7"] = check_w_stream_gate(
        gpu, w_inst, w_device)
    del w_inst
    t0 = time.perf_counter()
    launches["convs2_cli"], conv50 = run_conv_tap_path(gpu)
    log(f"conv-tap path wall time: {time.perf_counter() - t0:.1f} s")
    conv_inst = get_instrumented_model("StyleGAN2", "ffhq", "convs.2", torch.device("cuda"))
    with ieee_f32():
        check_fused_regression(gpu, conv_inst.model, conv50)
        check_upsample_determinism(gpu)
    runs = {"convs2_fit_device": run_conv_fit(gpu, conv_inst, device_rng=True),
            "convs2_fit_fused": run_conv_fit(gpu, conv_inst, device_rng=True, fused=True),
            "convs2_fit_host": run_conv_fit(gpu, conv_inst, device_rng=False),
            "convs2_fit_host_seed7": run_conv_fit(gpu, conv_inst, device_rng=False,
                                                  seed=7)}
    del conv_inst
    launches.update({path: run["launches"] for path, run in runs.items()})
    log(f"conv-tap fit at n = {CONV_N}: fused stream "
        f"{runs['convs2_fit_fused']['seconds']:.3f} s against the device pre-sampled "
        f"stream's {runs['convs2_fit_device']['seconds']:.3f} s [{gpu}]")
    report_conv_stream_gate(gpu, runs["convs2_fit_fused"], runs["convs2_fit_host"],
                            runs["convs2_fit_host_seed7"])
    conv_npz = runs["convs2_fit_host"]["arrays"]
    with ieee_f32():
        profile_conv_tap_blocks(gpu)
        check_sketch_gate(gpu)
        check_sketch_vs_cpu()
        check_vs_cpu(conv_npz)

    def counts(name):
        by_path = {path: n[name] for path, n in launches.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    kernels = [
        dict(name="centered_gram", route="cuda",
             source="ganspace_tpu_torch/csrc/centered_gram.cu",
             replaces="ganspace_tpu/ops/pallas/moments.py:58",
             **counts("centered_gram"), **gram),
        dict(name="modconv3x3", route="cuda",
             source="ganspace_tpu_torch/csrc/modconv3x3.cu",
             replaces="ganspace_tpu/ops/pallas/blockconv.py:178",
             **counts("modconv3x3"), **conv),
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
