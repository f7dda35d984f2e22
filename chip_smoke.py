#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``ganspace_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: require CUDA and print the card's name and power limit;
2. build: compile the CUDA kernels from ``ganspace_tpu_torch/csrc``;
3. the 3xTF32 tensor-core step of ``csrc/tf32x3.cuh`` on one 16x8x8 tile;
4. kernel A (centered Gram) against its plain PyTorch version, on the card,
   with a wide-range case and a determinism check, and at the paths' block
   shapes (4096, 5120, 37376 and 65536 rows of 512);
5. kernel B against its plain versions: the modulated 3x3 mode at the nine
   modulated 3x3 shapes of 1024-px StyleGAN2 synthesis at the render's
   batch of 5 (and at a batch of 2, for comparison with earlier runs), at
   the conv-tap path's two shapes (batch 128 at 4 and 8 px), plus a ragged
   and a wide-range case; the plain 3x3 mode at StyleGAN-1024's ten 3x3
   shapes (512 channels at 4 px to 16 at 1024 px), at the blocks.16x16
   fit's batch 128 and at the ``--video`` render's batches 16 and 6; the
   stride-2 mode at StyleGAN2's tap and render upsampling shapes and
   StyleGAN's fused ``conv0_up`` shapes at the render's and the video's
   batches, beside cuDNN's transposed convolution (default and
   deterministic), after its wgmma step alone on one 64 x N x 32 tile.  Every case repeats bit for bit.  The lists are built
   from the paths' own batches and configurations;
6. a full-width StyleGAN2-FFHQ-1024 checkpoint in the reference's rosinality
   format, written from a seeded init into a temporary
   ``$GANCONTROL_CHECKPOINT_DIR`` and built on the card through
   ``get_instrumented_model``: the loaded weights equal the file's, and its
   images equal bit for bit those of the same model built from the params
   in memory;
7. the W path in the default environment (device RNG, the fused W stream):
   ``visualize --model StyleGAN2 --class ffhq --use_w --layer style --est
   ipca -c 80 -n 40960`` on the full-width FFHQ-1024 generator (seeded
   random weights), with its launch counts, its cache and its grids checked;
8. the W fit alone at ``-n 1000000`` (15 blocks of 65536 and 4 of 4096);
9. the host-RNG W fit (``GANSPACE_DEVICE_RNG=0``) at ``-n 40960``, under
   seed 1 and seed 7: the statistical gate holds the device stream's
   components against the host stream's, judged by the host seed-1-vs-7
   control;
10. the conv-tap path in the default environment: ``visualize --model
   StyleGAN2 --class ffhq --layer convs.2 --est ipca -c 80 -n 50000`` in Z
   space (D = 512 * 16 * 16 = 131072; the fused activation stream of 390
   blocks of 128 with the sketch tier's refine pass, the regression's and
   the baselines' moments riding it; activation- and latent-mode grids),
   with its exact kernel-B launch counts, its phase times, its cache and
   its grids checked; then the fused-regression gate: the same 390 blocks
   regenerated, the explicit normal equations solved against the run's
   components, block 0 drawn again equal bit for bit;
11. the conv-tap fit alone at ``-n 20000``: the pre-sampled device stream
   with the regression sweep, the fused activation stream forced below its
   threshold (``GANSPACE_FUSED_ACTS=1``, timed against it) twice, its two
   caches equal bit for bit, then the host-RNG one under seed 1 and seed 7,
   with the fused stream's components beside the seed control (reported,
   not gated);
12. StyleGAN (v1), the CLI's default model, at full FFHQ-1024 width: the
   default command ``visualize --model StyleGAN --class ffhq --layer
   g_mapping --est ipca -c 80`` at the default n = 300000 (the fused
   activation stream into the moments tier; 24 grids through kernel B's
   plain and stride-2 modes); the host-RNG g_mapping fit under seeds 1 and
   7 and the statistical gate of the default command's device stream
   against it; the ``--use_w`` fit (the fused W stream); the conv tap
   ``g_synthesis.blocks.16x16`` at n = 50000 (the sketch tier); ``--video``
   on the real 256-px config (bedrooms) at -c 1, cut from 1024 px and 15
   components (~20k frames), through ffmpeg or, without it, GIF;
13. one fit block of the pre-sampled conv-tap path and 16 blocks of the
   fused activation stream under ``torch.profiler`` (device time by kernel,
   busy share of the wall time), then the sketch tier on the card against exact
   PCA: a rank-2048 stream at D = 131072 with a slowly decaying spectrum,
   whose exact sample PCA is a 2048-dimensional float64 problem; the
   single-pass sketch must miss the bar there and the refined one pass it;
14. the sketch tier on the card against the same stream and Omega on the
   CPU (D = 32768);
15. one 1024-px image, one batch of ``convs.2`` activations and the latent
   regression (``linreg_lstsq`` on the host-RNG conv-tap fit's components)
   through the card (kernels) against the same model on the CPU (plain
   versions); then one 1024-px StyleGAN image and one batch of
   ``blocks.16x16`` activations the same way;
16. every kernel shape launched over the run (recorded in front of the
   kernel library) that phase 5 did not cover, such as the fits' batch-1
   probes, held against its plain version by the same bars.

Every path reads the launch counts of the four kernel entries (kernel A;
kernel B's modulated, plain and stride-2 modes, one launch per call), set
to 0 just before it and read just after, and holds them to the counts its
shapes give.

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
N_CONV_LAUNCHES = 9 * 168              # 9 modulated 3x3 convs per strip, 168 strips
N_UP_LAUNCHES = 8 * 168                # 8 upsampling convs per strip
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
# kernel B's modulated mode per partial forward to convs.2 (conv1 at 4 px,
# convs.1 at 8 px) and per full forward (conv1 and convs.1, 3, ..., 15); its
# stride-2 mode, one launch per upsampling conv, per partial forward
# (convs.0 and convs.2) and per full forward (convs.0, 2, ..., 14)
B_PER_TAP_FORWARD, B_PER_FORWARD = 2, 9
UP_PER_TAP_FORWARD, UP_PER_FORWARD = 2, 8
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
W_BATCH = 4096            # decomposition.W_BATCH: the host streams' and remainders' blocks


def w_stream_nb(n: int) -> int:
    """The fused W stream's block at ``n`` (decomposition._compute):
    min(65536, max(4096, n_total // 8)), n_total rounded down to 4096."""
    return min(65536, max(W_BATCH, n // W_BATCH * W_BATCH // 8))


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
# StyleGAN (v1) at full FFHQ-1024 width (SG1Config(): 8 x 512 mapping,
# 4 -> 1024 px at 512, 512, 512, 512, 256, 128, 64, 32, 16 channels), the
# CLI's default command: g_mapping in Z at the default n = 300000, on the
# fused activation stream (batch 4096: 73 blocks) feeding the moments tier
SG1_N, SG1_BATCH = 300_000, 4096
SG1_ARGS = ["--model", "StyleGAN", "--class", "ffhq", "--layer", "g_mapping", "--est",
            "ipca", "-c", "80"]
SG1_BLOCKS = -(-(SG1_N // SG1_BATCH * SG1_BATCH) // SG1_BATCH)         # 73
# the --use_w fit: the fused W stream, 8 blocks of 37376
SG1_W_BLOCKS = (SG1_N // W_BATCH * W_BATCH) // w_stream_nb(SG1_N)
# kernel A's blocks on the paths, the block mean given: the fused W streams
# (n = 40960, 1M and StyleGAN's --use_w at 300000) and 4096 (the host
# streams, the remainders, StyleGAN's g_mapping activation stream)
GRAM_STREAM_SHAPES = sorted({(w_stream_nb(n), 512) for n in (W_N, W_N_1M, SG1_N)}
                            | {(W_BATCH, 512)})
# a conv tap through the sketch tier: blocks.16x16, D = 512 * 16 * 16
SG1_TAP, SG1_TAP_N, SG1_TAP_BATCH = "g_synthesis.blocks.16x16", 50_000, 128
SG1_TAP_BLOCKS = SG1_TAP_N // SG1_TAP_BATCH                           # 390
# kernel B per forward: plain 3x3 (4 px conv, conv0_up below 128 px, every
# conv1) and stride-2 launches (conv0_up from 128 px)
SG1_RES = (4, 8, 16, 32, 64, 128, 256, 512, 1024)
SG1_FUSED_MIN_RES = 128                 # models/stylegan.FUSED_MIN_RES


def sg1_channels(res: int) -> list:
    """Channels of each resolution of a StyleGAN at ``res`` px (SG1Config's
    fmap_base 8192, fmap_max 512: 512 to 32 px, then halving)."""
    return [min(8192 // r * 2, 512) for r in SG1_RES if r <= res]


def sg1_shapes(res: int, batch: int, upto: int | None = None) -> tuple[list, list]:
    """Kernel B's calls in one StyleGAN forward at ``res`` px and ``batch``,
    through the block at ``upto`` px (a partial forward) or all of them:
    the plain mode's (B, C, Co, H, W) and the stride-2 mode's (B, C, Co, H,
    W, k, pad, modulated), each distinct shape once."""
    ch = sg1_channels(res)
    plain, up = [(batch, ch[0], ch[0], 4, 4)], []
    for i, r in enumerate(SG1_RES[1:len(ch)], start=1):
        if upto is not None and r > upto:
            break
        if r >= SG1_FUSED_MIN_RES:
            up.append((batch, ch[i - 1], ch[i], r // 2, r // 2, 4, 1, False))
        else:
            plain.append((batch, ch[i - 1], ch[i], r, r))
        plain.append((batch, ch[i], ch[i], r, r))
    return list(dict.fromkeys(plain)), up


def sg1_counts(res: int) -> tuple[int, int]:
    """(plain 3x3, stride-2) launches of one full forward at ``res`` px."""
    ups = [r for r in SG1_RES[1:] if r <= res]
    return (1 + sum(r < SG1_FUSED_MIN_RES for r in ups) + len(ups),
            sum(r >= SG1_FUSED_MIN_RES for r in ups))


SG1_TAP_PLAIN = 5              # 4x4.conv, 8x8.conv0_up, conv1, 16x16.conv0_up, conv1
SG1_STRIPS = 2 * 12 * 14       # activation and latent mode, 12 grids of 14 rows
# --video on the real 256-px config (bedrooms) at -c 1: 2 edit modes x 2
# sigmas x (1 component + 10 samples x 1 component) sweeps of 150 frames,
# rendered 16 frames per forward (apps/visualize.RENDER_MAX_BATCH), the last
# of a sweep 6, and 24 grids of one 5-frame strip
VIDEO_ARGS = ["--model", "StyleGAN", "--class", "bedrooms", "--layer", "g_mapping",
              "--est", "ipca", "-c", "1", "--video"]
VIDEO_RES, VIDEO_FRAMES, VIDEO_BATCH = 256, 150, 16
VIDEO_SWEEPS, VIDEO_FORWARDS = 44, 44 * -(-VIDEO_FRAMES // VIDEO_BATCH) + 24
VIDEO_BATCHES = sorted({VIDEO_BATCH, VIDEO_FRAMES % VIDEO_BATCH or VIDEO_BATCH})
# kernel B's plain mode (B, C, Co, H, W), by path: StyleGAN-1024's ten 3x3
# shapes at the render's batch (the default command, from 512 channels at
# 4 px to 16 at 1024 px), the blocks.16x16 fit's batch-128 tap forward and
# the --video render's batches at 256 px
PLAIN_CASES = sg1_shapes(1024, RENDER_BATCH)[0]
PLAIN_PATH_CASES = {
    "sg1_tap": sg1_shapes(1024, SG1_TAP_BATCH, upto=16)[0],
    "sg1_video": [c for b in VIDEO_BATCHES for c in sg1_shapes(VIDEO_RES, b)[0]],
}
# the stride-2 mode (B, C, Co, H, W, k, pad, modulated): StyleGAN2's tap
# forward (4 -> 9 and 8 -> 17 px at the path's batch), its render (every
# upsampling StyledConv at B = 5), StyleGAN's fused conv0_up (4x4, pad 1) at
# the render's batch and at the --video render's
UP_CASES = {
    "sg2_tap": [(CONV_BATCH, 512, 512, r, r, 3, 0, True) for r in (4, 8)],
    "sg2_render": [(RENDER_BATCH, c, co, r, r, 3, 0, True) for c, co, r in [
        (512, 512, 4), (512, 512, 8), (512, 512, 16), (512, 512, 32), (512, 256, 64),
        (256, 128, 128), (128, 64, 256), (64, 32, 512)]],
    "sg1_fused": sg1_shapes(1024, RENDER_BATCH)[1],
    "sg1_video": [c for b in VIDEO_BATCHES for c in sg1_shapes(VIDEO_RES, b)[1]],
}
# wide-range cases: X = 1e3 randn + 1e2 for A, s spanning 1e-2..1e2 for B
GRAM_WIDE = (4096, 512)
CONV_WIDE = [(RENDER_BATCH, 512, 512, 8, 8), (RENDER_BATCH, 512, 512, 64, 64)]
# 3xTF32 tensor-core sums against cuDNN's / cuBLAS's IEEE float32 sums: as
# accurate, in another order (tests/test_torch_port_tf32x3.py).
GRAM_ABS, GRAM_REL = 1e-4, 1e-5         # max|d| <= 1e-5 max|ref| + 1e-4
CONV_REL = 1e-5                         # max|d| / max|ref|
TILE_REL = 1e-6                         # one 16x8x8 step against float64
IMAGE_REL = 1e-3                        # 1024 px, 18 layers deep (fullres bar)
# the checkpoint phase: a seed other than the default init's, a small batch
CKPT_SEED, CKPT_BATCH = 5, 4
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


def check_wgmma_tile(gen: torch.Generator) -> None:
    """The stride-2 kernel's 3xTF32 wgmma step alone: A's register
    fragments, B's swizzled image and descriptor, the accumulator layout."""
    from ganspace_tpu_torch.ops.tf32x3 import wgmma_tile_3xtf32
    for n in (144, 128):
        a = torch.randn(64, 32, generator=gen, device="cuda")
        b = torch.randn(n, 32, generator=gen, device="cuda")
        got = wgmma_tile_3xtf32(a, b).double()
        ref = a.double() @ b.double().T
        rel = float((got - ref).abs().max() / ref.abs().max())
        log(f"wgmma 3xTF32 tile 64x{n}x32 against float64: rel {rel:.3e} (bar {TILE_REL:.0e})")
        if not rel < TILE_REL:
            raise AssertionError(f"wgmma tile n={n}: rel err {rel} >= {TILE_REL}")


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
    # the paths' blocks (the fused W streams' and 4096); the wrapper
    # launches the kernel at every shape (no plain fallback on the card)
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
        log(f"centered_gram N={n} D={d} (a path's block, its mean given): max|d|={err:.3e} "
            f"(bar {bar:.3e})")
        if not err <= bar:
            raise AssertionError(f"centered_gram {n}x{d}: max|d| {err} > {bar}")
        if not torch.equal(got, centered_gram(x, x.mean(dim=0))):
            raise AssertionError(f"centered_gram {n}x{d}: two launches differ")
        shapes[f"{n}x{d}"] = gram_timing(x, err)
        CHECKED.add(("centered_gram", n, d))
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
        raise AssertionError(f"kernel B {case}{what}: rel err {rel} >= {CONV_REL}")
    return err, rel


def conv_bound(case, scaled: bool = True) -> dict:
    b, c, co, h, w = case
    sd = (b * c + b * co) if scaled else 0
    return bound(2.0 * b * h * w * co * 9 * c,
                 4.0 * (b * c * h * w + co * c * 9 + sd + b * co * h * w))


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
    rows = {"render": [], "tap": []}
    for case in CONV_CASES + [CONV_RAGGED] + CONV_TAP_CASES:
        x, wt, s, d = conv_inputs(gen, case)
        got = modconv3x3(x, wt, s, d)
        ref = modconv3x3_plain(x, wt, s, d)
        torch.cuda.synchronize()
        err, rel = conv_err(got, ref, case, "")
        if not torch.equal(got, modconv3x3(x, wt, s, d)):
            raise AssertionError(f"modconv3x3 {case}: two launches differ")
        CHECKED.add(("modconv3x3", *case, True))
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        b, c, co, h, w = case
        line = (f"modconv3x3 B={b} C={c} Co={co} {h}x{w}"
                f"{' (conv-tap path)' if case in CONV_TAP_CASES else ''}: rel={rel:.3e} "
                f"(bar {CONV_REL:.0e}), repeat bit-identical")
        if case != CONV_RAGGED:
            row, times = conv_row(case, x, wt, s, d)
            rows["tap" if case in CONV_TAP_CASES else "render"].append(row)
            line += times
        log(line)
        del x, got, ref
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
    total, tap = sum_rows(rows["render"]), sum_rows(rows["tap"])
    log(f"modconv3x3, the nine synthesis shapes at B={RENDER_BATCH}: kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, cuDNN "
        f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms (FFMA "
        f"{total['bound_ffma_ms']:.4f} ms), share {total['bound_share']:.3f}")
    log(f"modconv3x3, the two conv-tap shapes at B={CONV_BATCH}: kernel "
        f"{tap['ms']:.4f} ms, plain {tap['plain_ms']:.4f} ms, cuDNN "
        f"{tap['library_ms']:.4f} ms, bound {tap['bound_ms']:.4f} ms, share "
        f"{tap['bound_share']:.3f}")
    return {"max_abs_err": worst, "max_rel_err": worst_rel, **total, "conv_tap_shapes": tap}


def sum_rows(rows: list) -> dict:
    """Times and bounds summed over shapes, bound by what bounds most of it."""
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms",
                                                   "bound_ms", "bound_ffma_ms")}
    flop_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    total["bound_by"] = "operations" if 2 * flop_ms >= total["bound_ms"] else "bytes"
    total["bound_share"] = total["bound_ms"] / total["ms"]
    if all("library_det_ms" in r for r in rows):
        total["library_det_ms"] = sum(r["library_det_ms"] for r in rows)
    return total


def check_conv3x3(gen: torch.Generator) -> dict:
    """Kernel B's plain mode (no scale, no demodulation: the TPU kernel's own
    function) at StyleGAN-1024's ten 3x3 shapes at the render's batch, at
    the other paths' batches (``PLAIN_PATH_CASES``), and at two ragged
    shapes (Co <= 16 takes the 16-channel tile)."""
    import torch.nn.functional as F
    from ganspace_tpu_torch.ops.modconv import conv3x3, conv3x3_plain
    groups = {"render": PLAIN_CASES, **PLAIN_PATH_CASES,
              "ragged": [(3, 20, 16, 9, 13), (2, 16, 7, 5, 5)]}
    out, worst = {}, 0.0
    for group, cases in groups.items():
        rows = []
        for case in cases:
            b, c, co, h, w = case
            x = torch.randn(b, c, h, w, generator=gen, device="cuda")
            wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
            got = conv3x3(x, wt)
            err, rel = conv_err(got, conv3x3_plain(x, wt), case, " plain mode")
            if not torch.equal(got, conv3x3(x, wt)):
                raise AssertionError(f"conv3x3 {case}: two launches differ")
            CHECKED.add(("conv3x3", *case, False))
            worst = max(worst, err)
            line = (f"conv3x3 (plain mode, {group}) B={b} C={c} Co={co} {h}x{w}: "
                    f"rel={rel:.3e}, repeat bit-identical")
            if group != "ragged":
                row = timed(median_ms(lambda: conv3x3(x, wt)),
                            median_ms(lambda: conv3x3_plain(x, wt)),
                            median_ms(lambda: F.conv2d(x, wt, padding=1)),
                            conv_bound(case, scaled=False))
                rows.append(row)
                line += (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                         f"cuDNN {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']}), share {row['bound_share']:.3f}")
            log(line)
            del x, got
        if rows:
            out[group] = t = sum_rows(rows)
            log(f"conv3x3 (plain mode), {group} ({len(rows)} shapes): kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, cuDNN "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), share {t['bound_share']:.3f}")
    # the JSON row: StyleGAN-1024's ten shapes at the render's batch
    return {"max_abs_err": worst, **out["render"], "groups": out}


def up_flop(case) -> float:
    """2 * C * Co per (input pixel, tap) whose output lands in the image: the
    work the inputs need (the taps that cross the crop of padding 1 are not
    counted, nor any zero-inserted or zero-padded input)."""
    b, c, co, h, w, k, pad, _ = case
    def axis(n):
        size = 2 * n + k - 2 - 2 * pad
        return sum(0 <= 2 * i + u - pad < size for i in range(n) for u in range(k))
    return 2.0 * b * c * co * axis(h) * axis(w)


def up_inputs(gen: torch.Generator, case):
    """(x, w, s, d) of a stride-2 case; s and d None unless modulated."""
    from ganspace_tpu_torch.ops.modconv import demodulation
    b, c, co, h, w, k, pad, modulated = case
    x = torch.randn(b, c, h, w, generator=gen, device="cuda")
    wt = torch.randn(co, c, k, k, generator=gen, device="cuda") / (k * k * c) ** 0.5
    if not modulated:
        return x, wt, None, None
    s = 1.0 + 0.5 * torch.randn(b, c, generator=gen, device="cuda")
    return x, wt, s, demodulation(wt, s)


def check_upsample_conv(gen: torch.Generator) -> dict:
    """Kernel B's stride-2 mode against its plain version (the transposed
    conv on the scaled input) at every upsampling shape of the paths, each
    repeated bit for bit; beside it cuDNN's transposed conv, its default
    algorithm and its deterministic one (the price of repeatable bits
    without this kernel).  The kernel is timed with its split weight kept,
    as a layer keeps it (``UpsampleWeights``)."""
    import torch.nn.functional as F
    from ganspace_tpu_torch.ops.modconv import (
        UpsampleWeights, upsample_conv, upsample_conv_plain)
    out, worst = {}, 0.0
    for group, cases in UP_CASES.items():
        rows = []
        for case in cases:
            b, c, co, h, w, k, pad, modulated = case
            x, wt, s, d = up_inputs(gen, case)
            got = upsample_conv(x, wt, s, d, pad=pad)
            err, rel = conv_err(got, upsample_conv_plain(x, wt, s, d, pad=pad), case,
                                " stride-2 mode")
            if not all(torch.equal(got, upsample_conv(x, wt, s, d, pad=pad)) for _ in range(3)):
                raise AssertionError(f"upsample_conv {case}: repeats differ")
            CHECKED.add(("upsample_conv", *case[:7], modulated, modulated))
            worst = max(worst, err)
            xs = x if s is None else x * s[:, :, None, None]
            wt_t = wt.transpose(0, 1)

            def cudnn():
                return F.conv_transpose2d(xs, wt_t, stride=2, padding=pad)
            ho = 2 * h + k - 2 - 2 * pad
            nbytes = 4.0 * (b * c * h * w + co * c * k * k + b * co * ho * ho
                            + ((b * c + b * co) if modulated else 0))
            cache = UpsampleWeights(wt)     # as a layer keeps its split weight
            row = timed(median_ms(lambda: upsample_conv(x, wt, s, d, pad=pad, cache=cache)),
                        median_ms(lambda: upsample_conv_plain(x, wt, s, d, pad=pad)),
                        median_ms(cudnn), bound(up_flop(case), nbytes))
            old = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                row["library_det_ms"] = median_ms(cudnn)
            finally:
                torch.backends.cudnn.deterministic = old
            rows.append(row)
            log(f"upsample_conv ({group}) B={b} C={c} Co={co} {h}->{ho} px k={k}"
                f"{' s, d' if modulated else ''}: rel={rel:.3e} (bar {CONV_REL:.0e}), "
                f"3 repeats bit-identical; kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, cuDNN {row['library_ms']:.4f} ms, cuDNN "
                f"deterministic {row['library_det_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']}), share {row['bound_share']:.3f}")
            del x, got
        out[group] = sum_rows(rows)
        t = out[group]
        log(f"upsample_conv, {group} ({len(rows)} shapes): kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, cuDNN {t['library_ms']:.4f} ms, cuDNN deterministic "
            f"{t['library_det_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"share {t['bound_share']:.3f}")
    # the JSON row: the conv-tap path's shapes, where the mode spends most
    return {"max_abs_err": worst, **out["sg2_tap"], "groups": out}


def conv_tap_launches(refined: bool, fused_blocks: int, cli: bool,
                      per_tap: int = B_PER_TAP_FORWARD, per_full: int = B_PER_FORWARD) -> int:
    """Kernel-B launches (``per_tap`` per tap forward, ``per_full`` per full
    forward) of a StyleGAN2 conv-tap run: the shape annotation (a CLI run
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
    return per_tap * tap_forwards + 2 * per_full * strips


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


# The launch shapes held against the plain versions so far: (kernel entry,
# *shape, ...) as LaunchRecorder keys them.
CHECKED: set = set()


class LaunchRecorder:
    """Stands in for the loaded kernel library (``ops/_build``): passes
    every call through and keys each launch by its kernel and shape, so that
    every shape a path launched is held against its plain version
    (:func:`check_launched_shapes`), whichever path a later change adds."""

    def __init__(self, lib):
        self.lib = lib
        self.seen: set = set()

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def ganspace_centered_gram(self, x, mu, g, n, d, stream):
        self.seen.add(("centered_gram", n, d))
        return self.lib.ganspace_centered_gram(x, mu, g, n, d, stream)

    def ganspace_modconv3x3(self, x, wt, s, dmod, y, b, c, h, w, co, stream):
        self.seen.add(("modconv3x3" if s else "conv3x3", b, c, co, h, w, dmod is not None))
        return self.lib.ganspace_modconv3x3(x, wt, s, dmod, y, b, c, h, w, co, stream)

    def ganspace_upsample_conv(self, x, wimg, s, dmod, y, tiling, b, c, h, w, co, k, pad,
                               stream):
        self.seen.add(("upsample_conv", b, c, co, h, w, k, pad, s is not None,
                       dmod is not None))
        return self.lib.ganspace_upsample_conv(x, wimg, s, dmod, y, tiling, b, c, h, w, co, k,
                                               pad, stream)


def record_launches() -> LaunchRecorder:
    """Put a LaunchRecorder in front of the loaded library."""
    from ganspace_tpu_torch.ops import _build
    recorder = LaunchRecorder(_build.load_kernels())
    _build._loaded = recorder
    return recorder


def check_launched_shapes(recorder: LaunchRecorder, gen: torch.Generator) -> None:
    """Every shape the paths launched that the kernel checks did not cover
    (the fits' batch-1 probes, the vs-CPU forwards, ...), held against its
    plain version by the same bars, two launches bit-identical."""
    from ganspace_tpu_torch.ops.modconv import (
        conv3x3, conv3x3_plain, modconv3x3, modconv3x3_plain, upsample_conv,
        upsample_conv_plain)
    from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
    left = sorted(recorder.seen - CHECKED, key=str)
    for key in left:
        kind, *shape = key
        if kind == "centered_gram":
            x = torch.randn(*shape, generator=gen, device="cuda") * 2.0 + 0.5
            mu = x.mean(dim=0)
            got, ref = centered_gram(x, mu), centered_gram_plain(x, mu)
            if not float((got - ref).abs().max()) <= gram_bar(ref):
                raise AssertionError(f"centered_gram {shape}: above the bar")
            again = centered_gram(x, mu)
        elif kind == "upsample_conv":
            case = (*shape[:7], shape[7])
            if shape[7] != shape[8]:
                raise AssertionError(f"upsample_conv {shape}: s without d or d without s")
            x, wt, s, d = up_inputs(gen, case)
            pad = case[6]
            got = upsample_conv(x, wt, s, d, pad=pad)
            conv_err(got, upsample_conv_plain(x, wt, s, d, pad=pad), case, " stride-2 mode")
            again = upsample_conv(x, wt, s, d, pad=pad)
        else:
            x, wt, s, d = conv_inputs(gen, tuple(shape[:5]))
            d = d if shape[5] else None
            if kind == "conv3x3":
                got = conv3x3(x, wt)
                conv_err(got, conv3x3_plain(x, wt), shape, " plain mode")
                again = conv3x3(x, wt)
            else:
                got = modconv3x3(x, wt, s, d)
                conv_err(got, modconv3x3_plain(x, wt, s, d), shape, "")
                again = modconv3x3(x, wt, s, d)
        if not torch.equal(got, again):
            raise AssertionError(f"{key}: two launches differ")
        CHECKED.add(key)
    log(f"launched shapes: {len(recorder.seen)} distinct over the run, all held against "
        f"their plain versions; {len(left)} of them here, beyond the kernel checks: "
        + "; ".join(f"{k[0]} {k[1:]}" for k in left))


def _wrappers() -> dict:
    from ganspace_tpu_torch.ops.modconv import conv3x3, modconv3x3, upsample_conv
    from ganspace_tpu_torch.ops.moments import centered_gram
    return {"centered_gram": centered_gram, "modconv3x3": modconv3x3,
            "conv3x3": conv3x3, "upsample_conv": upsample_conv}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def expect_launches(launches: dict, what: str, **want) -> None:
    """Exact counts for the named kernels, none for the others."""
    want = {name: want.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {want}")


def load_cache(path, c: int = 80) -> tuple[dict, dict]:
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
    comp = arrays["act_comp"].reshape(c, -1)
    gram_err = float(np.abs(comp @ comp.T - np.eye(c)).max())
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
    config = Config(model=inst.model.model_name, output_class=inst.model.outclass, layer=layer,
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
        # one kernel-A launch per fused W block; per strip (one forward) 9
        # modulated 3x3 convs and 8 upsampling convs
        expect_launches(launches, "W path", centered_gram=N_W_STREAM_BLOCKS,
                        modconv3x3=N_CONV_LAUNCHES, upsample_conv=N_UP_LAUNCHES)
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
    expect_launches(run["launches"], "W fit at 1M", centered_gram=N_W_1M_BLOCKS)
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


def check_gate(gpu: str, what: str, n: int, device: dict, host: dict, ctrl: dict) -> None:
    """The device stream's components (``device``) against the host
    stream's (``host``), judged by the host seed-1-vs-7 control (``ctrl``):
    each ratio under its bar in GATE_RATIOS."""
    cuts, err, ctrl_err, ratios = stream_gate((host, device), (host, ctrl),
                                              host["act_stdev"])
    log(f"{what} gate (n = {n}, c = 80, {len(cuts)} cuts at a relative gap "
        f">= {GATE_GAP}: {cuts}): device vs host "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + "; host seed 1 vs 7 " + ", ".join(f"{k} {v:.3e}" for k, v in ctrl_err.items())
        + "; ratios " + ", ".join(f"{k} {v:.3f} (bar {GATE_RATIOS[k]})"
                                  for k, v in ratios.items()) + f" [{gpu}]")
    bad = [k for k, v in ratios.items() if not v <= GATE_RATIOS[k]]
    if bad:
        raise AssertionError(f"{what}: the device stream misses the control's bar on {bad}")


def check_w_stream_gate(gpu: str, inst, device_arrays: dict) -> tuple[dict, dict]:
    """The host-RNG W fit (seed 1, the earlier path) and its seed-7 control,
    then the device stream's components against the host stream's."""
    runs = {}
    for seed in (0, 7):
        run = fit_only(inst, "style", W_N, seed=seed, GANSPACE_DEVICE_RNG=0)
        expect_launches(run["launches"], "host W fit", centered_gram=N_FIT_BLOCKS)
        expect_meta(run["meta"], "host W fit", device_rng=False)
        log(f"host-RNG W fit, seed {seed or 1}: {run['seconds']:.3f} s, "
            f"{W_N / run['seconds']:.1f} samples/s; launches {run['launches']}; "
            f"phases: {fmt_phases(run['phases'])} [{gpu}]")
        runs[seed] = run
    check_gate(gpu, "W stream", W_N, device_arrays, runs[0]["arrays"], runs[7]["arrays"])
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
        shape = dict(refined=not meta["refine_skipped"], fused_blocks=CONV50_BLOCKS,
                     cli=True)
        expect_launches(launches, "conv-tap path", modconv3x3=conv_tap_launches(**shape),
                        upsample_conv=conv_tap_launches(**shape, per_tap=UP_PER_TAP_FORWARD,
                                                        per_full=UP_PER_FORWARD))
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
    its latents (the per-block generator) and its activations bit for bit:
    every kernel of the tap forward, the upsampling included, sums in a
    fixed order."""
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
    acts_same = torch.equal(again[0], first[0])
    exact = torch.linalg.solve(g, r).cpu().numpy()
    cos = _min_abs_cos(torch.from_numpy(arrays["lat_comp"].reshape(80, -1)),
                       torch.from_numpy(exact))
    log(f"fused regression vs the explicit solve over the same {CONV50_BLOCKS} "
        f"regenerated blocks: lat_comp min |cos| {cos:.7f} (bar {FUSED_REG_COS}); "
        f"block 0 regenerated: latents bit for bit {same}, activations bit for bit "
        f"{acts_same}; {seconds:.2f} s [{gpu}]")
    if not (cos > FUSED_REG_COS and same and acts_same):
        raise AssertionError("the fused regression or the block regeneration failed")


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
    shape = dict(refined=not meta["refine_skipped"],
                 fused_blocks=CONV20_FUSED_BLOCKS if fused else 0, cli=False)
    expect_launches(run["launches"], what, modconv3x3=conv_tap_launches(**shape),
                    upsample_conv=conv_tap_launches(**shape, per_tap=UP_PER_TAP_FORWARD,
                                                    per_full=UP_PER_FORWARD))
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


def check_fused_fit_repeats(first: dict, again: dict) -> None:
    """The fused conv-tap fit at n = 20000 twice: every array of the two
    caches equal bit for bit (every kernel of the tap forward sums in a
    fixed order)."""
    same = {k: np.array_equal(first["arrays"][k], again["arrays"][k])
            for k in NPZ_KEYS - {"_meta"}}
    log(f"fused conv-tap fit at n = {CONV_N}, run twice: caches bit for bit "
        f"{all(same.values())} ({', '.join(k for k, v in sorted(same.items()) if v)})")
    if not all(same.values()):
        raise AssertionError(f"the two fused fits differ in "
                             f"{sorted(k for k, v in same.items() if not v)}")


def run_sg1_default(gpu: str) -> tuple[dict, dict]:
    """StyleGAN's default command at full FFHQ-1024 width and the default
    n = 300000: ``visualize --model StyleGAN --class ffhq --layer g_mapping
    --est ipca -c 80``, in Z on the fused activation stream (the mapping per
    block, kernel A per block into the moments tier, the regression and the
    random moments riding it); then 24 grids of 14 strips in activation
    ("W") and latent ("Z") mode through kernel B's plain and stride-2 modes."""
    from ganspace_tpu_torch.apps import visualize
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        reset_launches()
        result = visualize.main(list(SG1_ARGS))
        launches = read_launches()
        log(f"StyleGAN default command launches: {launches}")
        plain, up = sg1_counts(1024)
        expect_launches(launches, "StyleGAN default command", centered_gram=SG1_BLOCKS,
                        conv3x3=plain * SG1_STRIPS, upsample_conv=up * SG1_STRIPS)
        arrays, meta = load_cache(result.cache)
        if arrays["act_comp"].reshape(80, -1).shape != (80, 512):
            raise AssertionError(f"act_comp shape {arrays['act_comp'].shape}")
        if not (np.diff(arrays["var_ratio"]) <= 1e-7).all():
            raise AssertionError("var_ratio is not descending")
        expect_meta(meta, "StyleGAN default command", device_rng=True, fused_linreg=True)
        for k in ("act_stdev", "var_ratio", "lat_stdev", "random_stdevs"):
            if arrays[k].shape != (80,) or not (arrays[k] > 0).all():
                raise AssertionError(f"{k}: not 80 positive values")
        summ = Path(out, "out", "StyleGAN-ffhq", "g_mapping", "ipca", "summ")
        grids = sorted(p.name for p in summ.glob("*.jpg"))
        names = ["components", "random_dirs"] + [f"samp{i}_real" for i in range(10)]
        if grids != sorted(f"{n}_{m}.jpg" for n in names for m in ("W", "Z")):
            raise AssertionError(f"summ grids {grids}")
        if not (summ / "+lightbox.html").is_file():
            raise AssertionError("no lightbox page in summ")
        log(f"StyleGAN npz ok: keys, finite, |C C^T - I| = {arrays['gram_err']:.2e}, "
            f"_meta device_rng and fused_linreg true, four baseline rows; "
            f"{len(grids)} grids and the lightbox page")
    log(f"StyleGAN default command fit (n = {SG1_N}): {result.fit_seconds:.3f} s, "
        f"{SG1_N / result.fit_seconds:.1f} samples/s; phases: "
        f"{fmt_phases(result.phases)} [{gpu}]")
    log(f"StyleGAN render: {result.images} images at 1024 px in "
        f"{result.render_seconds:.3f} s, {result.images / result.render_seconds:.2f} "
        f"images/s [{gpu}]")
    return launches, arrays


def check_sg1_stream_gate(gpu: str, inst, device_arrays: dict) -> dict:
    """The host-RNG g_mapping fit in Z under seed 1 and seed 7 at the default
    n, then the default command's device stream against the host stream,
    judged by the host seed-1-vs-7 control (the W stream's gate): the
    host runs."""
    runs = {}
    for seed in (0, 7):
        run = fit_only(inst, "g_mapping", SG1_N, seed=seed, GANSPACE_DEVICE_RNG=0)
        expect_launches(run["launches"], "StyleGAN host g_mapping fit",
                        centered_gram=SG1_BLOCKS)
        expect_meta(run["meta"], "StyleGAN host g_mapping fit", device_rng=False)
        log(f"StyleGAN host-RNG g_mapping fit, seed {seed or 1}: {run['seconds']:.3f} s, "
            f"{SG1_N / run['seconds']:.1f} samples/s; phases: {fmt_phases(run['phases'])} "
            f"[{gpu}]")
        runs[seed] = run
    check_gate(gpu, "StyleGAN g_mapping stream", SG1_N, device_arrays, runs[0]["arrays"],
               runs[7]["arrays"])
    return runs


def run_sg1_w_fit(gpu: str, inst, host_runs: dict) -> dict:
    """``--use_w`` at g_mapping: the fused W stream at the default n.  Its
    samples are the mapping's outputs, as the g_mapping activations of the
    host Z fits are, so its components are gated against theirs."""
    run = fit_only(inst, "g_mapping", SG1_N)
    expect_launches(run["launches"], "StyleGAN --use_w fit", centered_gram=SG1_W_BLOCKS)
    expect_meta(run["meta"], "StyleGAN --use_w fit", device_rng=True)
    log(f"StyleGAN --use_w g_mapping fit at n = {SG1_N}: {run['seconds']:.3f} s, "
        f"{SG1_N / run['seconds']:.1f} samples/s; launches {run['launches']}; phases: "
        f"{fmt_phases(run['phases'])} [{gpu}]")
    check_gate(gpu, "StyleGAN --use_w W stream", SG1_N, run["arrays"],
               host_runs[0]["arrays"], host_runs[7]["arrays"])
    return run["launches"]


def run_sg1_tap_fit(gpu: str, inst) -> dict:
    """The conv tap ``g_synthesis.blocks.16x16`` (D = 131072) at n = 50000:
    the fused activation stream (390 blocks of 128, the regression riding
    it) into the sketch tier, with its refine pass when the policy keeps it."""
    run = fit_only(inst, SG1_TAP, SG1_TAP_N)
    meta = run["meta"]
    expect_meta(meta, "StyleGAN blocks.16x16 fit", device_rng=True, fused_linreg=True)
    forwards = 1 + SG1_TAP_BLOCKS * (1 + (not meta["refine_skipped"]))
    expect_launches(run["launches"], "StyleGAN blocks.16x16 fit",
                    conv3x3=SG1_TAP_PLAIN * forwards)
    if run["arrays"]["act_comp"].shape != (80, 1, 512, 16, 16):
        raise AssertionError(f"act_comp shape {run['arrays']['act_comp'].shape}")
    log(f"StyleGAN {SG1_TAP} fit at n = {SG1_TAP_N}: {run['seconds']:.3f} s, "
        f"{SG1_TAP_N / run['seconds']:.1f} samples/s; launches {run['launches']}; "
        f"refine_skipped {meta['refine_skipped']}; phases: {fmt_phases(run['phases'])} "
        f"[{gpu}]")
    return run["launches"]


def run_sg1_video(gpu: str) -> dict:
    """``--video`` on the real 256-px config (bedrooms) at -c 1: 44 sweeps
    of 150 frames out and back, through ffmpeg when it is on PATH, else
    GIF.  (1024 px with 15 components would be ~20k frames: cut.)"""
    import shutil
    from ganspace_tpu_torch.apps import visualize
    writer = "ffmpeg (MP4)" if shutil.which("ffmpeg") else "PIL (GIF; no ffmpeg on PATH)"
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):       # one line per GIF
            result = visualize.main(list(VIDEO_ARGS))
        wall = time.perf_counter() - t0
        launches = read_launches()
        plain, up = sg1_counts(256)
        expect_launches(launches, "--video", centered_gram=SG1_BLOCKS,
                        conv3x3=plain * VIDEO_FORWARDS, upsample_conv=up * VIDEO_FORWARDS)
        load_cache(result.cache, c=1)
        root = Path(out, "out", "StyleGAN-bedrooms", "g_mapping", "ipca")
        videos = sorted(p for d in ("comp", "inst") for p in (root / d).iterdir()
                        if p.suffix in (".mp4", ".gif"))
        if len(videos) != VIDEO_SWEEPS or len(result.videos) != VIDEO_SWEEPS:
            raise AssertionError(f"{len(videos)} videos written, expected {VIDEO_SWEEPS}")
        if any(p.stat().st_size == 0 for p in videos):
            raise AssertionError("an empty video file")
        frames = check_sweep_frames(videos[0])
        pages = [d for d in ("comp", "inst", "summ") if (root / d / "+lightbox.html").is_file()]
        if pages != ["comp", "inst", "summ"]:
            raise AssertionError(f"lightbox pages in {pages}")
        mbytes = sum(p.stat().st_size for p in videos) / 2 ** 20
    log(f"--video (StyleGAN bedrooms, 256 px, -c 1): {VIDEO_SWEEPS} sweeps written by "
        f"{writer} ({mbytes:.1f} MiB; {frames}), lightbox pages in comp, inst, summ; launches "
        f"{launches}; fit "
        f"{result.fit_seconds:.3f} s, render and write {result.render_seconds:.3f} s for "
        f"{result.images} frames ({result.images / result.render_seconds:.2f} frames/s); "
        f"wall {wall:.1f} s [{gpu}]")
    return launches


def check_sweep_frames(path: Path) -> str:
    """One sweep's frames, read back from a GIF (an MP4 is not decoded
    here): VIDEO_RES px frames, the sweep out and back (first and last
    frame equal), an image that changes along it (first and middle
    differ)."""
    if path.suffix != ".gif":
        return "frames not decoded"
    from PIL import Image, ImageSequence
    with Image.open(path) as gif:
        frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(gif)]
    # PIL merges identical neighbours (the turning point) into one frame
    if not (2 * VIDEO_FRAMES - 1 <= len(frames) <= 2 * VIDEO_FRAMES):
        raise AssertionError(f"{path.name}: {len(frames)} frames")
    if frames[0].shape != (VIDEO_RES, VIDEO_RES, 3):
        raise AssertionError(f"{path.name}: frames of shape {frames[0].shape}")
    if not np.array_equal(frames[0], frames[-1]):
        raise AssertionError(f"{path.name}: the sweep does not come back")
    if np.array_equal(frames[0], frames[len(frames) // 2]):
        raise AssertionError(f"{path.name}: the sweep does not move")
    return f"{path.name}: {len(frames)} frames of {VIDEO_RES} px, out and back"


def check_sg1_vs_cpu() -> None:
    """One W through the full-width StyleGAN on the card and on the CPU,
    then a batch of Z to ``g_synthesis.blocks.16x16``."""
    from ganspace_tpu_torch.models.base import InstrumentedModel
    from ganspace_tpu_torch.models.stylegan import SG1Config, StyleGAN, init_params
    params = init_params(SG1Config(), seed=0)
    gpu_model = StyleGAN("ffhq", use_w=True, params=params, device="cuda")
    cpu_model = StyleGAN("ffhq", use_w=True, params=params, device="cpu")
    w = gpu_model.sample_latent(1, seed=7)
    w_cpu = cpu_model.sample_latent(1, seed=7)
    w_err = float((w.cpu() - w_cpu).abs().max() / w_cpu.abs().max())
    img = gpu_model.forward(w).cpu()
    ref = cpu_model.forward(w.cpu())
    if not (torch.isfinite(img).all() and img.shape == (1, 3, 1024, 1024)):
        raise AssertionError(f"StyleGAN image shape {tuple(img.shape)} or non-finite")
    rel = float((2 * img - 2 * ref).abs().max() / (2 * ref - 1).abs().max())
    log(f"StyleGAN 1024 px image, card vs CPU: W rel {w_err:.3e}, image rel {rel:.3e} "
        f"(bar {IMAGE_REL:.0e})")
    if not (w_err < 1e-4 and rel < IMAGE_REL):
        raise AssertionError("card and CPU disagree on the StyleGAN 1024 px image")
    z = torch.from_numpy(np.random.RandomState(8).randn(SG1_TAP_BATCH, 512).astype(np.float32))
    taps = []
    for model in (gpu_model, cpu_model):
        model.use_z()
        inst = InstrumentedModel(model)
        inst.retain_layer(SG1_TAP)
        model.partial_forward(z.to(model.device), SG1_TAP)
        taps.append(inst.retained_features()[SG1_TAP].cpu())
    tap_rel = float((taps[0] - taps[1]).abs().max() / taps[1].abs().max())
    log(f"StyleGAN {SG1_TAP} activation {tuple(taps[1].shape)}, card vs CPU: rel "
        f"{tap_rel:.3e} (bar {TAP_REL:.0e})")
    if not tap_rel < TAP_REL:
        raise AssertionError(f"card and CPU disagree on the {SG1_TAP} activation")


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


def check_checkpoint_load(gpu: str) -> dict:
    """A full-width StyleGAN2-FFHQ-1024 checkpoint in the reference's
    rosinality format (seeded init at CKPT_SEED, not the default's seed;
    grouped-conv leading dim, noise and blur buffers, a non-zero
    ``latent_avg``) in a temporary ``$GANCONTROL_CHECKPOINT_DIR``: the model
    that ``get_instrumented_model`` builds on the card holds the file's
    weights, and at truncation 0.7 its images equal, bit for bit, those of
    the same model built from the params in memory.  Returns its launches."""
    from ganspace_tpu_torch.models import get_instrumented_model, get_model
    from ganspace_tpu_torch.models.stylegan2 import SG2Config, init_params
    params = init_params(SG2Config(), seed=CKPT_SEED)
    latent_avg = (0.5 * np.random.RandomState(CKPT_SEED).randn(512)).astype(np.float32)
    state = {k: torch.from_numpy(v)[None] if k.endswith(".conv.weight") else
             torch.from_numpy(v) for k, v in params.items()}
    state["convs.0.conv.blur.kernel"] = torch.ones(4, 4)
    state["noises.noise_0"] = torch.zeros(1, 1, 4, 4)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        Path(root, "stylegan2").mkdir()
        path = Path(root, "stylegan2", "stylegan2_ffhq_1024.pt")
        torch.save({"g_ema": state, "latent_avg": torch.from_numpy(latent_avg)}, path)
        mib = path.stat().st_size / 2 ** 20
        with environ(GANCONTROL_CHECKPOINT_DIR=root):
            torch.cuda.synchronize()
            reset_launches()
            inst = get_instrumented_model("StyleGAN2", "ffhq", "convs.2", torch.device("cuda"),
                                          truncation=0.7)
    load_s = time.perf_counter() - t0
    model = inst.model
    loaded = model.state_dict()
    if set(loaded) != set(params):
        raise AssertionError("checkpoint: the loaded keys differ from the file's")
    for k, v in params.items():
        if not torch.equal(loaded[k].cpu(), torch.from_numpy(v)):
            raise AssertionError(f"checkpoint: {k} differs from the file's")
    if not torch.equal(model.latent_avg.cpu(), torch.from_numpy(latent_avg)):
        raise AssertionError("checkpoint: latent_avg differs from the file's")
    ref = get_model("StyleGAN2", "ffhq", torch.device("cuda"), params=params,
                    latent_avg=latent_avg, truncation=0.7)
    z = model.sample_latent(CKPT_BATCH, seed=3)
    img, want = model.forward(z), ref.forward(z)
    launches = read_launches()
    if not (torch.isfinite(img).all() and img.shape == (CKPT_BATCH, 3, 1024, 1024)):
        raise AssertionError(f"checkpoint: image {tuple(img.shape)} or non-finite")
    if not torch.equal(img, want):
        raise AssertionError("checkpoint: images differ from the in-memory model's")
    # the shape annotation's convs.2 tap forward, then two full forwards
    expect_launches(launches, "checkpoint", modconv3x3=2 + 2 * 9, upsample_conv=2 + 2 * 8)
    log(f"checkpoint: a {mib:.1f} MiB rosinality .pt at full FFHQ-1024 width (seed "
        f"{CKPT_SEED}) loaded through get_instrumented_model in {load_s:.2f} s: every "
        f"weight and latent_avg equal to the file's; {CKPT_BATCH} images at truncation 0.7 "
        f"equal bit for bit to the in-memory model's; launches {launches} [{gpu}]")
    del inst, model, ref
    return launches


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
    recorder = record_launches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t_start = time.perf_counter()
    with ieee_f32():
        check_tile(gen)
        check_wgmma_tile(gen)
        gram = check_centered_gram(gen)
        conv = check_modconv3x3(gen)
        plain = check_conv3x3(gen)
        up = check_upsample_conv(gen)
    log(f"kernel checks wall time: {time.perf_counter() - t_start:.1f} s")
    from ganspace_tpu_torch.models import get_instrumented_model
    launches = {}
    with ieee_f32():
        launches["checkpoint_load"] = check_checkpoint_load(gpu)
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
    runs = {"convs2_fit_device": run_conv_fit(gpu, conv_inst, device_rng=True),
            "convs2_fit_fused": run_conv_fit(gpu, conv_inst, device_rng=True, fused=True),
            "convs2_fit_fused_again": run_conv_fit(gpu, conv_inst, device_rng=True,
                                                   fused=True),
            "convs2_fit_host": run_conv_fit(gpu, conv_inst, device_rng=False),
            "convs2_fit_host_seed7": run_conv_fit(gpu, conv_inst, device_rng=False,
                                                  seed=7)}
    del conv_inst
    launches.update({path: run["launches"] for path, run in runs.items()})
    log(f"conv-tap fit at n = {CONV_N}: fused stream "
        f"{runs['convs2_fit_fused']['seconds']:.3f} s against the device pre-sampled "
        f"stream's {runs['convs2_fit_device']['seconds']:.3f} s [{gpu}]")
    check_fused_fit_repeats(runs["convs2_fit_fused"], runs["convs2_fit_fused_again"])
    report_conv_stream_gate(gpu, runs["convs2_fit_fused"], runs["convs2_fit_host"],
                            runs["convs2_fit_host_seed7"])
    log(f"StyleGAN2 phases wall time: {time.perf_counter() - t_start:.1f} s")

    # StyleGAN (v1), the CLI's default model, at full FFHQ-1024 width
    t0 = time.perf_counter()
    launches["sg1_default_cli"], sg1_device = run_sg1_default(gpu)
    z_inst = get_instrumented_model("StyleGAN", "ffhq", "g_mapping", torch.device("cuda"))
    sg1_host = check_sg1_stream_gate(gpu, z_inst, sg1_device)
    launches["sg1_fit_host"], launches["sg1_fit_host_seed7"] = (
        sg1_host[0]["launches"], sg1_host[7]["launches"])
    del z_inst
    w_inst = get_instrumented_model("StyleGAN", "ffhq", "g_mapping", torch.device("cuda"),
                                    use_w=True)
    launches["sg1_fit_w"] = run_sg1_w_fit(gpu, w_inst, sg1_host)
    del w_inst
    tap_inst = get_instrumented_model("StyleGAN", "ffhq", SG1_TAP, torch.device("cuda"))
    launches["sg1_fit_16x16"] = run_sg1_tap_fit(gpu, tap_inst)
    del tap_inst
    launches["sg1_video_bedrooms"] = run_sg1_video(gpu)
    log(f"StyleGAN phases wall time: {time.perf_counter() - t0:.1f} s")
    conv_npz = runs["convs2_fit_host"]["arrays"]
    with ieee_f32():
        profile_conv_tap_blocks(gpu)
        check_sketch_gate(gpu)
        check_sketch_vs_cpu()
        check_vs_cpu(conv_npz)
        check_sg1_vs_cpu()
        check_launched_shapes(recorder, gen)
    log(f"total wall time: {time.perf_counter() - t_start:.1f} s")

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
        dict(name="conv3x3", route="cuda",
             source="ganspace_tpu_torch/csrc/modconv3x3.cu",
             replaces="ganspace_tpu/ops/pallas/blockconv.py:178",
             **counts("conv3x3"), **plain),
        dict(name="upsample_conv", route="cuda",
             source="ganspace_tpu_torch/csrc/upconv2x.cu",
             replaces="ganspace_tpu/models/stylegan.py:164",
             **counts("upsample_conv"), **up),
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
