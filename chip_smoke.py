#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``ganspace_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: require CUDA and print the card's name and power limit;
2. build: compile the CUDA kernels from ``ganspace_tpu_torch/csrc``;
3. the 3xTF32 tensor-core step of ``csrc/tf32x3.cuh`` on one 16x8x8 tile;
4. kernel A (centered Gram) against its plain PyTorch version, on the card,
   with a wide-range case and a determinism check, and at the paths' block
   shapes (4096, 5120, 37376 and 65536 rows of 512) and the full-batch
   fits' one launch over 1003520 rows of 512 (also against a float64 Gram);
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
   deterministic), after its wgmma steps alone on one tile (3xTF32, 64 x N
   x 32, and the bf16 datapath's, 64 x N x 64);
   BigGAN-512's stride-1 3x3 shapes and ``conv_to_rgb`` (3 and 128 output
   channels) in the plain mode and its seven nearest-up convs as the
   stride-2 mode with composite 4x4 kernels, at the render's batch and the
   ``generator.layers.1`` fit's, beside cuDNN (``conv2d``, and ``conv2d`` of
   the nearest-upsampled map for the up-convs); ProGAN-256's seven 3x3
   and six nearest-up convs the same way, at the render's batch and at the
   layer2 and layer6 fits'; DCGAN's four transposed convs (the last to 3
   channels) at the render's batch and the deconv1 fit's; kernel A at
   ProGAN's layer2 block, 2048 rows of 8192.  Every case repeats bit for
   bit.  The lists are built from the paths' own batches and
   configurations;
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
10. the full-batch estimators at W: ``visualize --model StyleGAN2 --class
   ffhq --use_w --layer style --est pca -c 80 -n 1000000`` (the whole
   [1003520, 512] sample matrix collected on the card, kernel A launched
   once over it, the grids), its components gated against the moments-tier
   fit of phase 8 by the seed control of phase 9; the ICA fit (kernel A
   once, for the whitening; its FastICA iterations printed) and the sparse
   PCA fit (``--sparsity 1.0``, no kernel A; its share of zeros printed) at
   the same n; then the four full-batch estimators on the card against the
   CPU on the first 65536 + 4096 W latents;
11. the conv-tap path in the default environment: ``visualize --model
   StyleGAN2 --class ffhq --layer convs.2 --est ipca -c 80 -n 50000`` in Z
   space (D = 512 * 16 * 16 = 131072; the fused activation stream of 390
   blocks of 128 with the sketch tier's refine pass, the regression's and
   the baselines' moments riding it; activation- and latent-mode grids),
   with its exact kernel-B launch counts, its phase times, its cache and
   its grids checked; then the fused-regression gate: the same 390 blocks
   regenerated, the explicit normal equations solved against the run's
   components, block 0 drawn again equal bit for bit;
12. the conv-tap fit alone at ``-n 20000``: the pre-sampled device stream
   with the regression sweep, the fused activation stream forced below its
   threshold (``GANSPACE_FUSED_ACTS=1``, timed against it) twice, its two
   caches equal bit for bit, then the host-RNG one under seed 1 and seed 7,
   with the fused stream's components beside the seed control (reported,
   not gated); then fbpca on the host stream, a full-batch fit (the
   collecting sweep through kernel B's modulated and stride-2 modes into a
   [21968, 131072] matrix on the card, the randomized SVD, the regression
   sweep), beside the host sketch fit (printed, not gated), and fbpca on
   2048 ``convs.2`` activations on the card against the CPU;
13. StyleGAN (v1), the CLI's default model, at full FFHQ-1024 width: the
   default command ``visualize --model StyleGAN --class ffhq --layer
   g_mapping --est ipca -c 80`` at the default n = 300000 (the fused
   activation stream into the moments tier; 24 grids through kernel B's
   plain and stride-2 modes); the host-RNG g_mapping fit under seeds 1 and
   7 and the statistical gate of the default command's device stream
   against it; the ``--use_w`` fit (the fused W stream); the conv tap
   ``g_synthesis.blocks.16x16`` at n = 50000 (the sketch tier); ``--video``
   on the real 256-px config (bedrooms) at -c 1, cut from 1024 px and 15
   components (~20k frames), through ffmpeg or, without it, GIF;
14. one fit block of the pre-sampled conv-tap path and 16 blocks of the
   fused activation stream under ``torch.profiler`` (device time by kernel,
   busy share of the wall time), then the sketch tier on the card against exact
   PCA: a rank-2048 stream at D = 131072 with a slowly decaying spectrum,
   whose exact sample PCA is a 2048-dimensional float64 problem; the
   single-pass sketch must miss the bar there and the refined one pass it;
15. the sketch tier on the card against the same stream and Omega on the
   CPU (D = 32768);
16. one 1024-px image, one batch of ``convs.2`` activations and the latent
   regression (``linreg_lstsq`` on the host-RNG conv-tap fit's components)
   through the card (kernels) against the same model on the CPU (plain
   versions); then one 1024-px StyleGAN image and one batch of
   ``blocks.16x16`` activations the same way;
17. BigGAN-deep-512 (class husky, truncation 1.0) at full width: a
   HuggingFace ``pytorch_model.bin`` with spectral-norm triples (sigma !=
   1) written from a seeded init and loaded through
   ``get_instrumented_model`` (the baked weights, images bit for bit
   against the model built in memory); the CLI ``visualize --model
   BigGAN-512 --class husky --layer generator.gen_z --est ipca -c 80 -n
   1000000 -b 10000`` (the fused stream of truncated device latents into
   the sketch tier, 24 grids at 512 px); the host-RNG gen_z fits under
   seeds 1 and 7 at n = 40960 and the gate of the device stream against
   them (``stdev`` beside the subspace metrics; every device latent within
   +-2 truncation); a profile of four fused gen_z blocks and of one
   5-frame forward; the conv tap
   ``generator.layers.1`` at n = 20000 on the fused stream (kernel B and
   the stride-2 mode inside the fit); then two 512-px images and the gen_z
   and layers.1 taps on the card against the CPU;
18. ProGAN-256 (class bedroom) and the pytorch_GAN_zoo DCGAN at full
   width: a GANDissect ``.pth`` and a zoo hub ``.pth`` written from seeded
   inits and loaded through ``get_instrumented_model`` (images bit for bit
   against the models built in memory); ``visualize --model ProGAN --class
   bedroom --layer layer2 --est ipca -c 80`` at the default n = 300000 (the
   fused stream into the moments tier, kernel A at [2048, 8192] per block,
   24 grids at 256 px), its host-RNG fits under seeds 1 and 7 and the
   flat-spectrum gate of the device stream against them; the ``layer6``
   fit at n = 20000 on the fused stream, twice, bit for bit; ``visualize
   --model DCGAN --layer deconv1 --est ipca -c 80`` at n = 300000 (the
   sketch tier, the stride-2 kernel at k = 4 in the fit, 24 grids at 64
   px); then both models' images and every tap on the card against the
   CPU;
19. the paper's figure scripts (``ganspace_tpu_torch/notebooks``) at their
   defaults and full width, each through its ``main``: the six
   StyleGAN2-FFHQ-1024 figures (teaser, PCA cleanup, style/content
   separation, supervised comparison, first 20 PCs, edit zoo; W, ``style``,
   n = 2048, one cache for c = 8 and one for first_20_pcs, cut from 20 rows
   to 5 for time) and the three BigGAN-128 figures (husky,
   ``generator.gen_z``, n = 512, c = 8: style resampling, style mixing,
   edit transferability), each with its exact launch counts, its seconds
   and frames/s, its PNGs decoded and their shapes checked; the teaser's
   first chain, one style-mixing cell and the PCA illustration's axes on
   the card against the CPU; ``python -m ganspace_tpu_torch makesample``
   (16 StyleGAN2 images at 1024 px) in a process of its own, its PNGs bit
   for bit the card's ``sample_np``, and which image writer ran;
20. every kernel shape launched over the run (recorded in front of the
   kernel library) that phase 5 did not cover, such as the fits' batch-1
   probes and the viewer's batch-1 frames, held against its plain version
   by the same bars, on the datapath it was launched on.

The preview policy (``ops/precision.py``), in phase 5 and after phases 7
and 11:

* kernel B's modulated and plain modes and the stride-2 mode on the bf16
  datapath, in both storages (float32 on bf16 operands, the ``--dtype
  bfloat16`` fit's; bf16, the viewer's), at StyleGAN2's render shapes and
  the ``convs.2`` tap shapes, StyleGAN's ten plain and four fused shapes,
  BigGAN-512's and ProGAN-256's plain shapes of a preview render (their
  up-convs before the JAX package's space-to-depth tail among them, as
  nearest 2x then the plain mode) and their composite nearest-up convs in
  the tail, DCGAN-64's transposed convs, beside cuDNN on bf16 tensors: a float32
  output to the float32 bar, a bf16 one within one bf16 rounding flip
  elementwise, repeats bit for bit;
* the viewer, ``python -m ganspace_tpu_torch interactive --model StyleGAN2
  --class ffhq --layer style --use_w``: its ``Session`` on the W CLI's
  cache (phase 7) in the preview policy and in float32, the warmup,
  ``time_frame`` and ``time_frame_speculative``, a latent, an activation
  and a layer-window edit, the HTTP endpoints on an ephemeral port, and
  the preview frame against the float32 frame of the same state (mean
  |d| in uint8 levels held to ``PREVIEW_ERR_RATIO`` times the JAX
  package's figure on a 256-px model), and a profile of one frame's
  synthesis in each precision; then StyleGAN-FFHQ-1024's viewer at
  ``g_mapping`` (kernel B's plain mode and the fused stride-2 convs), the
  same way; after phase 18 the viewer on BigGAN-512 (``generator.gen_z``),
  ProGAN-256 (``layer2``) and DCGAN-64 (``deconv1``), each on a fit at n =
  4096, the same way, gated at ``PREVIEW_ERR_RATIO`` times the JAX
  package's figure on a reduced model of the family; each profiled frame
  prints its copy-kernel launches (dtype casts and layout copies);
* after phase 18, ``visualize --model ProGAN --class bedroom --layer
  layer6 -n 20000 --dtype bfloat16`` on the fused stream, as the float32
  layer6 fit runs: the _bf16 cache, its bounds and grade, its components
  beside the float32 fit's (reported);
* ``visualize --layer convs.2 -n 50000 --dtype bfloat16``: the _bf16
  cache, its 80 cosine bounds and the grade they imply, its components
  beside the float32 CLI's (reported);
* the bf16 first pass: the float32 ``convs.2`` fit at n = 20000 on the
  fused stream twice, the registry in a temporary directory: the second
  run streams bf16 first and stays within 0.99 |cos| of the first.  The
  rest of the run has the registry off (``GANSPACE_COMPILE_CACHE`` unset,
  the default), so its fits stay all float32.

Every path reads the launch counts of the four kernel entries (kernel A;
kernel B's modulated, plain and stride-2 modes, one launch per call; the
last three counted apart on the bf16 datapath, ``<name>_bf16``), set to 0
just before it and read just after, and holds them to the counts its
shapes give.

Kernel times are medians over launches by CUDA events, each launch after a
write of a 128 MB buffer that evicts the 50 MB L2 (in the render each
layer's weight is read once per forward, cold).  Beside each kernel stand
its plain version, the one PyTorch call that computes the same function
(``library_ms``, timed here only; the port never calls it) and its bound:
the larger of its FLOP over the 3xTF32 peak (495 / 3 = 165 TFLOP/s; the
kernels compute float32 products as 3xTF32) and its bytes (each input read
once, each output written once) over 3.35 TB/s, the H100 SXM's published
peaks at 700 W.  The FFMA bound (67 TFLOP/s) is printed beside it.  On
the bf16 datapath the bound is the dense bf16 peak (989 TFLOP/s: bf16
products with float32 sums), the activations counted at their storage's
size.

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
# The full-batch estimators (pca, fbpca, ica, spca) fit the whole collected
# matrix at once: n_total + nb rows, the last nb left zero
# (decomposition._compute).  At W and n = 1M: 999424 + 4096 rows of 512,
# kernel A's one launch for PCA and for ICA's whitening.
W_FULL_ROWS = W_N_1M // W_BATCH * W_BATCH + W_BATCH                   # 1003520
PCA_ARGS = ["--model", "StyleGAN2", "--class", "ffhq", "--use_w", "--layer", "style",
            "--est", "pca", "-c", "80", "-n", str(W_N_1M)]
SPCA_SPARSITY = 1.0       # the CLI's default --sparsity
# the estimators on the card against the CPU: the first 65536 + 4096 W
# latents of the pre-sampled device stream, and 2048 convs.2 activations
# (16 tap forwards at the path's batch) for fbpca
VS_CPU_W_ROWS, VS_CPU_TAP_ROWS = 65536 + 4096, 2048
VS_CPU_COS, VS_CPU_STDEV_REL = 0.999, 1e-4
# sample matrices of more than 2^31 elements, where the estimators still take
# kernel A (64-bit addresses): a W fit at n = 4M+ and a conv1 fit (D = 8192)
# at n = 256k+, 64 rows past the 2^31 mark each
GRAM_OVER_INT = [(2 ** 31 // d + 64, d) for d in (512, 8192)]


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
# (n = 40960, 1M and StyleGAN's --use_w at 300000), 4096 (the host
# streams, the remainders, StyleGAN's g_mapping activation stream) and
# ProGAN's layer2 block, 2048 rows of 8192 (PG_BATCH, PG_D below)
GRAM_STREAM_SHAPES = sorted({(w_stream_nb(n), 512) for n in (W_N, W_N_1M, SG1_N)}
                            | {(W_BATCH, 512), (2048, 8192)})
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
# BigGAN-deep-512 (models/biggan.BigGANConfig.for_resolution(512): 128 wide,
# 14 GenBlocks from 4 to 512 px, attention at 64 px), class husky, truncation
# 1.0: the README's BigGAN command, BASELINE.json's third configuration.
# gen_z (D = 4 * 4 * 2048 = 32768) takes the sketch tier; -b 10000 gives the
# fused activation stream 100 blocks of 10000, and the render 24 grids of 14
# strips of 5 frames, one forward each
BG_N, BG_BATCH = 1_000_000, 10_000
BG_ARGS = ["--model", "BigGAN-512", "--class", "husky", "--layer", "generator.gen_z",
           "--est", "ipca", "-c", "80", "-n", str(BG_N), "-b", str(BG_BATCH)]
BG_TAP_D = 4 * 4 * 2048
BG_STRIPS = 2 * 12 * 14                 # activation and latent mode, 12 grids of 14 rows
# the stream gate: the host gen_z fits under seeds 1 and 7 and a device one,
# at the heuristic batch 512 (256 MiB / (32768 * 16 B)); the flat-spectrum
# gate's bar on act_stdev (check_flat_gate)
BG_GATE_N, STDEV_BAR = 40960, 4.0
# a conv tap with kernel B and B-up inside the fused fit: generator.layers.1
# (8 px, 2048 channels, D = 131072) at n = 20000, the fused stream forced
# (156 blocks of the heuristic batch 128)
BG_TAP, BG_TAP_N, BG_TAP_BATCH = "generator.layers.1", 20_000, 128
BG_TAP_BLOCKS = BG_TAP_N // BG_TAP_BATCH


def bg_shapes(batch: int, upto: int | None = None, preview: bool = False,
              resolution: int = 512) -> tuple[list, list]:
    """Kernel B's calls in one BigGAN forward (512 px unless ``resolution``
    names another) at ``batch``, through module ``upto`` (a partial
    forward) or all of them, in order, repeats included:
    the plain mode's (B, C, Co, H, W) (conv_1 of the blocks that keep their
    size, every conv_2, conv_to_rgb's three rows) and the stride-2 mode's
    (B, C, Co, H, W, 4, 1, False) (each up-block's nearest-up conv_1).  Under
    the ``preview`` policy the up-blocks before the JAX package's
    space-to-depth tail (``BigGANConfig.tail_entry``) run their conv_1 as
    nearest 2x then the plain mode."""
    from ganspace_tpu_torch.models.biggan import BigGANConfig
    cfg = BigGANConfig.for_resolution(resolution)
    entry = cfg.tail_entry()
    plain, up, r = [], [], 4
    for mi, mod in enumerate(cfg.module_plan()):
        if upto is not None and mi > upto:
            break
        if mod[0] == "attn":
            continue
        mid = mod[2] // 4
        if mod[1] and preview and (entry is None or mi < entry):
            r *= 2
            plain.append((batch, mid, mid, r, r))
        elif mod[1]:
            up.append((batch, mid, mid, r, r, 4, 1, False))
            r *= 2
        else:
            plain.append((batch, mid, mid, r, r))
        plain.append((batch, mid, mid, r, r))
    if upto is None:
        plain.append((batch, cfg.channel_width * cfg.layers[-1][2], 3, r, r))
    return plain, up


def bg_plain_cases() -> dict:
    """Kernel B's plain-mode groups of BigGAN-512: its render's distinct
    shapes at B = 5 with conv_to_rgb's 128 rows beside its three (the tap
    read), and the layers.1 fit's at B = 128."""
    render = list(dict.fromkeys(bg_shapes(RENDER_BATCH)[0]))
    return {"bg_render": render + [(RENDER_BATCH, 128, 128, 512, 512)],
            "bg_tap": list(dict.fromkeys(bg_shapes(BG_TAP_BATCH, upto=1)[0]))}


def bg_up_cases() -> dict:
    """The stride-2 mode's BigGAN-512 groups: the seven nearest-up convs at
    the render's batch and the layers.1 fit's one at B = 128."""
    return {"bg_render": bg_shapes(RENDER_BATCH)[1],
            "bg_tap": bg_shapes(BG_TAP_BATCH, upto=1)[1]}


def pg_plain_cases() -> dict:
    """Kernel B's plain-mode groups of ProGAN-256: its render's seven 3x3
    shapes at B = 5, the layer2 CLI fit's one at B = 2048 and the layer6
    fit's three at B = 128."""
    return {"pg_render": pg_shapes(RENDER_BATCH)[0],
            "pg_l2_fit": pg_shapes(PG_BATCH, upto="layer2")[0],
            "pg_l6_fit": pg_shapes(PG_TAP_BATCH, upto=PG_TAP)[0]}


def up_groups() -> dict:
    """Every stride-2 group: StyleGAN2's and StyleGAN's, BigGAN-512's and
    ProGAN-256's nearest-up convs (composite kernels), ProGAN's at its
    render's batch and the layer6 fit's, and DCGAN's transposed convs at
    its render's batch (the last to three channels) and the deconv1 fit's."""
    return {**UP_CASES, **bg_up_cases(),
            "pg_render": pg_shapes(RENDER_BATCH)[1],
            "pg_l6_fit": pg_shapes(PG_TAP_BATCH, upto=PG_TAP)[1],
            "dc_render": dc_shapes(RENDER_BATCH), "dc_fit": dc_shapes(DC_BATCH, upto=1)}


#: the stride-2 groups whose cases are nearest 2x + 3x3 as a composite kernel
NEAREST_UP_GROUPS = ("bg_", "pg_")


# ProGAN-256 (GANDissect ProgressiveGenerator, models/proggan.SIZES_FOR_RESOLUTION
# [256]: 512 channels from 4 to 16 px, then 256, 128, 64 and 32 to 256 px),
# class bedroom: the CLI at layer2 (D = 512 * 4 * 4 = 8192, the moments tier:
# kernel A once per block of the fused activation stream) at the config's
# default n, its batch the heuristic's 256 MiB / (8192 * 16 B) = 2048: 146
# blocks; 24 grids of 14 strips at 256 px.  Then layer6 (16 px, D = 131072,
# the sketch tier) at n = 20000: 156 fused blocks of 128
PG_N, PG_BATCH, PG_D = 300_000, 2048, 512 * 4 * 4
PG_ARGS = ["--model", "ProGAN", "--class", "bedroom", "--layer", "layer2", "--est", "ipca",
           "-c", "80", "-n", str(PG_N)]
PG_BLOCKS = PG_N // PG_BATCH                                     # 146
PG_STRIPS = 2 * 12 * 14                 # activation and latent mode, 12 grids of 14 rows
PG_TAP, PG_TAP_N, PG_TAP_BATCH = "layer6", 20_000, 128
PG_TAP_BLOCKS = PG_TAP_N // PG_TAP_BATCH                         # 156
# the pytorch_GAN_zoo DCGAN (models/dcgan.DCGANConfig(): 140-dim latent, 512
# channels at 4 px to 64 at 32 px, RGB at 64 px): the CLI at deconv1 (8 px,
# D = 256 * 8 * 8 = 16384, the sketch tier) at the default n, its batch
# 256 MiB / (16384 * 16 B) = 1024: 292 fused blocks; 24 grids at 64 px.
# Its partial_forward is a full forward, as the reference's is
DC_N, DC_BATCH, DC_D = 300_000, 1024, 256 * 8 * 8
DC_ARGS = ["--model", "DCGAN", "--layer", "deconv1", "--est", "ipca", "-c", "80",
           "-n", str(DC_N)]
DC_BLOCKS = DC_N // DC_BATCH                                     # 292
DC_STRIPS = 2 * 12 * 14


def pg_shapes(batch: int, upto: str | None = None,
              preview: bool = False) -> tuple[list, list]:
    """Kernel B's calls in one ProGAN-256 forward at ``batch``, through the
    layer ``upto`` or all of them: the plain mode's (B, C, Co, H, W) (every
    stride-1 3x3) and the stride-2 mode's (B, C, Co, H, W, 4, 1, False)
    (every up layer, its composite 4x4 kernel).  Under the ``preview``
    policy the up layers before the JAX package's space-to-depth tail (of
    more than ``S2D_MAX_CH`` output channels) run nearest 2x then the plain
    mode."""
    from ganspace_tpu_torch.models.proggan import ProGANConfig
    from ganspace_tpu_torch.ops.modconv import S2D_MAX_CH
    plain, up, r, tail = [], [], 4, False
    for name, cin, cout, k, _, is_up in ProGANConfig.for_resolution(256).layer_plan():
        tail = tail or (is_up and k == 3 and cout <= S2D_MAX_CH)
        if is_up and preview and not tail:
            r *= 2
            plain.append((batch, cin, cout, r, r))
        elif is_up:
            up.append((batch, cin, cout, r, r, 4, 1, False))
            r *= 2
        elif k == 3:
            plain.append((batch, cin, cout, r, r))
        if name == upto:
            break
    return plain, up


def dc_shapes(batch: int, upto: int | None = None) -> list:
    """The stride-2 mode's calls in one DCGAN forward at ``batch``, through
    ``deconv{upto}`` or all of them: (B, C, Co, H, W, 4, 1, False)."""
    from ganspace_tpu_torch.models.dcgan import DCGANConfig
    ch = DCGANConfig().channels()
    return [(batch, ch[i - 1], ch[i], 2 ** (i + 1), 2 ** (i + 1), 4, 1, False)
            for i in range(1, len(ch)) if upto is None or i <= upto]


def pg_counts(upto: str | None = None, preview: bool = False) -> tuple[int, int]:
    """(plain 3x3, stride-2) launches of one ProGAN-256 forward."""
    plain, up = pg_shapes(1, upto, preview)
    return len(plain), len(up)


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
# the bf16 datapath of kernel B and the stride-2 kernel (ops/modconv.py's
# modes): float32 storage on bf16 operands (the preview precision, the
# --dtype bfloat16 fit) and bf16 storage (the viewer's preview policy).
# The function is bf16 x bf16 products with float32 sums, so the bound is
# the card's dense bf16 tensor peak, whatever pass the kernel runs it in (one
# TF32 pass); a bf16 output may differ from its plain version by one rounding
# flip, one bf16 ulp (2^-7 of |ref| at most, 8 significant bits), beside the
# float32 summation's 1e-6 of max|ref|
MODE_F32, MODE_BF16_OPS, MODE_BF16 = 0, 1, 2
PEAK_BF16 = 989e12
# the viewer's preview frame against its float32 frame of the same state,
# mean |d| in uint8 levels: the JAX package's, its contractions on the
# one-pass bf16 datapath of its TPU, measured on the CPU by the tests, which
# hold these values and the port's within 0.8-1.25x of them: StyleGAN2 and
# StyleGAN on 256-px models (tests/test_torch_port_interactive.py),
# BigGAN-512 at width 4, ProGAN-256 at half width and DCGAN-64 at full width
# (tests/test_torch_port_preview_families.py).  The most the port's
# full-width frame may show on the card is 2x them: room for the full
# model's depth and width
PREVIEW_JAX_MEAN_LEVELS = {"StyleGAN2": 1.7537, "StyleGAN": 3.5613, "BigGAN": 0.4200,
                           "ProGAN": 0.8499, "DCGAN": 0.0022}
PREVIEW_ERR_RATIO = 2.0
BF16_ABS = 1e-6


def preview_groups() -> dict:
    """The bf16 datapath's shapes: StyleGAN2's modulated 3x3 shapes (the
    render's nine at B = 5, the conv-tap path's two at B = 128); the plain
    mode at StyleGAN's ten shapes, BigGAN-512's and ProGAN-256's preview
    render shapes at B = 5 (their pixel-layout up-convs among them); the
    stride-2 mode at StyleGAN2's eight render shapes, StyleGAN's four fused
    ones, the conv-tap path's two at B = 128 (the --dtype bfloat16 fit and
    the bf16 first pass), and the composite nearest-up convs of BigGAN-512's
    and ProGAN-256's preview renders (their space-to-depth tail) and DCGAN's
    transposed convs at B = 5, with no s or d."""
    return {
        "modconv3x3": {"sg2_render": CONV_CASES, "sg2_tap": CONV_TAP_CASES},
        "conv3x3": {"sg1_render": PLAIN_CASES,
                    "bg_render": list(dict.fromkeys(bg_shapes(RENDER_BATCH, preview=True)[0])),
                    "pg_render": list(dict.fromkeys(pg_shapes(RENDER_BATCH, preview=True)[0]))},
        "upsample_conv": {"sg2_render": UP_CASES["sg2_render"],
                          "sg1_fused": UP_CASES["sg1_fused"], "sg2_tap": UP_CASES["sg2_tap"],
                          "bg_render": bg_shapes(RENDER_BATCH, preview=True)[1],
                          "pg_render": pg_shapes(RENDER_BATCH, preview=True)[1],
                          "dc_render": dc_shapes(RENDER_BATCH)},
    }


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
    """The stride-2 kernel's wgmma steps alone: the 3xTF32 one (A's register
    fragments, B's swizzled image and descriptor, the accumulator layout)
    and the bf16 one of its bf16 datapath (A rounded into its swizzled
    shared tile as the body's pass writes it, B's bf16 image, both read
    through descriptors), against float64 products of the same operands."""
    from ganspace_tpu_torch.ops.precision import round_bf16
    from ganspace_tpu_torch.ops.tf32x3 import wgmma_tile_3xtf32, wgmma_tile_bf16
    for n in (144, 256):
        a = torch.randn(64, 64, generator=gen, device="cuda")
        b = torch.randn(n, 64, generator=gen, device="cuda")
        got = wgmma_tile_bf16(a, b).double()
        ref = round_bf16(a).double() @ round_bf16(b).double().T
        rel = float((got - ref).abs().max() / ref.abs().max())
        log(f"wgmma bf16 tile 64x{n}x64 against float64: rel {rel:.3e} (bar {TILE_REL:.0e})")
        if not rel < TILE_REL:
            raise AssertionError(f"wgmma bf16 tile n={n}: rel err {rel} >= {TILE_REL}")
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
    shapes[f"{W_FULL_ROWS}x512"] = check_full_batch_gram(gen)
    for n, d in GRAM_OVER_INT:
        shapes[f"{n}x{d}"] = check_gram_over_int(gen, n, d)
    timing["shapes"] = shapes
    return timing


def check_full_batch_gram(gen: torch.Generator) -> dict:
    """Kernel A where the JAX package calls its Pallas kernel: PCA's Gram
    and ICA's whitening covariance, one launch over the whole W matrix at
    n = 1M (W_FULL_ROWS x 512), its mean given.  Against the plain version
    by the bar, and beside it against a float64 Gram; then timed."""
    from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
    n, d = W_FULL_ROWS, 512
    x = torch.randn(n, d, generator=gen, device="cuda") * 2.0 + 0.5
    mean = x.mean(dim=0)
    launches = centered_gram.launches
    got = centered_gram(x, mean)
    if centered_gram.launches != launches + 1:
        raise AssertionError(f"centered_gram {n}x{d}: the kernel did not launch")
    ref = centered_gram_plain(x, mean)
    xd = x.double() - mean.double()
    ref64 = xd.T @ xd
    del xd
    err, bar = float((got - ref).abs().max()), gram_bar(ref)
    err64 = float((got.double() - ref64).abs().max())
    plain64 = float((ref.double() - ref64).abs().max())
    log(f"centered_gram N={n} D={d} (the full-batch fits' one launch, its mean given): "
        f"max|d| against the plain version {err:.3e} (bar {bar:.3e}); against float64: "
        f"kernel {err64:.3e}, plain version {plain64:.3e} (max|ref| "
        f"{float(ref64.abs().max()):.3e})")
    if not err <= bar:
        raise AssertionError(f"centered_gram {n}x{d}: max|d| {err} > {bar}")
    if not torch.equal(got, centered_gram(x, mean)):
        raise AssertionError(f"centered_gram {n}x{d}: two launches differ")
    del got, ref, ref64
    row = gram_timing(x, err)
    row.update(max_abs_err_f64=err64, plain_max_abs_err_f64=plain64)
    CHECKED.add(("centered_gram", n, d))
    return row


def check_gram_over_int(gen: torch.Generator, n: int, d: int) -> dict:
    """The estimators' Gram (``estimators/pca.covariance``) on an [n, d]
    matrix of more than 2^31 elements: one kernel-A launch, two launches
    bit-identical, then timed (at D = 8192 over 3 launches, each near a
    second).  At these n the float32 plain version (one cuBLAS product with
    K = n) is itself farther from the exact Gram than the bar, so the kernel
    is held by the bar against the plain version in float64, and must be no
    farther from it than the float32 plain version."""
    from ganspace_tpu_torch.estimators.pca import covariance
    from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
    x = torch.randn(n, d, generator=gen, device="cuda") * 2.0 + 0.5
    mean = x.mean(dim=0)
    launches = centered_gram.launches
    got = covariance(x, mean)
    if centered_gram.launches != launches + 1:
        raise AssertionError(f"covariance {n}x{d}: {centered_gram.launches - launches} "
                             "kernel-A launches, expected 1")
    xd = x.double() - mean.double()
    ref64 = xd.T @ xd
    del xd
    err, bar = float((got.double() - ref64).abs().max()), gram_bar(ref64)
    plain_err = float((centered_gram_plain(x, mean).double() - ref64).abs().max())
    log(f"centered_gram N={n} D={d} ({n * d} elements, past 2^31; the estimators' "
        f"covariance): max|d| against the plain version in float64 {err:.3e} (bar "
        f"{bar:.3e}); the float32 plain version's {plain_err:.3e}")
    if not (err <= bar and err <= plain_err):
        raise AssertionError(f"centered_gram {n}x{d}: max|d| {err} against float64 above "
                             f"the bar {bar} or the float32 plain version's {plain_err}")
    if not torch.equal(got, covariance(x, mean)):
        raise AssertionError(f"centered_gram {n}x{d}: two launches differ")
    del got, ref64
    row = gram_timing(x, err, reps=3 if d > 512 else 20)
    row.update(max_abs_err_f64=err, plain_max_abs_err_f64=plain_err)
    CHECKED.add(("centered_gram", n, d))
    return row


def gram_timing(x: torch.Tensor, err: float, reps: int = 20) -> dict:
    """Kernel A, its plain version and cuBLAS at one shape, beside the bound;
    the main path passes the block mean (estimators/ipca.py)."""
    from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
    n, d = x.shape
    mean = x.mean(dim=0)
    xc = x - mean
    warmup = min(3, reps)
    row = timed(median_ms(lambda: centered_gram(x, mean), reps, warmup),
                median_ms(lambda: centered_gram_plain(x, mean), reps, warmup),
                median_ms(lambda: xc.T @ xc, reps, warmup),
                bound(n * d * (d + 1), 4 * (n * d + d + d * d)))
    row["max_abs_err"] = err
    log(f"  N={n} D={d}: two launches bit-identical; median of {reps}: kernel {row['ms']:.4f} ms, "
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


@contextlib.contextmanager
def precision_for(mode: int):
    """The policy under which a float32 ``x`` takes datapath ``mode``: the
    preview precision for MODE_BF16_OPS, else the float32 one (a bf16 ``x``
    takes MODE_BF16 under either)."""
    from ganspace_tpu_torch.ops.precision import precision
    with precision("default" if mode == MODE_BF16_OPS else "highest"):
        yield


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |t|: 2^(floor(log2 |t|) - 7)."""
    e = torch.floor(torch.log2(t.abs().float().clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


def datapath_err(got: torch.Tensor, ref: torch.Tensor, case, what: str, mode: int):
    """(max|d|, max|d| / max|ref|) of a kernel against its plain version on
    datapath ``mode``; raises above its bar: float32 output, CONV_REL
    relative (only the summation order differs); bf16 output, elementwise
    one bf16 rounding flip plus BF16_ABS of max|ref|."""
    if mode != MODE_BF16:
        return conv_err(got, ref, case, what)
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{case}{what}: bf16 storage gave a {got.dtype} output")
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    top = float(r.abs().max())
    over = d > bf16_ulp(r) + BF16_ABS * top
    if bool(over.any()):
        raise AssertionError(f"{case}{what} bf16: {int(over.sum())} of {d.numel()} outputs "
                             f"past one bf16 flip (max|d| {float(d.max())})")
    return float(d.max()), float(d.max()) / top


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
        CHECKED.add(("modconv3x3", *case, True, MODE_F32))
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
    the other paths' batches (``PLAIN_PATH_CASES``), at BigGAN-512's
    (``bg_plain_cases``) and ProGAN-256's (``pg_plain_cases``), and at two
    ragged shapes (Co <= 16 takes the 16-channel tile)."""
    import torch.nn.functional as F
    from ganspace_tpu_torch.ops.modconv import conv3x3, conv3x3_plain
    groups = {"render": PLAIN_CASES, **PLAIN_PATH_CASES, **bg_plain_cases(),
              **pg_plain_cases(), "ragged": [(3, 20, 16, 9, 13), (2, 16, 7, 5, 5)]}
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
            CHECKED.add(("conv3x3", *case, False, MODE_F32))
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
    without this kernel).  BigGAN's up-convs take the composite kernel of a
    3x3 weight, and cuDNN's call for them is the conv of the nearest-upsampled
    map they replace.  The kernel is timed with its split weight kept,
    as a layer keeps it (``LayerWeights``)."""
    import torch.nn.functional as F
    from ganspace_tpu_torch.ops.modconv import (
        LayerWeights, nearest_up_kernel, upsample_conv, upsample_conv_plain)
    out, worst = {}, 0.0
    for group, cases in up_groups().items():
        nearest = group.startswith(NEAREST_UP_GROUPS)
        rows = []
        for case in cases:
            b, c, co, h, w, k, pad, modulated = case
            x, wt, s, d = up_inputs(gen, case)
            if nearest:
                # BigGAN's and ProGAN's nearest 2x + 3x3 conv, as the composite kernel
                w3 = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
                wt = nearest_up_kernel(w3)
            got = upsample_conv(x, wt, s, d, pad=pad)
            err, rel = conv_err(got, upsample_conv_plain(x, wt, s, d, pad=pad), case,
                                " stride-2 mode")
            if not all(torch.equal(got, upsample_conv(x, wt, s, d, pad=pad)) for _ in range(3)):
                raise AssertionError(f"upsample_conv {case}: repeats differ")
            CHECKED.add(("upsample_conv", *case[:7], modulated, modulated, MODE_F32))
            worst = max(worst, err)
            xs = x if s is None else x * s[:, :, None, None]
            wt_t = wt.transpose(0, 1)

            def cudnn():
                if nearest:
                    return F.conv2d(F.interpolate(xs, scale_factor=2, mode="nearest"), w3,
                                    padding=1)
                return F.conv_transpose2d(xs, wt_t, stride=2, padding=pad)
            ho = 2 * h + k - 2 - 2 * pad
            nbytes = 4.0 * (b * c * h * w + co * c * k * k + b * co * ho * ho
                            + ((b * c + b * co) if modulated else 0))
            cache = LayerWeights(wt)     # as a layer keeps its split weight
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


def preview_bound(flop: float, act_elems: int, w_bytes: int, sd_elems: int,
                  mode: int) -> dict:
    """The least time of a bf16-datapath call: its FLOP over the dense bf16
    tensor-core peak, or its bytes over 3.35 TB/s, the activations (x and
    y) in the storage of ``mode``, the weight's ``w_bytes`` (both kernels
    read it as bf16), s and d in float32."""
    nbytes = (2 if mode == MODE_BF16 else 4) * act_elems + w_bytes + 4 * sd_elems
    t_flop, t_bytes = flop / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_flop, t_bytes),
            "bound_by": "operations" if t_flop >= t_bytes else "bytes",
            "bound_ffma_ms": max(flop / PEAK_FFMA * 1e3, t_bytes)}


def preview_case(gen: torch.Generator, kernel: str, case, mode: int,
                 nearest: bool = False) -> tuple[dict, str]:
    """One shape of a kernel's bf16 datapath (``mode``): against its plain
    version by the datapath's bar, three launches bit-identical, then the
    kernel, the plain version and cuDNN on bf16 tensors timed beside the
    bound.  ``nearest``: a stride-2 case on the composite kernel of a 3x3
    weight (BigGAN's and ProGAN's nearest-up convs)."""
    import torch.nn.functional as F
    from ganspace_tpu_torch.ops.modconv import (
        LayerWeights, conv3x3, conv3x3_plain, modconv3x3, modconv3x3_plain,
        nearest_up_kernel, upsample_conv, upsample_conv_plain)
    store = torch.bfloat16 if mode == MODE_BF16 else torch.float32
    bf = torch.bfloat16
    if kernel == "upsample_conv":
        b, c, co, h, w, k, pad, modulated = case
        x, wt, s, d = up_inputs(gen, case)
        x = x.to(store)
        xs = (x if s is None else x * s[:, :, None, None]).to(bf)
        if nearest:
            # BigGAN's and ProGAN's nearest 2x + 3x3 conv as the composite
            # kernel; cuDNN's call is the conv of the nearest-upsampled map
            w3 = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
            wt = nearest_up_kernel(w3)
            w3_b = w3.to(bf)
            library = lambda: F.conv2d(F.interpolate(xs, scale_factor=2, mode="nearest"),  # noqa: E731
                                       w3_b, padding=1)
        else:
            wt_t = wt.transpose(0, 1).to(bf)
            library = lambda: F.conv_transpose2d(xs, wt_t, stride=2, padding=pad)  # noqa: E731
        cache = LayerWeights(wt)
        fn = lambda: upsample_conv(x, wt, s, d, pad=pad, cache=cache)  # noqa: E731
        plain = lambda: upsample_conv_plain(x, wt, s, d, pad=pad)  # noqa: E731
        ho = 2 * h + k - 2 - 2 * pad
        bnd = preview_bound(up_flop(case), b * c * h * w + b * co * ho * ho,
                            2 * co * c * k * k, (b * c + b * co) if modulated else 0, mode)
        key = ("upsample_conv", *case[:7], modulated, modulated, mode)
        label = f"B={b} C={c} Co={co} {h}->{ho} px k={k}"
    else:
        b, c, co, h, w = case
        x, wt, s, d = conv_inputs(gen, case)
        x = x.to(store)
        wt_b = wt.to(bf)
        if kernel == "modconv3x3":
            fn = lambda: modconv3x3(x, wt, s, d)  # noqa: E731
            plain = lambda: modconv3x3_plain(x, wt, s, d)  # noqa: E731
            xs = (x * s[:, :, None, None]).to(bf)
            sd = b * c + b * co
        else:
            fn = lambda: conv3x3(x, wt)  # noqa: E731
            plain = lambda: conv3x3_plain(x, wt)  # noqa: E731
            xs, sd = x.to(bf), 0
        library = lambda: F.conv2d(xs, wt_b, padding=1)  # noqa: E731
        bnd = preview_bound(2.0 * b * h * w * co * 9 * c, b * c * h * w + b * co * h * w,
                            2 * co * 9 * c, sd, mode)
        key = (kernel, *case, kernel == "modconv3x3", mode)
        label = f"B={b} C={c} Co={co} {h}x{w}"
    with precision_for(mode):
        got = fn()
        err, rel = datapath_err(got, plain(), case, f" {kernel}", mode)
        if not all(torch.equal(got, fn()) for _ in range(2)):
            raise AssertionError(f"{kernel} {case} mode {mode}: repeats differ")
        CHECKED.add(key)
        row = timed(median_ms(fn), median_ms(plain), median_ms(library), bnd)
    row["max_abs_err"] = err
    line = (f"{kernel} bf16 datapath, {'bf16' if mode == MODE_BF16 else 'float32'} storage, "
            f"{label}: max|d| {err:.3e} (rel {rel:.3e}), 3 launches bit-identical; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cuDNN bf16 "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}),"
            f" share {row['bound_share']:.3f}")
    del x, got
    return row, line


def check_preview_kernels(gen: torch.Generator, gpu: str) -> dict:
    """Kernel B's modulated and plain modes and the stride-2 mode on the bf16
    datapath, in both storages, at the viewer's StyleGAN2 and StyleGAN
    render shapes, BigGAN-512's, ProGAN-256's and DCGAN-64's preview ones
    and the convs.2 tap shapes (preview_groups).  The JSON rows are the bf16 storage's (the
    viewer's policy); the float32 storage's stand beside them."""
    out = {}
    for kernel, groups in preview_groups().items():
        by_mode = {}
        for mode in (MODE_BF16, MODE_BF16_OPS):
            worst, res = 0.0, {}
            for group, cases in groups.items():
                rows = []
                for case in cases:
                    row, line = preview_case(gen, kernel, case, mode,
                                             group.startswith(NEAREST_UP_GROUPS))
                    rows.append(row)
                    worst = max(worst, row["max_abs_err"])
                    log(line)
                res[group] = t = sum_rows(rows)
                log(f"{kernel} bf16 datapath, {'bf16' if mode == MODE_BF16 else 'float32'} "
                    f"storage, {group} ({len(rows)} shapes): kernel {t['ms']:.4f} ms, plain "
                    f"{t['plain_ms']:.4f} ms, cuDNN bf16 {t['library_ms']:.4f} ms, bound "
                    f"{t['bound_ms']:.4f} ms ({t['bound_by']}), share "
                    f"{t['bound_share']:.3f} [{gpu}]")
            first = next(iter(groups))
            by_mode[mode] = {"max_abs_err": worst, **res[first], "groups": res}
        out[kernel] = {**by_mode[MODE_BF16], "float32_storage": by_mode[MODE_BF16_OPS]}
    return out


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

    def ganspace_modconv3x3(self, x, wt, s, dmod, y, b, c, h, w, co, mode, stream):
        self.seen.add(("modconv3x3" if s else "conv3x3", b, c, co, h, w, dmod is not None,
                       mode))
        return self.lib.ganspace_modconv3x3(x, wt, s, dmod, y, b, c, h, w, co, mode, stream)

    def ganspace_upsample_conv(self, x, wimg, s, dmod, y, tiling, b, c, h, w, co, k, pad,
                               mode, stream):
        self.seen.add(("upsample_conv", b, c, co, h, w, k, pad, s is not None,
                       dmod is not None, mode))
        return self.lib.ganspace_upsample_conv(x, wimg, s, dmod, y, tiling, b, c, h, w, co, k,
                                               pad, mode, stream)


def record_launches() -> LaunchRecorder:
    """Put a LaunchRecorder in front of the loaded library."""
    from ganspace_tpu_torch.ops import _build
    recorder = LaunchRecorder(_build.load_kernels())
    _build._loaded = recorder
    return recorder


def check_launched_shapes(recorder: LaunchRecorder, gen: torch.Generator) -> None:
    """Every shape the paths launched that the kernel checks did not cover
    (the fits' batch-1 probes, the vs-CPU forwards, ...), held against its
    plain version by the same bars, on the datapath it was launched on,
    two launches bit-identical."""
    left = sorted(recorder.seen - CHECKED, key=str)
    for key in left:
        kind, *shape = key
        mode = shape.pop() if kind != "centered_gram" else MODE_F32
        with precision_for(mode):
            got, again = check_launched_shape(gen, kind, shape, mode)
        if not torch.equal(got, again):
            raise AssertionError(f"{key}: two launches differ")
        CHECKED.add(key)
    log(f"launched shapes: {len(recorder.seen)} distinct over the run, all held against "
        f"their plain versions; {len(left)} of them here, beyond the kernel checks: "
        + "; ".join(f"{k[0]} {k[1:]}" for k in left))


def check_launched_shape(gen: torch.Generator, kind: str, shape: list, mode: int):
    """(got, again): one recorded launch shape against its plain version by
    its datapath's bar, launched twice."""
    from ganspace_tpu_torch.ops.modconv import (
        conv3x3, conv3x3_plain, modconv3x3, modconv3x3_plain, upsample_conv,
        upsample_conv_plain)
    from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
    store = torch.bfloat16 if mode == MODE_BF16 else torch.float32
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
        x, pad = x.to(store), case[6]
        got = upsample_conv(x, wt, s, d, pad=pad)
        datapath_err(got, upsample_conv_plain(x, wt, s, d, pad=pad), case,
                     " stride-2 mode", mode)
        again = upsample_conv(x, wt, s, d, pad=pad)
    else:
        x, wt, s, d = conv_inputs(gen, tuple(shape[:5]))
        x, d = x.to(store), (d if shape[5] else None)
        if kind == "conv3x3":
            got = conv3x3(x, wt)
            datapath_err(got, conv3x3_plain(x, wt), shape, " plain mode", mode)
            again = conv3x3(x, wt)
        else:
            got = modconv3x3(x, wt, s, d)
            datapath_err(got, modconv3x3_plain(x, wt, s, d), shape, "", mode)
            again = modconv3x3(x, wt, s, d)
    return got, again


def _wrappers() -> dict:
    from ganspace_tpu_torch.ops.modconv import conv3x3, modconv3x3, upsample_conv
    from ganspace_tpu_torch.ops.moments import centered_gram
    return {"centered_gram": centered_gram, "modconv3x3": modconv3x3,
            "conv3x3": conv3x3, "upsample_conv": upsample_conv}


#: kernel B's and the stride-2 kernel's counts of the bf16 datapath
BF16_COUNTS = ("modconv3x3", "conv3x3", "upsample_conv")


def reset_launches() -> None:
    for name, fn in _wrappers().items():
        fn.launches = 0
        if name in BF16_COUNTS:
            fn.launches_bf16 = 0


def read_launches() -> dict:
    """Every count: the float32 datapath's under the kernel's name, the bf16
    datapath's under ``<name>_bf16``."""
    wrappers = _wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    counts.update({f"{name}_bf16": wrappers[name].launches_bf16 for name in BF16_COUNTS})
    return counts


def expect_launches(launches: dict, what: str, **want) -> None:
    """Exact counts for the named kernels, none for the others."""
    want = {name: want.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {want}")


def expect_state(model, params: dict, what: str) -> None:
    """The model's weights are ``params``, key for key and bit for bit."""
    loaded = model.state_dict()
    if set(loaded) != set(params):
        raise AssertionError(f"{what}: the loaded keys differ from the file's")
    for k, v in params.items():
        if not torch.equal(loaded[k].cpu(), torch.from_numpy(v)):
            raise AssertionError(f"{what}: {k} differs from the file's")


def load_cache(path, c: int = 80, orthonormal: bool = True) -> tuple[dict, dict]:
    """(arrays, _meta) of a component cache, its keys, finiteness and
    ``act_comp`` rows checked: orthonormal, or unit rows where ``orthonormal``
    is False (ICA's and sparse PCA's components are no orthogonal basis)."""
    with np.load(path, allow_pickle=False) as data:
        if set(data.files) != NPZ_KEYS:
            raise AssertionError(f"npz keys {sorted(data.files)}")
        arrays = {k: data[k] for k in NPZ_KEYS - {"_meta"}}
        meta = json.loads(bytes(data["_meta"].item()).decode())
    for k, a in arrays.items():
        if not np.isfinite(a).all():
            raise AssertionError(f"npz {k} is not finite")
    comp = arrays["act_comp"].reshape(c, -1)
    gram = comp @ comp.T
    gram_err = float(np.abs(gram - np.eye(c)).max() if orthonormal
                     else np.abs(np.diag(gram) - 1.0).max())
    if gram_err > 1e-4:
        raise AssertionError(f"act_comp rows not {'orthonormal' if orthonormal else 'unit'}: "
                             f"{gram_err}")
    arrays["gram_err"] = gram_err
    return arrays, meta


def expect_meta(meta: dict, what: str, **want) -> None:
    got = {k: meta.get(k) for k in want}
    if got != want:
        raise AssertionError(f"{what}: _meta {got}, expected {want}")


@contextlib.contextmanager
def record_estimators():
    """The estimators ``decomposition`` builds in the region, in order (the
    fitted one is the last: the cache name builds one first).  Only the
    zero-tail gate needs one: the moments tier's count, mean and scatter,
    which the cache does not hold."""
    from ganspace_tpu_torch import decomposition
    made, real = [], decomposition.get_estimator

    def recording(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]
    decomposition.get_estimator = recording
    try:
        yield made
    finally:
        decomposition.get_estimator = real


def fit_only(inst, layer: str, n: int, seed: int = 0, estimator: str = "ipca",
             sparsity: float = 1.0, **env) -> dict:
    """``get_or_compute`` alone (no render) on ``inst``'s model, its launch
    counts, cache, wall seconds (device drained) and phase seconds; a
    full-batch fit prints its iterations, where it has them."""
    from ganspace_tpu_torch.config import Config
    from ganspace_tpu_torch.decomposition import get_or_compute
    use_w = inst.model.latent_space_name() == "W"
    config = Config(model=inst.model.model_name, output_class=inst.model.outclass, layer=layer,
                    estimator=estimator, components=80, n=n, use_w=use_w,
                    seed=seed or None, sparsity=sparsity, device="cuda")
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out, **env):
        phases = {}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        path = get_or_compute(config, inst, phases=phases)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        arrays, meta = load_cache(path, orthonormal=estimator not in ("ica", "spca"))
    return {"launches": launches, "arrays": arrays, "meta": meta,
            "seconds": seconds, "phases": phases}


def fmt_phases(phases: dict) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())


def run_main_path(gpu: str, out: str) -> tuple[dict, dict]:
    """The W CLI run in the default environment, its output under ``out``
    (the viewer phase reuses its cache): (its launch counts, its npz
    arrays)."""
    from ganspace_tpu_torch.apps import visualize

    with environ(GANSPACE_OUTPUT_DIR=out):
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
    """The W fit alone at n = 1M on the fused W stream, and its fitted
    estimator (for ``with_zero_tail``)."""
    with record_estimators() as made:
        run = fit_only(inst, "style", W_N_1M)
    run["estimator"] = made[-1]
    log(f"W fit at n = {W_N_1M}: launches {run['launches']}")
    expect_launches(run["launches"], "W fit at 1M", centered_gram=N_W_1M_BLOCKS)
    expect_meta(run["meta"], "W fit at 1M", device_rng=True)
    n_total = W_N_1M // 4096 * 4096
    log(f"W fit at n = {W_N_1M} (n_total {n_total}): {run['seconds']:.3f} s, "
        f"{W_N_1M / run['seconds']:.1f} samples/s; phases: "
        f"{fmt_phases(run['phases'])} [{gpu}]")
    return run


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


def check_w_stream_gate(gpu: str, inst, device_arrays: dict) -> dict:
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
    return runs


def with_zero_tail(moments, nb: int, c: int = 80) -> dict:
    """The exact PCA that the full-batch path computes, from the moments
    tier's statistics (count n, mean mu, scatter M2) of a stream: its matrix
    holds nb more rows, left zero, which its mean and scatter count (over
    N = n + nb rows: M2 + (n nb / N) mu mu^T), so a rank-1 term along the
    mean joins the covariance.  Components, stdev and var_ratio as the
    full-batch PCA reports them (population variances over N rows)."""
    n = moments.count
    big = n + nb
    mu = moments.mean.double()
    cov = (moments.m2.double() + (n * nb / big) * torch.outer(mu, mu)) / big
    evals, evecs = torch.linalg.eigh(cov)
    evals, evecs = torch.clamp(torch.flip(evals, (0,)), min=0.0), torch.flip(evecs, (1,))
    return {"act_comp": evecs[:, :c].T.float().cpu().numpy(),
            "act_stdev": torch.sqrt(evals[:c]).float().cpu().numpy(),
            "var_ratio": (evals[:c] / evals.sum()).float().cpu().numpy()}


def run_pca_cli(gpu: str, recorder, moments_1m: dict, host: dict) -> dict:
    """The full-batch path end to end: ``visualize --est pca`` at W and
    n = 1M, the whole sample matrix collected on the card and fitted at
    once, kernel A launched once over all its rows, then the grids.  Its
    components are gated against the moments-tier W fit at n = 1M
    (``moments_1m``, the fused stream) with the zero tail of the
    full-batch matrix put in (``with_zero_tail``): two exact PCAs of one
    distribution from other streams, judged by the host seed-1-vs-7
    control of ``host``.  The same measure against the moments tier's own
    cache, without the tail, is printed beside it."""
    from ganspace_tpu_torch.apps import visualize

    seen, recorder.seen = recorder.seen, set()
    try:
        with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
            reset_launches()
            result = visualize.main(list(PCA_ARGS))
            launches = read_launches()
            summ = Path(out, "out", "StyleGAN2-ffhq", "style", "pca", "summ")
            grids = sorted(p.name for p in summ.glob("*.jpg"))
            arrays, meta = load_cache(result.cache)
    finally:
        run_seen, recorder.seen = recorder.seen, seen | recorder.seen
    log(f"W PCA CLI launches: {launches}")
    expect_launches(launches, "W PCA CLI", centered_gram=1, modconv3x3=N_CONV_LAUNCHES,
                    upsample_conv=N_UP_LAUNCHES)
    gram_shapes = sorted(k[1:] for k in run_seen if k[0] == "centered_gram")
    if gram_shapes != [(W_FULL_ROWS, 512)]:
        raise AssertionError(f"W PCA CLI: kernel A at {gram_shapes}, expected "
                             f"[({W_FULL_ROWS}, 512)]")
    if result.cache.name != f"stylegan2-ffhq_style_pca-full_c80_n{W_N_1M}_w.npz":
        raise AssertionError(f"W PCA CLI cache {result.cache.name}")
    if arrays["act_comp"].reshape(80, -1).shape != (80, 512):
        raise AssertionError(f"act_comp shape {arrays['act_comp'].shape}")
    if not (np.diff(arrays["var_ratio"]) <= 1e-7).all():
        raise AssertionError("var_ratio is not descending")
    expect_meta(meta, "W PCA CLI", device_rng=True, fused_linreg=False, refine_skipped=None)
    expected = (["components_W.jpg", "random_dirs_W.jpg"]
                + [f"samp{i}_real_W.jpg" for i in range(10)])
    if grids != sorted(expected):
        raise AssertionError(f"W PCA CLI summ grids {grids}")
    log(f"W PCA CLI (n = {W_N_1M}, kernel A once at {W_FULL_ROWS} x 512): fit "
        f"{result.fit_seconds:.3f} s, {W_N_1M / result.fit_seconds:.1f} samples/s; phases: "
        f"{fmt_phases(result.phases)}; render {result.images} images in "
        f"{result.render_seconds:.3f} s, {result.images / result.render_seconds:.2f} "
        f"images/s; |C C^T - I| = {arrays['gram_err']:.2e}; {len(grids)} grids [{gpu}]")
    control = (host[0]["arrays"], host[7]["arrays"])
    _, untailed, _, untailed_ratios = stream_gate((moments_1m["arrays"], arrays), control,
                                                  moments_1m["arrays"]["act_stdev"])
    log(f"W PCA vs the moments tier's cache, no zero tail (printed, not gated): "
        + ", ".join(f"{k} {v:.3e}" for k, v in untailed.items()) + "; ratios "
        + ", ".join(f"{k} {v:.3f}" for k, v in untailed_ratios.items()))
    tailed = with_zero_tail(moments_1m["estimator"]._moments, W_BATCH)
    cuts, err, ctrl_err, ratios = stream_gate((tailed, arrays), control, tailed["act_stdev"])
    log(f"W PCA gate (n = {W_N_1M}, {len(cuts)} cuts at a relative gap >= {GATE_GAP}: "
        f"{cuts}): PCA vs the moments tier with the zero tail "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f"; host seed 1 vs 7 at n = {W_N} "
        + ", ".join(f"{k} {v:.3e}" for k, v in ctrl_err.items())
        + "; ratios " + ", ".join(f"{k} {v:.3f} (bar {GATE_RATIOS[k]})"
                                  for k, v in ratios.items()) + f" [{gpu}]")
    bad = [k for k, v in ratios.items() if not v <= GATE_RATIOS[k]]
    if bad:
        raise AssertionError(f"W PCA: misses the control's bar on {bad}")
    return launches


def run_w_full_batch_fit(gpu: str, inst, estimator: str) -> dict:
    """ICA (kernel A once, for its whitening) or sparse PCA (no kernel A)
    over the whole W matrix at n = 1M: unit rows, descending stdevs."""
    run = fit_only(inst, "style", W_N_1M, estimator=estimator, sparsity=SPCA_SPARSITY)
    what = f"W {estimator} fit at n = {W_N_1M}"
    expect_launches(run["launches"], what, centered_gram=int(estimator == "ica"))
    expect_meta(run["meta"], what, device_rng=True, fused_linreg=False)
    comp, stdev = run["arrays"]["act_comp"].reshape(80, -1), run["arrays"]["act_stdev"]
    if comp.shape != (80, 512) or not (np.diff(stdev) <= 1e-6).all():
        raise AssertionError(f"{what}: components {comp.shape} or stdevs not descending")
    detail = ("FastICA's iterations on the fit's 'Done in' line above" if estimator == "ica"
              else f"sparsity {SPCA_SPARSITY}: {float(np.mean(comp == 0)):.4f} of the "
                   f"entries zero")
    log(f"{what}: {run['seconds']:.3f} s; {detail}; unit rows to {run['arrays']['gram_err']:.2e}, "
        f"stdevs descending; launches {run['launches']}; phases: "
        f"{fmt_phases(run['phases'])} [{gpu}]")
    return run["launches"]


def run_conv_fbpca_fit(gpu: str, inst, sketch_host: dict) -> dict:
    """fbpca at ``convs.2`` and n = 20000 on the host stream: the
    collecting sweep (kernel B's modulated mode and the stride-2 mode in
    every tap forward) into an [n_total + nb, 131072] matrix on the card,
    the randomized SVD, then the ``linreg_lstsq`` sweep.  Its components
    beside the sketch tier's fit of the same stream (``sketch_host``):
    printed, not gated."""
    run = fit_only(inst, "convs.2", CONV_N, estimator="fbpca", GANSPACE_DEVICE_RNG=0)
    what = f"conv-tap fbpca fit at n = {CONV_N}, host RNG"
    expect_meta(run["meta"], what, device_rng=False, fused_linreg=False, refine_skipped=None)
    shape = dict(refined=False, fused_blocks=0, cli=False)
    expect_launches(run["launches"], what, modconv3x3=conv_tap_launches(**shape),
                    upsample_conv=conv_tap_launches(**shape, per_tap=UP_PER_TAP_FORWARD,
                                                    per_full=UP_PER_FORWARD))
    a = run["arrays"]["act_comp"].reshape(80, -1).astype(np.float64)
    b = sketch_host["act_comp"].reshape(80, -1)
    cos = np.abs(np.sum(a * b, axis=1))
    captured = float(run["arrays"]["var_ratio"].sum() / sketch_host["var_ratio"].sum())
    log(f"{what}: {run['seconds']:.3f} s, {CONV_N / run['seconds']:.1f} samples/s; "
        f"launches {run['launches']}; phases: {fmt_phases(run['phases'])} [{gpu}]")
    log(f"{what} beside the sketch tier's fit of the same stream (printed, not gated): "
        f"min |cos| {cos.min():.6f}, median |cos| {np.median(cos):.6f}, captured variance "
        f"(sum of var_ratio) {run['arrays']['var_ratio'].sum():.6f} against "
        f"{sketch_host['var_ratio'].sum():.6f}, ratio {captured:.6f}")
    return run["launches"]


def fit_on(name: str, x: torch.Tensor, device: str):
    """(the estimator ``name`` fitted on ``x`` moved to ``device``, seconds)."""
    from ganspace_tpu_torch.estimators import get_estimator
    est = get_estimator(name, 80, SPCA_SPARSITY, device=device)
    t0 = time.perf_counter()
    est.fit(x.to(device))
    torch.cuda.synchronize()
    return est, time.perf_counter() - t0


def compare_fits(a, b) -> tuple[float, float]:
    """(min rank-by-rank |cos|, max relative stdev difference) of two fits."""
    cos = np.abs(np.sum(a.components_.astype(np.float64) * b.components_, axis=1))
    return float(cos.min()), float(np.abs(a.stdev / b.stdev - 1.0).max())


def check_estimators_vs_cpu(gpu: str, names: tuple, make_x, **want) -> dict:
    """The estimators ``names`` fitted on the card and on the CPU (the plain
    versions) from one centered matrix ``make_x()``: rank-by-rank |cos| and
    stdevs against their bars.  ``want``: the phase's kernel launches."""
    reset_launches()
    x = make_x()
    failed = []
    for name in names:
        (card, card_s), (cpu, cpu_s) = fit_on(name, x, "cuda"), fit_on(name, x, "cpu")
        cos, rel = compare_fits(card, cpu)
        line = (f"{name} on {tuple(x.shape)}, card vs CPU: min |cos| rank by rank {cos:.7f}, "
                f"stdev rel {rel:.3e}")
        if name == "ica":
            line += f", {card.n_iter_} / {cpu.n_iter_} iterations"
        line += f" (bars {VS_CPU_COS}, {VS_CPU_STDEV_REL:.0e})"
        if not (cos > VS_CPU_COS and rel < VS_CPU_STDEV_REL):
            failed.append(name)
        log(line + f"; card {card_s:.3f} s, CPU {cpu_s:.3f} s [{gpu}]")
    launches = read_launches()
    expect_launches(launches, "estimators card vs CPU", **want)
    if failed:
        raise AssertionError(f"{failed}: card and CPU disagree")
    return launches


def planted_sources(rows: int, d: int = 512, c: int = 80, seed: int = 0) -> torch.Tensor:
    """``rows`` samples of c Laplace sources mixed into d dimensions by a
    Gaussian matrix, centered, on the card: an ICA problem with one answer,
    which near-Gaussian W latents of random weights are not."""
    rs = np.random.RandomState(seed)
    s = torch.from_numpy(rs.laplace(size=(rows, c)).astype(np.float32)).cuda()
    x = s @ torch.from_numpy(rs.standard_normal((c, d)).astype(np.float32)).cuda()
    return x - x.mean(dim=0, keepdim=True)


def w_matrix(model, rows: int) -> torch.Tensor:
    """The first ``rows`` W latents of the pre-sampled device stream (the
    full-batch W path's blocks), centered."""
    from ganspace_tpu_torch.sampling import SEED_SAMPLING
    x = torch.cat(model.sample_latents_device(rows // W_BATCH, W_BATCH, SEED_SAMPLING))
    x = x.reshape(rows, -1)
    return x - x.mean(dim=0, keepdim=True)


def tap_matrix(inst, rows: int) -> torch.Tensor:
    """``rows`` convs.2 activations, ``CONV_BATCH`` host latents a tap
    forward, centered."""
    model, chunks = inst.model, []
    model.seed_host_rng(0)
    for _ in range(rows // CONV_BATCH):
        model.partial_forward(model.sample_latent(CONV_BATCH), "convs.2")
        chunks.append(inst.retained_features()["convs.2"].reshape(CONV_BATCH, -1))
    x = torch.cat(chunks)
    return x - x.mean(dim=0, keepdim=True)


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


def check_fit_repeats(what: str, first: dict, again: dict) -> None:
    """A fused fit run twice: every array of the two caches equal bit for
    bit (every kernel of the tap forward sums in a fixed order)."""
    same = {k: np.array_equal(first["arrays"][k], again["arrays"][k])
            for k in NPZ_KEYS - {"_meta"}}
    log(f"{what}, run twice: caches bit for bit "
        f"{all(same.values())} ({', '.join(k for k, v in sorted(same.items()) if v)})")
    if not all(same.values()):
        raise AssertionError(f"{what}: the two fits differ in "
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


class TruncationRecorder:
    """Wraps BigGAN's device draw (``models/biggan.device_truncated``) over a
    region: the largest |z| of every draw, kept on the card, and the number
    of latents drawn, against the bound 2 * truncation."""

    def __enter__(self):
        from ganspace_tpu_torch.models import biggan
        self.module, self.draw = biggan, biggan.device_truncated
        self.max, self.count, self.limit = None, 0, None

        def recording(gen, n, dim, truncation):
            z = self.draw(gen, n, dim, truncation)
            m = z.abs().max()
            self.max = m if self.max is None else torch.maximum(self.max, m)
            self.count += n
            self.limit = 2.0 * truncation
            return z
        biggan.device_truncated = recording
        return self

    def __exit__(self, *exc):
        self.module.device_truncated = self.draw
        return False

    def check(self, what: str) -> str:
        if not self.count:
            raise AssertionError(f"{what}: no latent was drawn on the device")
        top = float(self.max)
        if not top <= self.limit:
            raise AssertionError(f"{what}: a device latent at {top} > {self.limit}")
        return f"{self.count} device latents, max |z| {top:.6f} <= {self.limit}"


def bg_counts(upto: int | None = None, preview: bool = False,
              resolution: int = 512) -> tuple[int, int]:
    """(plain 3x3, stride-2) launches of one BigGAN forward (512 px unless
    ``resolution`` names another)."""
    plain, up = bg_shapes(1, upto, preview, resolution)
    return len(plain), len(up)


def run_biggan_cli(gpu: str) -> tuple[dict, dict]:
    """``visualize --model BigGAN-512 --class husky --layer generator.gen_z
    --est ipca -c 80 -n 1000000 -b 10000``: the fused activation stream of
    truncated device latents (100 blocks of 10000) into the sketch tier, the
    regression and the random moments riding it; then 24 grids of 14 strips
    at 512 px through kernel B's plain and stride-2 modes."""
    from ganspace_tpu_torch.apps import visualize
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out), \
            TruncationRecorder() as drawn:
        reset_launches()
        result = visualize.main(list(BG_ARGS))
        launches = read_launches()
        log(f"BigGAN CLI launches: {launches}")
        plain, up = bg_counts()
        expect_launches(launches, "BigGAN CLI", conv3x3=plain * BG_STRIPS,
                        upsample_conv=up * BG_STRIPS)
        bound = drawn.check("BigGAN CLI")
        arrays, meta = load_cache(result.cache)
        if arrays["act_comp"].shape != (80, 1, BG_TAP_D) or arrays["lat_comp"].shape != (80, 1, 128):
            raise AssertionError(f"BigGAN cache shapes {arrays['act_comp'].shape}, "
                                 f"{arrays['lat_comp'].shape}")
        expect_meta(meta, "BigGAN CLI", device_rng=True, fused_linreg=True)
        lat = arrays["lat_comp"].reshape(80, -1)
        if np.abs(np.linalg.norm(lat, axis=1) - 1.0).max() > 1e-5:
            raise AssertionError("BigGAN lat_comp rows are not unit rows")
        grids = check_grids(Path(out, "out", "BigGAN-512-husky-t1.0", "generator.gen_z",
                                 "ipca", "summ"), 512, "BigGAN CLI")
        log(f"BigGAN npz ok: act_comp (80, 1, {BG_TAP_D}), |C C^T - I| = "
            f"{arrays['gram_err']:.2e}, unit lat_comp rows; _meta {json.dumps(meta)}; "
            f"{grids}; {bound}")
    log(f"BigGAN CLI fit (n = {BG_N}, b = {BG_BATCH}): {result.fit_seconds:.3f} s, "
        f"{BG_N / result.fit_seconds:.1f} samples/s; phases: {fmt_phases(result.phases)} "
        f"[{gpu}]")
    log(f"BigGAN render: {result.images} images at 512 px in {result.render_seconds:.3f} s, "
        f"{result.images / result.render_seconds:.2f} images/s [{gpu}]")
    return launches, arrays


def check_flat_gate(gpu: str, what: str, device: dict, host: dict, ctrl: dict) -> None:
    """The device stream's components against the host stream's, judged by
    the host seed-1-vs-7 control, where seeded random weights give a nearly
    flat spectrum (BigGAN's gen_z, ProGAN's layer2): the principal-angle
    cuts exist only where it has a relative gap of GATE_GAP, so the gate
    always holds ``median_cos`` and ``var_ratio`` to GATE_RATIOS and
    ``stdev``, the largest relative difference of ``act_stdev``, to
    STDEV_BAR, and the cuts where there are any."""
    def errors(a, b):
        ca, cb = a["act_comp"].reshape(80, -1), b["act_comp"].reshape(80, -1)
        cos = np.abs(np.sum(ca.astype(np.float64) * cb, axis=1))
        return {"median_cos": float(np.median(1.0 - cos)),
                "var_ratio": float(np.abs(a["var_ratio"] - b["var_ratio"]).max()),
                "stdev": float(np.abs(a["act_stdev"] / b["act_stdev"] - 1.0).max())}
    err, ctrl_err = errors(host, device), errors(host, ctrl)
    bars = {**GATE_RATIOS, "stdev": STDEV_BAR}
    ratios = {k: err[k] / max(ctrl_err[k], 1e-12) for k in err}
    try:
        cuts, cut_err, cut_ctrl, cut_ratios = stream_gate((host, device), (host, ctrl),
                                                          host["act_stdev"])
        ratios.update({k: cut_ratios[k] for k in ("cut_mean", "cut_max")})
        err.update({k: cut_err[k] for k in ("cut_mean", "cut_max")})
        ctrl_err.update({k: cut_ctrl[k] for k in ("cut_mean", "cut_max")})
        cut_note = f"{len(cuts)} cuts at a relative gap >= {GATE_GAP}: {cuts}"
    except AssertionError:
        cut_note = f"no relative gap >= {GATE_GAP} in the host spectrum: no cut"
    top = host["act_stdev"][0] ** 2
    log(f"{what} gate (c = 80, {cut_note}; host spectrum lambda_80 / lambda_1 = "
        f"{host['act_stdev'][-1] ** 2 / top:.4f}): device vs host "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + "; host seed 1 vs 7 " + ", ".join(f"{k} {v:.3e}" for k, v in ctrl_err.items())
        + "; ratios " + ", ".join(f"{k} {v:.3f} (bar {bars[k]})" for k, v in ratios.items())
        + f" [{gpu}]")
    bad = [k for k, v in ratios.items() if not v <= bars[k]]
    if bad:
        raise AssertionError(f"{what}: the device stream misses the control's bar on {bad}")


def check_biggan_stream_gate(gpu: str, inst) -> dict:
    """The host-RNG gen_z fit under seeds 1 and 7 and the default
    environment's device fit (the fused stream of truncated device latents)
    at n = 40960: the device components against the host's, judged by the
    host seed-1-vs-7 control (:func:`check_flat_gate`: with seeded random
    weights gen_z's spectrum is nearly flat, the singular values of a random
    [32768, 128] map, and the truncation sets the activations' scale, which
    the directions cannot show).  Returns the runs' launches."""
    runs = {}
    for seed in (0, 7):
        run = fit_only(inst, "generator.gen_z", BG_GATE_N, seed=seed, GANSPACE_DEVICE_RNG=0)
        expect_launches(run["launches"], "BigGAN host gen_z fit")
        expect_meta(run["meta"], "BigGAN host gen_z fit", device_rng=False)
        log(f"BigGAN host-RNG gen_z fit, seed {seed or 1}: {run['seconds']:.3f} s, "
            f"{BG_GATE_N / run['seconds']:.1f} samples/s; phases: "
            f"{fmt_phases(run['phases'])} [{gpu}]")
        runs[seed] = run
    with TruncationRecorder() as drawn:
        dev = fit_only(inst, "generator.gen_z", BG_GATE_N)
    expect_launches(dev["launches"], "BigGAN device gen_z fit")
    expect_meta(dev["meta"], "BigGAN device gen_z fit", device_rng=True, fused_linreg=True)
    bound = drawn.check("BigGAN device gen_z fit")
    log(f"BigGAN device gen_z fit: {dev['seconds']:.3f} s, {BG_GATE_N / dev['seconds']:.1f} "
        f"samples/s; {bound}; phases: {fmt_phases(dev['phases'])} [{gpu}]")
    check_flat_gate(gpu, f"BigGAN gen_z (n = {BG_GATE_N})", dev["arrays"], runs[0]["arrays"],
                    runs[7]["arrays"])
    return {"bg_gate_host": runs[0]["launches"], "bg_gate_host_seed7": runs[7]["launches"],
            "bg_gate_device": dev["launches"]}


def run_biggan_tap_fit(gpu: str, inst) -> dict:
    """``generator.layers.1`` (D = 131072) at n = 20000 on the fused stream
    forced below its threshold: 156 blocks of 128, each a tap forward through
    block 0 (two plain-mode convs) and block 1 (the stride-2 up-conv and one
    plain-mode conv), into the sketch tier with its refine pass when the
    policy keeps it."""
    with TruncationRecorder() as drawn:
        run = fit_only(inst, BG_TAP, BG_TAP_N, GANSPACE_FUSED_ACTS=1)
    meta = run["meta"]
    expect_meta(meta, "BigGAN layers.1 fit", device_rng=True, fused_linreg=True)
    forwards = 1 + BG_TAP_BLOCKS * (1 + (not meta["refine_skipped"]))
    plain, up = bg_counts(upto=1)
    expect_launches(run["launches"], "BigGAN layers.1 fit", conv3x3=plain * forwards,
                    upsample_conv=up * forwards)
    if run["arrays"]["act_comp"].shape != (80, 1, 2048, 8, 8):
        raise AssertionError(f"act_comp shape {run['arrays']['act_comp'].shape}")
    log(f"BigGAN {BG_TAP} fit at n = {BG_TAP_N} (fused, {BG_TAP_BLOCKS} blocks of "
        f"{BG_TAP_BATCH}): {run['seconds']:.3f} s, {BG_TAP_N / run['seconds']:.1f} samples/s; "
        f"launches {run['launches']}; refine_skipped {meta['refine_skipped']}; "
        f"{drawn.check('BigGAN layers.1 fit')}; phases: {fmt_phases(run['phases'])} [{gpu}]")
    return run["launches"]


def check_biggan_checkpoint(gpu: str) -> dict:
    """A full-width BigGAN-deep-512 checkpoint in the HuggingFace format,
    written from a seeded init (CKPT_SEED) into a temporary
    ``$GANCONTROL_CHECKPOINT_DIR``: every conv and linear but the class
    embedding as ``weight_orig`` (twice the init, so sigma != 1) with
    ``weight_u`` and ``weight_v`` from one power-iteration step.  The model
    ``get_instrumented_model`` builds on the card holds the baked weights
    (``weight_orig / u^T W v``, computed here in numpy), and its images equal
    bit for bit those of a model built in memory from them."""
    from ganspace_tpu_torch.models import get_instrumented_model, get_model
    from ganspace_tpu_torch.models.biggan import BigGANConfig, init_params
    params = init_params(BigGANConfig.for_resolution(512), seed=CKPT_SEED)
    rs = np.random.RandomState(CKPT_SEED)
    state, expected = {}, {}
    for k, v in params.items():
        if not k.endswith(".weight") or k == "embeddings.weight" or k.startswith("generator.bn."):
            state[k] = torch.from_numpy(v)
            expected[k] = v
            continue
        base = k[:-len(".weight")]
        w_orig = 2.0 * v
        w_mat = w_orig.reshape(w_orig.shape[0], -1)
        vv = w_mat.T @ rs.randn(w_mat.shape[0]).astype(np.float32)
        vv /= np.linalg.norm(vv)
        u = w_mat @ vv
        u /= np.linalg.norm(u)
        state.update({f"{base}.weight_orig": torch.from_numpy(w_orig),
                      f"{base}.weight_u": torch.from_numpy(u),
                      f"{base}.weight_v": torch.from_numpy(vv)})
        expected[k] = (w_orig / float(u @ w_mat @ vv)).astype(np.float32)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        Path(root, "biggan-deep-512").mkdir()
        path = Path(root, "biggan-deep-512", "pytorch_model.bin")
        torch.save(state, path)
        mib = path.stat().st_size / 2 ** 20
        with environ(GANCONTROL_CHECKPOINT_DIR=root):
            torch.cuda.synchronize()
            reset_launches()
            inst = get_instrumented_model("BigGAN-512", "husky", "generator.gen_z",
                                          torch.device("cuda"))
    load_s = time.perf_counter() - t0
    del state
    model = inst.model
    expect_state(model, expected, "BigGAN checkpoint")
    if np.array_equal(expected["generator.gen_z.weight"], params["generator.gen_z.weight"]):
        raise AssertionError("BigGAN checkpoint: sigma is 1, the bake is not exercised")
    ref = get_model("BigGAN-512", "husky", torch.device("cuda"), params=expected)
    z = model.sample_latent(CKPT_BATCH, seed=3)
    img, want = model.forward(z), ref.forward(z)
    launches = read_launches()
    if not (torch.isfinite(img).all() and img.shape == (CKPT_BATCH, 3, 512, 512)):
        raise AssertionError(f"BigGAN checkpoint: image {tuple(img.shape)} or non-finite")
    if not torch.equal(img, want):
        raise AssertionError("BigGAN checkpoint: images differ from the in-memory model's")
    plain, up = bg_counts()
    expect_launches(launches, "BigGAN checkpoint", conv3x3=2 * plain, upsample_conv=2 * up)
    log(f"BigGAN checkpoint: a {mib:.1f} MiB HuggingFace .bin at full 512-px width (seed "
        f"{CKPT_SEED}, sigma != 1) loaded through get_instrumented_model in {load_s:.2f} s: "
        f"every weight equal to its bake; {CKPT_BATCH} images equal bit for bit to the "
        f"in-memory model's; launches {launches} [{gpu}]")
    del inst, model, ref
    return launches


def check_biggan_vs_cpu() -> None:
    """Two 512-px BigGAN images, then a batch of 16 to ``generator.gen_z`` and
    to ``generator.layers.1``, on the card (kernels) and on the CPU (plain
    versions), the same seeded weights and host latents."""
    from ganspace_tpu_torch.models.base import InstrumentedModel
    from ganspace_tpu_torch.models.biggan import BigGAN, BigGANConfig, init_params
    params = init_params(BigGANConfig.for_resolution(512), seed=0)
    models = [BigGAN(512, "husky", params=params, device=d) for d in ("cuda", "cpu")]
    z = models[1].sample_latent(2, seed=7)
    t0 = time.perf_counter()
    ref = models[1].forward(z)
    cpu_s = time.perf_counter() - t0
    img = models[0].forward(z.cuda()).cpu()
    if not (torch.isfinite(img).all() and img.shape == (2, 3, 512, 512)):
        raise AssertionError(f"BigGAN image shape {tuple(img.shape)} or non-finite")
    rel = float((2 * img - 2 * ref).abs().max() / (2 * ref - 1).abs().max())
    log(f"BigGAN 512 px images, card vs CPU: rel {rel:.3e} (bar {TAP_REL:.0e}); the CPU "
        f"forward of 2 took {cpu_s:.2f} s")
    if not rel < TAP_REL:
        raise AssertionError("card and CPU disagree on the BigGAN 512 px image")
    z = models[1].sample_latent(16, seed=8)
    for tap in ("generator.gen_z", BG_TAP):
        acts = []
        for model in models:
            inst = InstrumentedModel(model)
            inst.retain_layer(tap)
            model.partial_forward(z.to(model.device), tap)
            acts.append(inst.retained_features()[tap].cpu())
        tap_rel = float((acts[0] - acts[1]).abs().max() / acts[1].abs().max())
        log(f"BigGAN {tap} activation {tuple(acts[1].shape)}, card vs CPU: rel "
            f"{tap_rel:.3e} (bar {TAP_REL:.0e})")
        if not tap_rel < TAP_REL:
            raise AssertionError(f"card and CPU disagree on the BigGAN {tap} activation")


def check_progan_checkpoint(gpu: str) -> dict:
    """A full-width ProGAN-256 checkpoint in GANDissect's naming (the flat
    ``layerN.conv.weight`` / ``layerN.wscale.b`` state dict), written from a
    seeded init (CKPT_SEED) as ``progan/bedroom_lsun.pth`` in a temporary
    ``$GANCONTROL_CHECKPOINT_DIR``: the model ``get_instrumented_model``
    builds on the card reads its channel schedule off the file, holds its
    weights, and its images equal bit for bit those of the model built from
    the params in memory.  Returns its launches."""
    from ganspace_tpu_torch.models import get_instrumented_model, get_model
    from ganspace_tpu_torch.models.proggan import ProGANConfig, init_params
    params = init_params(ProGANConfig.for_resolution(256), seed=CKPT_SEED)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        Path(root, "progan").mkdir()
        path = Path(root, "progan", "bedroom_lsun.pth")
        torch.save({k: torch.from_numpy(v) for k, v in params.items()}, path)
        mib = path.stat().st_size / 2 ** 20
        with environ(GANCONTROL_CHECKPOINT_DIR=root):
            torch.cuda.synchronize()
            reset_launches()
            inst = get_instrumented_model("ProGAN", "bedroom", "layer2", torch.device("cuda"))
    load_s = time.perf_counter() - t0
    model = inst.model
    if model.cfg != ProGANConfig.for_resolution(256):
        raise AssertionError(f"ProGAN checkpoint: schedule {model.cfg.sizes} read off the file")
    expect_state(model, params, "ProGAN checkpoint")
    ref = get_model("ProGAN", "bedroom", torch.device("cuda"), params=params)
    z = model.sample_latent(CKPT_BATCH, seed=3)
    img, want = model.forward(z), ref.forward(z)
    launches = read_launches()
    if not (torch.isfinite(img).all() and img.shape == (CKPT_BATCH, 3, 256, 256)):
        raise AssertionError(f"ProGAN checkpoint: image {tuple(img.shape)} or non-finite")
    if not torch.equal(img, want):
        raise AssertionError("ProGAN checkpoint: images differ from the in-memory model's")
    plain, up = pg_counts()
    # the shape annotation's layer2 tap forward, then two full forwards
    expect_launches(launches, "ProGAN checkpoint", conv3x3=1 + 2 * plain, upsample_conv=2 * up)
    log(f"ProGAN checkpoint: a {mib:.1f} MiB GANDissect .pth at full 256-px width (seed "
        f"{CKPT_SEED}) loaded through get_instrumented_model in {load_s:.2f} s: the schedule "
        f"{model.cfg.sizes} and every weight as in the file; {CKPT_BATCH} images equal bit "
        f"for bit to the in-memory model's; launches {launches} [{gpu}]")
    return launches


def zoo_state(params: dict, n_up: int) -> dict:
    """``params`` in a pytorch_GAN_zoo GNet's naming (``formatLayer``,
    ``main.batchNormI``, ``main.convTransposeI``, ``main.outlayer``; its
    transposed convs have no bias), in execution order."""
    def bn(i):
        return {f"main.batchNorm{i}.{leaf}": torch.from_numpy(params[f"bn{i}.{leaf}"])
                for leaf in ("weight", "bias", "running_mean", "running_var")} | {
                f"main.batchNorm{i}.num_batches_tracked": torch.tensor(0)}
    state = {"formatLayer.weight": torch.from_numpy(params["deconv0.weight"]), **bn(0)}
    for i in range(1, n_up):
        state[f"main.convTranspose{i}.weight"] = torch.from_numpy(params[f"deconv{i}.weight"])
        state.update(bn(i))
    state["main.outlayer.weight"] = torch.from_numpy(params[f"deconv{n_up}.weight"])
    return state


def check_dcgan_checkpoint(gpu: str) -> dict:
    """A full-width DCGAN checkpoint in the pytorch_GAN_zoo hub format
    (``{'config', 'netG', 'netD'}``, the zoo's module names), written from
    a seeded init with trained-like batch-norm statistics as
    ``ganzoo/DCGAN.pth`` in a temporary ``$GANCONTROL_CHECKPOINT_DIR``: the
    model built on the card reads its configuration off the file, holds
    its weights, and its images equal bit for bit those of the model built
    from the params in memory.  Returns its launches."""
    from ganspace_tpu_torch.models import get_instrumented_model, get_model
    from ganspace_tpu_torch.models.dcgan import DCGANConfig, init_params
    cfg = DCGANConfig()
    params = init_params(cfg, seed=CKPT_SEED)
    rs = np.random.RandomState(CKPT_SEED)
    for k, v in params.items():
        if k.startswith("bn"):
            v = v + 0.2 * rs.randn(*v.shape).astype(np.float32)
            params[k] = (np.abs(v) + 0.5 if k.endswith("running_var") else v).astype(np.float32)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        Path(root, "ganzoo").mkdir()
        path = Path(root, "ganzoo", "DCGAN.pth")
        torch.save({"config": {"dimLatentVector": cfg.z_total},
                    "netG": zoo_state(params, cfg.n_up), "netD": {}}, path)
        mib = path.stat().st_size / 2 ** 20
        with environ(GANCONTROL_CHECKPOINT_DIR=root):
            torch.cuda.synchronize()
            reset_launches()
            inst = get_instrumented_model("DCGAN", None, "deconv1", torch.device("cuda"))
    load_s = time.perf_counter() - t0
    model = inst.model
    if model.cfg != cfg:
        raise AssertionError(f"DCGAN checkpoint: configuration {model.cfg} read off the file")
    expect_state(model, params, "DCGAN checkpoint")
    ref = get_model("DCGAN", None, torch.device("cuda"), params=params)
    z = model.sample_latent(CKPT_BATCH, seed=3)
    img, want = model.forward(z), ref.forward(z)
    launches = read_launches()
    if not (torch.isfinite(img).all() and img.shape == (CKPT_BATCH, 3, 64, 64)):
        raise AssertionError(f"DCGAN checkpoint: image {tuple(img.shape)} or non-finite")
    if not torch.equal(img, want):
        raise AssertionError("DCGAN checkpoint: images differ from the in-memory model's")
    # the shape annotation (a full forward: the reference's partial_forward), two more
    expect_launches(launches, "DCGAN checkpoint", upsample_conv=3 * len(dc_shapes(1)))
    log(f"DCGAN checkpoint: a {mib:.1f} MiB pytorch_GAN_zoo .pth at full 64-px width (seed "
        f"{CKPT_SEED}) loaded through get_instrumented_model in {load_s:.2f} s: the "
        f"configuration and every weight as in the file; {CKPT_BATCH} images equal bit for "
        f"bit to the in-memory model's; launches {launches} [{gpu}]")
    return launches


def check_grids(summ: Path, res: int, what: str) -> str:
    """The CLI's 24 activation- and latent-mode grids of 14 strips of 5
    frames at ``res`` px (white bars of res / 64 px between the frames),
    and the lightbox page."""
    from PIL import Image
    grids = sorted(p.name for p in summ.glob("*.jpg"))
    names = ["components", "random_dirs"] + [f"samp{i}_real" for i in range(10)]
    if grids != sorted(f"{n}_{m}.jpg" for n in names for m in ("ACT", "Z")):
        raise AssertionError(f"{what} summ grids {grids}")
    with Image.open(summ / "components_Z.jpg") as grid:
        size = grid.size
    if size != (5 * res + 4 * (res // 64), 14 * res) or not (summ / "+lightbox.html").is_file():
        raise AssertionError(f"{what}: a grid of {size} or no lightbox page")
    return f"{len(grids)} grids of {size[0]} x {size[1]} px and the lightbox page"


def run_progan_cli(gpu: str) -> tuple[dict, dict]:
    """``visualize --model ProGAN --class bedroom --layer layer2 --est ipca -c
    80`` at the default n = 300000: the fused activation stream (146 blocks
    of 2048, each a tap forward through kernel B's plain mode) into the
    moments tier, kernel A once per block at [2048, 8192], the regression
    and the random moments riding it; then 24 grids of 14 strips at 256 px,
    each forward seven plain-mode and six stride-2 launches."""
    from ganspace_tpu_torch.apps import visualize
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        reset_launches()
        result = visualize.main(list(PG_ARGS))
        launches = read_launches()
        log(f"ProGAN CLI launches: {launches}")
        plain, up = pg_counts()
        # the shape annotation, the probe, the fit's blocks and the
        # activation-mode strips' centering: one layer2 tap forward each
        tap_forwards = 2 + PG_BLOCKS + PG_STRIPS // 2
        expect_launches(launches, "ProGAN CLI", centered_gram=PG_BLOCKS,
                        conv3x3=tap_forwards + plain * PG_STRIPS, upsample_conv=up * PG_STRIPS)
        arrays, meta = load_cache(result.cache)
        if arrays["act_comp"].shape != (80, 1, 512, 4, 4):
            raise AssertionError(f"ProGAN act_comp shape {arrays['act_comp'].shape}")
        expect_meta(meta, "ProGAN CLI", device_rng=True, fused_linreg=True, refine_skipped=None)
        for k in ("act_stdev", "var_ratio", "lat_stdev", "random_stdevs"):
            if arrays[k].shape != (80,) or not (arrays[k] > 0).all():
                raise AssertionError(f"ProGAN {k}: not 80 positive values")
        grids = check_grids(Path(out, "out", "ProGAN-bedroom", "layer2", "ipca", "summ"), 256,
                            "ProGAN CLI")
        log(f"ProGAN npz ok: act_comp (80, 1, 512, 4, 4), |C C^T - I| = "
            f"{arrays['gram_err']:.2e}, the moments tier, the regression and baselines riding "
            f"the stream; {grids}")
    log(f"ProGAN CLI fit (n = {PG_N}): {result.fit_seconds:.3f} s, "
        f"{PG_N / result.fit_seconds:.1f} samples/s; phases: {fmt_phases(result.phases)} "
        f"[{gpu}]")
    log(f"ProGAN render: {result.images} images at 256 px in {result.render_seconds:.3f} s, "
        f"{result.images / result.render_seconds:.2f} images/s [{gpu}]")
    return launches, arrays


def check_progan_stream_gate(gpu: str, inst, device_arrays: dict) -> dict:
    """The host-RNG layer2 fits under seeds 1 and 7 at the CLI's n, then the
    CLI's device stream against the host stream, judged by the host
    seed-1-vs-7 control (:func:`check_flat_gate`: layer2's spectrum on
    seeded random weights has no relative gap of GATE_GAP).  Each host fit:
    146 blocks of one tap forward and one kernel-A launch, then the
    regression sweep's 146 tap forwards.  Returns the runs' launches."""
    runs = {}
    for seed in (0, 7):
        run = fit_only(inst, "layer2", PG_N, seed=seed, GANSPACE_DEVICE_RNG=0)
        expect_launches(run["launches"], "ProGAN host layer2 fit", centered_gram=PG_BLOCKS,
                        conv3x3=1 + 2 * PG_BLOCKS)
        expect_meta(run["meta"], "ProGAN host layer2 fit", device_rng=False)
        log(f"ProGAN host-RNG layer2 fit, seed {seed or 1}: {run['seconds']:.3f} s, "
            f"{PG_N / run['seconds']:.1f} samples/s; phases: {fmt_phases(run['phases'])} "
            f"[{gpu}]")
        runs[seed] = run
    check_flat_gate(gpu, f"ProGAN layer2 (n = {PG_N})", device_arrays, runs[0]["arrays"],
                    runs[7]["arrays"])
    return {"pg_gate_host": runs[0]["launches"], "pg_gate_host_seed7": runs[7]["launches"]}


def run_progan_tap_fits(gpu: str, inst) -> tuple[dict, dict]:
    """``layer6`` (16 px, D = 131072) at n = 20000 on the fused stream
    forced below its threshold (156 blocks of 128, each a tap forward of
    three plain-mode and two stride-2 launches) into the sketch tier, with
    its refine pass when the policy keeps it; twice, the caches equal bit
    for bit."""
    runs = []
    for _ in range(2):
        run = fit_only(inst, PG_TAP, PG_TAP_N, GANSPACE_FUSED_ACTS=1)
        meta = run["meta"]
        expect_meta(meta, "ProGAN layer6 fit", device_rng=True, fused_linreg=True)
        if meta["refine_skipped"] not in (True, False):
            raise AssertionError(f"ProGAN layer6 fit: _meta {meta}, no sketch-tier decision")
        forwards = 1 + PG_TAP_BLOCKS * (1 + (not meta["refine_skipped"]))
        plain, up = pg_counts(PG_TAP)
        expect_launches(run["launches"], "ProGAN layer6 fit", conv3x3=plain * forwards,
                        upsample_conv=up * forwards)
        if run["arrays"]["act_comp"].shape != (80, 1, 512, 16, 16):
            raise AssertionError(f"act_comp shape {run['arrays']['act_comp'].shape}")
        log(f"ProGAN {PG_TAP} fit at n = {PG_TAP_N} (fused, {PG_TAP_BLOCKS} blocks of "
            f"{PG_TAP_BATCH}): {run['seconds']:.3f} s, {PG_TAP_N / run['seconds']:.1f} "
            f"samples/s; launches {run['launches']}; refine_skipped {meta['refine_skipped']}; "
            f"phases: {fmt_phases(run['phases'])} [{gpu}]")
        runs.append(run)
    check_fit_repeats(f"ProGAN {PG_TAP} fit at n = {PG_TAP_N}", *runs)
    return runs[0]["launches"], runs[1]["launches"], runs[0]["arrays"]


def run_dcgan_cli(gpu: str) -> dict:
    """``visualize --model DCGAN --layer deconv1 --est ipca -c 80`` at the
    default n = 300000: the fused activation stream (292 blocks of 1024,
    each a tap forward through the stride-2 kernel at k = 4) into the
    sketch tier with its refine pass when the policy keeps it; then 24
    grids at 64 px.  DCGAN's partial_forward is a full forward (four
    stride-2 launches, the last to three channels), as the reference's."""
    from ganspace_tpu_torch.apps import visualize
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        reset_launches()
        result = visualize.main(list(DC_ARGS))
        launches = read_launches()
        log(f"DCGAN CLI launches: {launches}")
        arrays, meta = load_cache(result.cache)
        expect_meta(meta, "DCGAN CLI", device_rng=True, fused_linreg=True)
        if meta["refine_skipped"] not in (True, False):
            raise AssertionError(f"DCGAN CLI: _meta {meta}, no sketch-tier decision")
        # the fit's tap forwards (deconv1: one launch); the full forwards of
        # the shape annotation, the probe, the activation-mode strips'
        # centering and every strip
        tap_forwards = DC_BLOCKS * (1 + (not meta["refine_skipped"]))
        full_forwards = 2 + DC_STRIPS // 2 + DC_STRIPS
        expect_launches(launches, "DCGAN CLI",
                        upsample_conv=tap_forwards + len(dc_shapes(1)) * full_forwards)
        if arrays["act_comp"].shape != (80, 1, 256, 8, 8):
            raise AssertionError(f"DCGAN act_comp shape {arrays['act_comp'].shape}")
        grids = check_grids(Path(out, "out", "DCGAN", "deconv1", "ipca", "summ"), 64,
                            "DCGAN CLI")
        log(f"DCGAN npz ok: act_comp (80, 1, 256, 8, 8), |C C^T - I| = "
            f"{arrays['gram_err']:.2e}; _meta {json.dumps(meta)}; {grids}")
    log(f"DCGAN CLI fit (n = {DC_N}): {result.fit_seconds:.3f} s, "
        f"{DC_N / result.fit_seconds:.1f} samples/s; phases: {fmt_phases(result.phases)} "
        f"[{gpu}]")
    log(f"DCGAN render: {result.images} images at 64 px in {result.render_seconds:.3f} s, "
        f"{result.images / result.render_seconds:.2f} images/s [{gpu}]")
    return launches


def check_progan_dcgan_vs_cpu() -> None:
    """ProGAN-256 and the DCGAN at full width, two images each on the card
    (kernels) and on the CPU (plain versions), the same seeded weights and
    host latents: the image and every tap."""
    from ganspace_tpu_torch.models.base import InstrumentedModel
    from ganspace_tpu_torch.models.dcgan import DCGANConfig, GANZooModel
    from ganspace_tpu_torch.models.dcgan import init_params as dc_init
    from ganspace_tpu_torch.models.proggan import ProGAN, ProGANConfig
    from ganspace_tpu_torch.models.proggan import init_params as pg_init
    pg = pg_init(ProGANConfig.for_resolution(256), seed=0)
    dc = dc_init(DCGANConfig(), seed=0)
    for what, build in (("ProGAN-256", lambda d: ProGAN("bedroom", params=pg, device=d)),
                        ("DCGAN", lambda d: GANZooModel(params=dc, device=d))):
        outs = []
        for device in ("cuda", "cpu"):
            model = build(device)
            inst = InstrumentedModel(model)
            inst.retain_layers(model.tap_names())
            img = model.forward(model.sample_latent(2, seed=7))
            outs.append({"image": 2 * img.cpu() - 1,
                         **{t: inst.retained_features()[t].cpu() for t in model.tap_names()}})
        rels = {k: float((outs[0][k] - ref).abs().max() / ref.abs().max())
                for k, ref in outs[1].items()}
        log(f"{what} image {tuple(outs[1]['image'].shape)} and {len(rels) - 1} taps, card vs "
            f"CPU: max rel {max(rels.values()):.3e} at {max(rels, key=rels.get)} (bar "
            f"{TAP_REL:.0e}); " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
        if not (all(torch.isfinite(t).all() for t in outs[0].values())
                and max(rels.values()) < TAP_REL):
            raise AssertionError(f"card and CPU disagree on {what}")


# -- the figure scripts and makesample (ganspace_tpu_torch/notebooks, tools) --

# Each figure through its main, at its defaults but for the arguments
# given: (module, arguments, forwards, frames, kernel-A fits, [(PNG, rows,
# frames a row)]).  A forward renders one strip of 5 frames, or one frame
# in the teaser's chains and the BigGAN grids.  The StyleGAN2 figures (W,
# --layer style, -n 2048) share one cache per c: c = 8 is fitted by the
# teaser, first_20_pcs's by itself, each one block of 2048 W rows through
# kernel A.  first_20_pcs is cut from 20 rows (c = 20) to FIRST_PCS_ROWS
# for the phase's time, which the grids' PNG encoding holds (PIL, one
# thread): at 20 rows the figure took 45 s of the phase's 155 s, at 10 rows
# 23 s of 136 s (PERF.md §6).  The BigGAN-128 figures (husky,
# generator.gen_z, -n 512, c = 8) fit gen_z (D = 32768) on the sketch tier,
# no kernel there; style resampling keeps 1, 5 and 10 of the 11 latent
# slots (3 rows of 4 frames).
FIRST_PCS_ROWS = 5
FIG_SG2 = [
    ("figure_teaser", [], 8, 8, 1, [("teaser.png", 2, 4)]),
    ("figure_pca_cleanup", [], 10, 50, 0, [("pca_cleanup_global.png", 6, 5),
                                           ("pca_cleanup_tuned.png", 4, 5)]),
    ("figure_style_content_sep", [], 6, 30, 0, [("style_content_sep.png", 3, 5),
                                                 ("random_baseline.png", 3, 5)]),
    ("figure_supervised_comp", [], 6, 30, 0, [("supervised_comp.png", 6, 5)]),
    ("figure_first_20_pcs", ["-c", str(FIRST_PCS_ROWS)], FIRST_PCS_ROWS,
     5 * FIRST_PCS_ROWS, 1, [("first_20_pcs.png", FIRST_PCS_ROWS, 5)]),
    ("figure_edit_zoo", [], 3, 15, 0, [("edit_zoo.png", 3, 5)]),
]
FIG_BG_RES = 128
FIG_BG = [
    ("figure_biggan_style_resampling", [], 12, 12, 0, [("biggan_style_resampling.png", 3, 4)]),
    ("figure_biggan_style_mixing", [], 12, 12, 0, [("biggan_style_mixing.png", 4, 3)]),
    ("figure_biggan_edit_transferability", [], 3, 15, 0,
     [("biggan_edit_transferability.png", 3, 5)]),
]
# makesample at 1024 px: 16 StyleGAN2-FFHQ images in batches of 8
SAMPLE_MODEL, SAMPLE_CLASS, SAMPLE_RES = "StyleGAN2", "ffhq", 1024
SAMPLE_SIZE, SAMPLE_BATCH = 16, 8
SAMPLE_ARGS = ["--model", SAMPLE_MODEL, "--class", SAMPLE_CLASS, "--size", str(SAMPLE_SIZE),
               "--batch", str(SAMPLE_BATCH)]


def run_figure(gpu: str, spec: tuple, res: int, outdir: str, want) -> dict:
    """One figure's ``main`` on the card: its launches held to
    ``want(forwards, fits)``, each PNG decoded and its shape checked (rows
    of frames with white bars of res / 64 px between them); its seconds
    split into ``setup`` (the model and its components), the grids (frames
    to uint8, padding, PNG) and the render between them."""
    import importlib

    from PIL import Image
    name, argv, forwards, frames, fits, pngs = spec
    mod = importlib.import_module(f"ganspace_tpu_torch.notebooks.{name}")
    split = {"setup": 0.0, "grid": 0.0}

    def timed_call(fn, key):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                split[key] += time.perf_counter() - t
        return call

    own = mod.setup, mod.save_figure_grid
    mod.setup, mod.save_figure_grid = timed_call(own[0], "setup"), timed_call(own[1], "grid")
    reset_launches()
    t0 = time.perf_counter()
    try:
        mod.main(["--outdir", outdir, *argv])
        torch.cuda.synchronize()
    finally:
        mod.setup, mod.save_figure_grid = own
    seconds = time.perf_counter() - t0
    launches = read_launches()
    expect_launches(launches, name, **want(forwards, fits))
    sizes = []
    for png, rows, per_row in pngs:
        with Image.open(Path(outdir, png)) as im:
            shape = np.asarray(im).shape
        expected = (rows * res, per_row * res + (per_row - 1) * (res // 64), 3)
        if shape != expected:
            raise AssertionError(f"{name}: {png} is {shape}, expected {expected}")
        sizes.append(f"{png} {shape[1]} x {shape[0]}")
    render = seconds - split["setup"] - split["grid"]
    log(f"{' '.join([name, *argv])}: {seconds:.3f} s (setup {split['setup']:.3f}, render "
        f"{render:.3f}, grids {split['grid']:.3f}), {frames} frames at {res} px in {forwards} "
        f"forwards, {frames / seconds:.2f} frames/s ({frames / render:.2f} in the render); "
        f"launches {launches}; {', '.join(sizes)} [{gpu}]")
    return launches


def check_figures_vs_cpu(outdir: str) -> None:
    """The teaser's first chain (its 4 frames) and one BigGAN style-mixing
    cell (content seed 1, style seed 41) on the card and on the CPU, built
    by the figures' own setup on the same weights and the same cache; the
    PCA illustration's axes (no generator, no kernel: the figure itself
    needs matplotlib, which the phase does without) the same way."""
    from ganspace_tpu_torch.notebooks import figure_biggan_style_mixing as mixing
    from ganspace_tpu_torch.notebooks import figure_pca_illustration as illustration
    from ganspace_tpu_torch.notebooks import figure_teaser as teaser
    from ganspace_tpu_torch.notebooks.notebook_init import parse_args, setup
    out = {}
    for device in ("cuda", "cpu"):
        argv = ["--outdir", outdir, "--device", device]
        ns = setup(parse_args(argv, model="StyleGAN2", layer="style", components=8))
        chain = teaser.perform_edit_chain(ns, 5, teaser.chain_edits(8))
        ns = setup(parse_args(argv, model="BigGAN-128", output_class="husky",
                              layer="generator.gen_z", components=8, n=512), use_w=False)
        cell = ns.model.sample_np(mixing.mixed_latents(ns.model, mixing.CONTENT_SEEDS[0],
                                                       mixing.STYLE_SEEDS[0]))
        out[device] = (np.stack(chain), cell)
        del ns
    for what, got, ref in (("teaser chain (4 frames, 1024 px)", out["cuda"][0], out["cpu"][0]),
                           ("BigGAN-128 style-mixing cell", out["cuda"][1], out["cpu"][1])):
        rel = float(np.abs(2 * got - 2 * ref).max() / np.abs(2 * ref - 1).max())
        log(f"{what}, card vs CPU: rel {rel:.3e} (bar {IMAGE_REL:.0e})")
        if not (got.shape == ref.shape and np.isfinite(got).all() and rel < IMAGE_REL):
            raise AssertionError(f"card and CPU disagree on the {what}")
    pts = illustration.point_cloud(0)
    (comp, stdev), (ref_comp, ref_stdev) = (illustration.principal_axes(pts, d)
                                            for d in ("cuda", "cpu"))
    cos = np.abs(np.sum(comp * ref_comp, axis=1)).min()
    stdev_rel = float(np.abs(stdev / ref_stdev - 1).max())
    log(f"PCA illustration axes, card vs CPU: min |cos| {cos:.9f}, stdev rel "
        f"{stdev_rel:.2e}")
    if not (cos > 1 - 1e-6 and stdev_rel < 1e-5):
        raise AssertionError("card and CPU disagree on the PCA illustration's axes")


def run_makesample(gpu: str, outdir: str) -> None:
    """``python -m ganspace_tpu_torch makesample`` in a process of its own:
    its 16 PNGs decode bit for bit to the card's ``sample_np(uint8=True)``
    of the same seeds and batches; prints which writer ran."""
    from PIL import Image

    from ganspace_tpu_torch.models import get_model
    cmd = [sys.executable, "-m", "ganspace_tpu_torch", "makesample", *SAMPLE_ARGS,
           "--outdir", outdir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"makesample exited {proc.returncode}: {proc.stderr[-2000:]}")
    writer = [line for line in proc.stdout.splitlines() if line.startswith("writer:")]
    model = get_model(SAMPLE_MODEL, SAMPLE_CLASS, device="cuda")
    for start in range(0, SAMPLE_SIZE, SAMPLE_BATCH):
        ref = model.sample_np(model.sample_latent(SAMPLE_BATCH, seed=1 + start), uint8=True)
        for i in range(SAMPLE_BATCH):
            with Image.open(Path(outdir, f"image_{start + i:05d}.png")) as im:
                got = np.asarray(im)
            if got.shape != (SAMPLE_RES, SAMPLE_RES, 3) or not np.array_equal(got, ref[i]):
                raise AssertionError(f"makesample image {start + i} differs from sample_np")
    if not Path(outdir, "+lightbox.html").is_file():
        raise AssertionError("makesample wrote no lightbox page")
    log(f"makesample: {SAMPLE_SIZE} images at {SAMPLE_RES} px bit for bit the card's sample_np, "
        f"{writer[0] if writer else 'no writer line'}; the process took {seconds:.2f} s, "
        f"start-up included [{gpu}]")


def run_figures(gpu: str) -> dict:
    """The six StyleGAN2-FFHQ-1024 figures and the three BigGAN-128 ones at
    full width in one GANSPACE_OUTPUT_DIR, then the vs-CPU checks and
    makesample: the launch counts by figure."""
    from ganspace_tpu_torch.ops.precision import ieee_f32
    plain, up = bg_counts(resolution=FIG_BG_RES)

    def sg2(forwards, fits):
        return dict(centered_gram=fits, modconv3x3=B_PER_FORWARD * forwards,
                    upsample_conv=UP_PER_FORWARD * forwards)

    def bg(forwards, fits):
        return dict(centered_gram=fits, conv3x3=plain * forwards, upsample_conv=up * forwards)

    launches = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        figs = str(Path(out, "figures"))
        for specs, res, want in ((FIG_SG2, 1024, sg2), (FIG_BG, FIG_BG_RES, bg)):
            for spec in specs:
                path = "fig_" + spec[0].removeprefix("figure_")
                launches[path] = run_figure(gpu, spec, res, figs, want)
        log(f"figures wall time: {time.perf_counter() - t0:.1f} s [{gpu}]")
        with ieee_f32():
            check_figures_vs_cpu(figs)
        run_makesample(gpu, str(Path(out, "samples")))
    log(f"figure phase wall time: {time.perf_counter() - t0:.1f} s [{gpu}]")
    return launches


# -- the preview policy: --dtype bfloat16, the bf16 first pass, the viewer ---

def run_bf16_cli(gpu: str, f32_arrays: dict) -> dict:
    """``visualize ... --layer convs.2 -n 50000 --dtype bfloat16``: the fit at
    the preview precision (kernel B and the stride-2 kernel on the bf16
    datapath, float32 storage), the _bf16 cache and its 80 cosine bounds
    with the grade they imply; the render after it runs at full precision.
    Its components beside the float32 CLI's of this run (reported, not
    gated: random weights give a flat spectrum)."""
    from ganspace_tpu_torch import decomposition
    from ganspace_tpu_torch.apps import visualize

    def no_sweep(*args, **kwargs):
        raise AssertionError("the regression sweep ran on the fused stream")
    sweep = decomposition.regression
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        decomposition.regression = no_sweep
        try:
            reset_launches()
            result = visualize.main(list(CONV_ARGS) + ["--dtype", "bfloat16"])
            launches = read_launches()
        finally:
            decomposition.regression = sweep
        if not result.cache.name.endswith("_bf16.npz"):
            raise AssertionError(f"--dtype bfloat16 cache {result.cache.name}: no _bf16 tag")
        arrays, meta = load_cache(result.cache)
    expect_meta(meta, "--dtype bfloat16 CLI", dtype="bfloat16", device_rng=True,
                fused_linreg=True, bf16_pass1=False)
    bounds = meta.get("bf16_cos_bounds")
    if not bounds or len(bounds) != 80 or meta["bf16_analysis_grade"] != (min(bounds) >= 0.99):
        raise AssertionError(f"--dtype bfloat16 CLI: bounds {bounds} and grade "
                             f"{meta.get('bf16_analysis_grade')} disagree")
    shape = dict(refined=not meta["refine_skipped"], fused_blocks=CONV50_BLOCKS)
    fit_b = conv_tap_launches(cli=False, **shape)
    fit_up = conv_tap_launches(cli=False, per_tap=UP_PER_TAP_FORWARD,
                               per_full=UP_PER_FORWARD, **shape)
    expect_launches(launches, "--dtype bfloat16 CLI",
                    modconv3x3_bf16=fit_b,
                    modconv3x3=conv_tap_launches(cli=True, **shape) - fit_b,
                    upsample_conv_bf16=fit_up,
                    upsample_conv=conv_tap_launches(cli=True, per_tap=UP_PER_TAP_FORWARD,
                                                    per_full=UP_PER_FORWARD, **shape) - fit_up)
    cos = _min_abs_cos(*(torch.from_numpy(a["act_comp"].reshape(80, -1))
                         for a in (arrays, f32_arrays)))
    n_low = sum(b < 0.99 for b in bounds)
    log(f"--dtype bfloat16 CLI: {result.cache.name}; refine_skipped {meta['refine_skipped']}; "
        f"bounds min {min(bounds):.6f} median {float(np.median(bounds)):.6f}, {n_low}/80 "
        f"below 0.99, analysis grade {meta['bf16_analysis_grade']}; min |cos| against the "
        f"float32 CLI's components {cos:.6f} (not gated); fit {result.fit_seconds:.3f} s "
        f"({CONV50_N / result.fit_seconds:.1f} samples/s) against the float32 CLI's in "
        f"this run; phases: {fmt_phases(result.phases)}; launches {launches} [{gpu}]")
    return launches


def run_bf16_pass1(gpu: str, inst) -> dict:
    """The float32 convs.2 fit at n = 20000 on the fused stream, twice, with
    the registry in a temporary directory: run 1 is all float32 and records
    that the policy refines; run 2 takes the bf16 first pass (bf16 storage,
    kernel B and the stride-2 kernel in their bf16 mode), its float32 refine
    pass determining the estimate, within 0.99 per-component |cos| of run 1
    (the bar of tests/test_bf16_pass1.py:121)."""
    from ganspace_tpu_torch import decomposition
    with tempfile.TemporaryDirectory() as reg, environ(GANSPACE_COMPILE_CACHE=reg):
        runs = [fit_only(inst, "convs.2", CONV_N, GANSPACE_DEVICE_RNG=1, GANSPACE_FUSED_ACTS=1)
                for _ in range(2)]
        recorded = json.loads(decomposition._fused_acts_registry().read_text())
    first, second = (r["meta"] for r in runs)
    expect_meta(first, "bf16 first pass, run 1", bf16_pass1=False, refine_skipped=False)
    expect_meta(second, "bf16 first pass, run 2", bf16_pass1=True, refine_skipped=False,
                bf16_pass1_aborted=False, dtype="float32")
    if list(recorded.values()) != [{"policy_refines": True}]:
        raise AssertionError(f"registry {recorded}")
    b, up = B_PER_TAP_FORWARD, UP_PER_TAP_FORWARD
    expect_launches(runs[1]["launches"], "bf16 first pass, run 2",
                    modconv3x3_bf16=b * CONV20_FUSED_BLOCKS,
                    modconv3x3=b * (1 + CONV20_FUSED_BLOCKS),
                    upsample_conv_bf16=up * CONV20_FUSED_BLOCKS,
                    upsample_conv=up * (1 + CONV20_FUSED_BLOCKS))
    cos = _min_abs_cos(*(torch.from_numpy(r["arrays"]["act_comp"].reshape(80, -1))
                         for r in runs))
    log(f"bf16 first pass at convs.2, n = {CONV_N}: run 1 (float32) "
        f"{runs[0]['seconds']:.3f} s, run 2 (bf16 first pass) {runs[1]['seconds']:.3f} s; "
        f"min |cos| of run 2 against run 1 {cos:.6f} (bar 0.99); phases run 1: "
        f"{fmt_phases(runs[0]['phases'])}; run 2: {fmt_phases(runs[1]['phases'])} [{gpu}]")
    if not cos >= 0.99:
        raise AssertionError(f"bf16 first pass: min |cos| {cos} < 0.99")
    return runs[1]["launches"]


def frame_levels(a: np.ndarray, b: np.ndarray) -> tuple[float, int]:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return float(d.mean()), int(d.max())


def http_round_trip(session) -> None:
    """The viewer's server on an ephemeral port: the page, a JPEG frame,
    a resample and a state POST, every request with a timeout."""
    import threading
    import urllib.request
    from ganspace_tpu_torch.apps.interactive import make_server
    server = make_server(session, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=120) as r:
                return r.read()
        if b"ganspace-tpu" not in get("/"):
            raise AssertionError("viewer page")
        if get("/frame.jpg")[:2] != b"\xff\xd8":
            raise AssertionError("viewer frame is no JPEG")
        if get("/resample?seed=7") != b"ok" or session.state.seed != 7:
            raise AssertionError("viewer resample")
        req = urllib.request.Request(base + "/state", method="POST",
                                     data=json.dumps({"sliders": [1.5], "mode": "latent"}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            if r.read() != b"ok":
                raise AssertionError("viewer state POST")
        if get("/frame.jpg")[:2] != b"\xff\xd8":
            raise AssertionError("viewer frame after the POST is no JPEG")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    session.sliders[:] = 0.0


def viewer_policy(dtype):
    """The viewer process's policy for ``--dtype`` (apply_preview_precision),
    restored on exit."""
    from ganspace_tpu_torch.apps.interactive import apply_preview_precision
    from ganspace_tpu_torch.ops import precision

    @contextlib.contextmanager
    def scope():
        old = precision.get_precision(), precision.get_synth_dtype()
        apply_preview_precision(type("Args", (), {"dtype": dtype})())
        try:
            yield
        finally:
            precision.set_precision(old[0])
            precision.set_synth_dtype(old[1])
    return scope()


def drive_viewer(gpu: str, session, what: str, per_forward: dict, family: str,
                 per_forward_preview: dict | None = None) -> dict:
    """One viewer Session in the preview policy and in float32: the warmup
    (five frames), ``time_frame`` and ``time_frame_speculative``, a latent,
    an activation and a layer-window edit, a profile of one frame's
    synthesis, the HTTP endpoints (preview), and the preview frame against
    the float32 frame of the same state, held to PREVIEW_ERR_RATIO times
    the JAX package's figure for ``family`` (PREVIEW_JAX_MEAN_LEVELS).
    Kernel B's launches of the warmup and of ``time_frame`` are counted
    exactly: ``per_forward`` of them per forward under ``--dtype float32``,
    ``per_forward_preview`` (default: the same) on the bf16 datapath in
    preview."""
    out, frames, launches = {}, {}, {}
    n_lat = session.model.get_max_latents()
    window = (n_lat // 4, max(n_lat // 2, 1))      # a layer window (the whole of one latent)
    for name, dtype in (("preview", None), ("float32", "float32")):
        bf16 = dtype is None
        counts = per_forward_preview if bf16 and per_forward_preview else per_forward
        with viewer_policy(dtype):
            session.sliders[:] = 0.0
            session.mode = "latent"
            reset_launches()
            t0 = time.perf_counter()
            session.warmup()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            synth, read, total = session.time_frame(iters=11)
            counted = read_launches()
            forwards = 5 + 1 + 2 * 11          # the warmup, time_frame's warm render and iterations
            want = {(f"{k}_bf16" if bf16 else k): v * forwards for k, v in counts.items()}
            expect_launches(counted, f"{what} viewer ({name}): warmup and time_frame", **want)
            spec = session.time_frame_speculative(iters=9)
            base = session.render(force=True).copy()
            edits = {}
            for mode, lats, slider in (("latent", (0, n_lat), 0), ("activation", (0, n_lat), 1),
                                       ("latent", window, 2)):
                v = np.zeros(session.n_sliders, np.float32)
                v[slider] = 2.0
                session.mode = mode
                edits[(mode, lats, slider)] = session._compute_frame(v, *lats)
            session.mode = "latent"
            frames[name] = (base, edits)
            profile_run(gpu, f"{what} viewer synthesis, {name}",
                        lambda: session.model.forward(session.state.z))
            launches[name] = read_launches()
            wrong = [k for k, n in launches[name].items()
                     if n and k in BF16_COUNTS and bf16]
            wrong += [k for k, n in launches[name].items()
                      if n and k.endswith("_bf16") and not bf16]
            if wrong:
                raise AssertionError(f"{what} viewer ({name}): launches on the other "
                                     f"datapath: {wrong} {launches[name]}")
        changed = {f"{m} {w}": frame_levels(f, base)[1] > 0 for (m, w, _), f in edits.items()}
        out[name] = dict(warmup_s=warm, synth_ms=synth, readback_ms=read, total_ms=total,
                         speculative_ms=spec, edits_change_frame=changed)
        log(f"{what} viewer, {name}: warmup {warm:.3f} s; frame median of 11: synthesis "
            f"{synth:.3f} ms, readback {read:.3f} ms, render {total:.3f} ms; speculative hit "
            f"{spec:.4f} ms; edits change the frame: {changed}; launches {launches[name]} "
            f"[{gpu}]")
        if not changed[f"latent {(0, n_lat)}"] or not changed[f"latent {window}"]:
            raise AssertionError(f"{what} viewer ({name}): a latent edit left the frame as it was")
    with viewer_policy(None):
        reset_launches()
        http_round_trip(session)          # it resamples: after the frames compared
        counted = read_launches()
    wrong = [k for k, n in counted.items() if n and k in BF16_COUNTS]
    if wrong or not any(n for k, n in counted.items() if k.endswith("_bf16")):
        raise AssertionError(f"{what} viewer HTTP: launches {counted}")
    launches["preview_http"] = counted
    (pre, pre_edits), (f32, f32_edits) = frames["preview"], frames["float32"]
    levels = [frame_levels(pre, f32)] + [frame_levels(pre_edits[k], f32_edits[k])
                                         for k in pre_edits]
    mean = float(np.mean([m for m, _ in levels]))
    worst = max(x for _, x in levels)
    ratio = mean / PREVIEW_JAX_MEAN_LEVELS[family]
    out.update(preview_vs_f32_mean_levels=mean, preview_vs_f32_max_levels=worst,
               preview_error_ratio=ratio, launches=launches)
    log(f"{what} viewer: the preview frame against the float32 frame of the same state, "
        f"over the base frame and the three edits: mean |d| {mean:.4f} levels, max {worst} "
        f"levels; {ratio:.3f}x the JAX package's figure on a small {family} "
        f"({PREVIEW_JAX_MEAN_LEVELS[family]} levels; bar {PREVIEW_ERR_RATIO}x) [{gpu}]")
    if not 0 < mean or ratio > PREVIEW_ERR_RATIO:
        raise AssertionError(f"{what} viewer: preview error {mean} levels, ratio {ratio}")
    return out


def run_viewer(gpu: str, w_out: str) -> tuple[dict, dict]:
    """``python -m ganspace_tpu_torch interactive --model StyleGAN2 --class
    ffhq --layer style --use_w`` at full FFHQ-1024 width, its Session on the
    W CLI's cache of this run (``-n 40960``, no fit: no kernel-A launch),
    driven in both precisions; then StyleGAN-FFHQ-1024's viewer at
    ``g_mapping`` (its fit at n = 4096), whose frames run kernel B's plain
    mode and the fused stride-2 convs."""
    from ganspace_tpu_torch.apps.interactive import Session
    from ganspace_tpu_torch.config import Config
    launches, results = {}, {}
    with environ(GANSPACE_OUTPUT_DIR=w_out):
        with viewer_policy(None):
            reset_launches()
            t0 = time.perf_counter()
            session = Session(Config().from_args(list(MAIN_ARGS)))
            built = time.perf_counter() - t0
            expect_launches(read_launches(), "StyleGAN2 viewer Session", centered_gram=0)
        log(f"StyleGAN2 viewer: Session on the W CLI's cache in {built:.3f} s "
            f"({session.n_sliders} sliders, {session.model.get_max_latents()} W slots)")
        results["sg2"] = drive_viewer(gpu, session, "StyleGAN2-FFHQ-1024",
                                      {"modconv3x3": B_PER_FORWARD,
                                       "upsample_conv": UP_PER_FORWARD}, "StyleGAN2")
        launches.update({f"viewer_sg2_{k}": v for k, v in results["sg2"].pop("launches").items()})
        del session
    plain, up = sg1_counts(1024)
    with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
        with viewer_policy(None):
            session = Session(Config().from_args(list(SG1_ARGS) + ["-n", "4096"]))
        results["sg1"] = drive_viewer(gpu, session, "StyleGAN-FFHQ-1024",
                                      {"conv3x3": plain, "upsample_conv": up}, "StyleGAN")
        launches.update({f"viewer_sg1_{k}": v for k, v in results["sg1"].pop("launches").items()})
        del session
    return launches, results


# the viewer on BigGAN-512, ProGAN-256 and DCGAN-64, each Session on a fit
# of 4096 samples at its CLI's layer (the phase reads frames)
VIEWER_FAMILIES = {
    "BigGAN": ["--model", "BigGAN-512", "--class", "husky", "--layer", "generator.gen_z",
               "--est", "ipca", "-c", "80", "-n", "4096", "-b", "512"],
    "ProGAN": ["--model", "ProGAN", "--class", "bedroom", "--layer", "layer2", "--est", "ipca",
               "-c", "80", "-n", "4096"],
    "DCGAN": ["--model", "DCGAN", "--layer", "deconv1", "--est", "ipca", "-c", "80", "-n", "4096"],
}


def family_counts(family: str, preview: bool) -> dict:
    """Kernel B's launches of one forward of each family's viewer model:
    the plain and stride-2 modes (DCGAN: its four transposed convs)."""
    if family == "DCGAN":
        return {"upsample_conv": len(dc_shapes(1))}
    plain, up = (bg_counts if family == "BigGAN" else pg_counts)(preview=preview)
    return {"conv3x3": plain, "upsample_conv": up}


def run_viewer_families(gpu: str) -> tuple[dict, dict]:
    """``python -m ganspace_tpu_torch interactive`` on BigGAN-512 (class
    husky), ProGAN-256 (class bedroom) and the GAN-zoo DCGAN-64, in the
    preview policy and in float32 (drive_viewer): the frame times, the
    preview frame against the float32 one gated at PREVIEW_ERR_RATIO times
    the JAX package's figure, the preview's launches (BigGAN's and ProGAN's
    pixel-layout up-convs on kernel B's plain mode, the rest on the
    stride-2 kernel; DCGAN's float32 storage on its bf16-operand mode)."""
    from ganspace_tpu_torch.apps.interactive import Session
    from ganspace_tpu_torch.config import Config
    launches, results = {}, {}
    for family, args in VIEWER_FAMILIES.items():
        with tempfile.TemporaryDirectory() as out, environ(GANSPACE_OUTPUT_DIR=out):
            with viewer_policy(None):
                t0 = time.perf_counter()
                session = Session(Config().from_args(list(args)))
                built = time.perf_counter() - t0
            log(f"{family} viewer: Session with its fit at n = 4096 in {built:.3f} s "
                f"({session.n_sliders} sliders, {session.model.get_max_latents()} latents)")
            results[family] = drive_viewer(gpu, session, session.model.name,
                                           family_counts(family, False), family,
                                           family_counts(family, True))
            launches.update({f"viewer_{family.lower()}_{k}": v
                             for k, v in results[family].pop("launches").items()})
            del session
    return launches, results


def run_progan_bf16_cli(gpu: str, f32_arrays: dict) -> dict:
    """``visualize --model ProGAN --class bedroom --layer layer6 -n 20000
    --dtype bfloat16`` on the fused stream, as the float32 layer6 fit runs:
    the fit at the preview precision (float32 storage; kernel B's plain
    mode on its bf16-operand datapath, the pixel-layout up layers as nearest
    2x then that mode), the _bf16 cache, its 80 cosine bounds and the grade
    they imply, its components beside the float32 fit's (reported, not
    gated: random weights give a flat spectrum); the render after it runs
    at full precision."""
    from ganspace_tpu_torch.apps import visualize
    args = ["--model", "ProGAN", "--class", "bedroom", "--layer", PG_TAP, "--est", "ipca",
            "-c", "80", "-n", str(PG_TAP_N), "--dtype", "bfloat16"]
    with tempfile.TemporaryDirectory() as out, \
            environ(GANSPACE_OUTPUT_DIR=out, GANSPACE_FUSED_ACTS=1):
        reset_launches()
        result = visualize.main(args)
        launches = read_launches()
        if not result.cache.name.endswith("_bf16.npz"):
            raise AssertionError(f"ProGAN --dtype bfloat16 cache {result.cache.name}: no _bf16 tag")
        arrays, meta = load_cache(result.cache)
    expect_meta(meta, "ProGAN --dtype bfloat16 CLI", dtype="bfloat16", device_rng=True,
                fused_linreg=True, bf16_pass1=False)
    bounds = meta.get("bf16_cos_bounds")
    if not bounds or len(bounds) != 80 or meta["bf16_analysis_grade"] != (min(bounds) >= 0.99):
        raise AssertionError(f"ProGAN --dtype bfloat16 CLI: bounds {bounds} and grade "
                             f"{meta.get('bf16_analysis_grade')} disagree")
    # the probe and the fit's blocks on the bf16 datapath; the shape
    # annotation, the activation-mode strips' centering and the render in float32
    fit_fwd = 1 + PG_TAP_BLOCKS * (1 + (not meta["refine_skipped"]))
    tap_fwd = 1 + PG_STRIPS // 2
    pv_plain, pv_up = pg_counts(PG_TAP, preview=True)
    tap_plain, tap_up = pg_counts(PG_TAP)
    plain, up = pg_counts()
    expect_launches(launches, "ProGAN --dtype bfloat16 CLI",
                    conv3x3_bf16=pv_plain * fit_fwd, upsample_conv_bf16=pv_up * fit_fwd,
                    conv3x3=tap_plain * tap_fwd + plain * PG_STRIPS,
                    upsample_conv=tap_up * tap_fwd + up * PG_STRIPS)
    cos = _min_abs_cos(*(torch.from_numpy(a["act_comp"].reshape(80, -1))
                         for a in (arrays, f32_arrays)))
    n_low = sum(b < 0.99 for b in bounds)
    log(f"ProGAN --dtype bfloat16 CLI at {PG_TAP} (n = {PG_TAP_N}, fused): {result.cache.name}; "
        f"refine_skipped {meta['refine_skipped']}; bounds min {min(bounds):.6f} median "
        f"{float(np.median(bounds)):.6f}, {n_low}/80 below 0.99, analysis grade "
        f"{meta['bf16_analysis_grade']}; min |cos| against the float32 {PG_TAP} fit's "
        f"components {cos:.6f} (not gated); fit {result.fit_seconds:.3f} s "
        f"({PG_TAP_N / result.fit_seconds:.1f} samples/s); phases: {fmt_phases(result.phases)}; "
        f"launches {launches} [{gpu}]")
    return launches


def profile_biggan(gpu: str, model) -> None:
    """Four blocks of the BigGAN CLI's fused stream at gen_z (each 10000
    truncated latents drawn, the embedding and gen_z, and the sketch,
    regression and random-projection updates of ``fit_stream``), then one
    5-frame 512-px forward of its render."""
    from ganspace_tpu_torch.decomposition import acts_stream_block
    from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
    from ganspace_tpu_torch.sampling import SEED_SAMPLING, random_directions_device
    acts = acts_stream_block(model, "generator.gen_z", BG_BATCH, SEED_SAMPLING)
    dirs = random_directions_device(80, BG_TAP_D, "cuda")
    est = IPCAEstimator(80, refine="never")

    def fused():
        est.fit_stream(acts, 4, with_reg=True, rand_dirs=dirs)
    profile_run(gpu, f"BigGAN gen_z fused stream (4 blocks of {BG_BATCH}, one pass)", fused)
    z = model.sample_latent(RENDER_BATCH, seed=1)
    profile_run(gpu, f"BigGAN 512-px forward (B = {RENDER_BATCH})", lambda: model.forward(z))


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
    copies = [e for e in rows if "copy" in e.key.lower()]
    log(f"{what} profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}); copy kernels (dtype casts and layout copies) "
        f"{sum(e.count for e in copies)} launches "
        f"({' + '.join(str(e.count) for e in copies) or '0'}) [{gpu}]")
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
    expect_state(model, params, "checkpoint")
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

    # The policy registry off, its default: every fit is all float32; the
    # first-pass phase gives the registry a temporary directory of its own.
    os.environ.pop("GANSPACE_COMPILE_CACHE", None)

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
        preview = check_preview_kernels(gen, gpu)
    log(f"kernel checks wall time: {time.perf_counter() - t_start:.1f} s")
    from ganspace_tpu_torch.models import get_instrumented_model
    launches = {}
    with ieee_f32():
        launches["checkpoint_load"] = check_checkpoint_load(gpu)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as w_out:
        launches["w_style_cli"], w_device = run_main_path(gpu, w_out)
        log(f"W path wall time: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        viewer_launches, _ = run_viewer(gpu, w_out)
        launches.update(viewer_launches)
        log(f"viewer phases wall time: {time.perf_counter() - t0:.1f} s")
    # one model per latent space for the fit-only runs (the CLI's weights)
    w_inst = get_instrumented_model("StyleGAN2", "ffhq", "style", torch.device("cuda"),
                                    use_w=True)
    w_fit_1m = run_w_fit_1m(gpu, w_inst)
    launches["w_fit_1m"] = w_fit_1m["launches"]
    w_host = check_w_stream_gate(gpu, w_inst, w_device)
    launches["w_fit_host"], launches["w_fit_host_seed7"] = (w_host[0]["launches"],
                                                            w_host[7]["launches"])
    # the full-batch estimators at W: the PCA CLI (the full-batch path end
    # to end) gated against the moments-tier fit, then ICA and sparse PCA
    t0 = time.perf_counter()
    launches["w_pca_cli"] = run_pca_cli(gpu, recorder, w_fit_1m, w_host)
    launches["w_ica_fit_1m"] = run_w_full_batch_fit(gpu, w_inst, "ica")
    launches["w_spca_fit_1m"] = run_w_full_batch_fit(gpu, w_inst, "spca")
    with ieee_f32():
        # FastICA on near-Gaussian W latents has no single answer (1e-7
        # noise moves it), so it is held on planted sources
        launches["estimators_vs_cpu_w"] = check_estimators_vs_cpu(
            gpu, ("pca", "fbpca", "spca"), lambda: w_matrix(w_inst.model, VS_CPU_W_ROWS),
            centered_gram=1)
        launches["ica_vs_cpu_planted"] = check_estimators_vs_cpu(
            gpu, ("ica",), lambda: planted_sources(VS_CPU_W_ROWS), centered_gram=1)
    log(f"W full-batch estimators wall time: {time.perf_counter() - t0:.1f} s")
    del w_inst
    t0 = time.perf_counter()
    launches["convs2_cli"], conv50 = run_conv_tap_path(gpu)
    log(f"conv-tap path wall time: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["convs2_cli_bf16"] = run_bf16_cli(gpu, conv50)
    log(f"--dtype bfloat16 CLI wall time: {time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    launches["convs2_fbpca_fit_host"] = run_conv_fbpca_fit(gpu, conv_inst,
                                                           runs["convs2_fit_host"]["arrays"])
    with ieee_f32():
        forwards = VS_CPU_TAP_ROWS // CONV_BATCH
        launches["fbpca_vs_cpu_convs2"] = check_estimators_vs_cpu(
            gpu, ("fbpca",), lambda: tap_matrix(conv_inst, VS_CPU_TAP_ROWS),
            modconv3x3=B_PER_TAP_FORWARD * forwards, upsample_conv=UP_PER_TAP_FORWARD * forwards)
    log(f"conv-tap fbpca wall time: {time.perf_counter() - t0:.1f} s")
    del conv_inst
    launches.update({path: run["launches"] for path, run in runs.items()})
    log(f"conv-tap fit at n = {CONV_N}: fused stream "
        f"{runs['convs2_fit_fused']['seconds']:.3f} s against the device pre-sampled "
        f"stream's {runs['convs2_fit_device']['seconds']:.3f} s [{gpu}]")
    check_fit_repeats(f"fused conv-tap fit at n = {CONV_N}", runs["convs2_fit_fused"],
                      runs["convs2_fit_fused_again"])
    t0 = time.perf_counter()
    conv_inst = get_instrumented_model("StyleGAN2", "ffhq", "convs.2", torch.device("cuda"))
    launches["convs2_fit_bf16_pass1"] = run_bf16_pass1(gpu, conv_inst)
    del conv_inst
    log(f"bf16 first pass wall time: {time.perf_counter() - t0:.1f} s")
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

    # BigGAN-deep-512, class husky, at full width
    t0 = time.perf_counter()
    with ieee_f32():
        launches["bg_checkpoint"] = check_biggan_checkpoint(gpu)
    launches["bg_cli"], _ = run_biggan_cli(gpu)
    bg_inst = get_instrumented_model("BigGAN-512", "husky", "generator.gen_z",
                                     torch.device("cuda"))
    launches.update(check_biggan_stream_gate(gpu, bg_inst))
    with ieee_f32():
        profile_biggan(gpu, bg_inst.model)
    del bg_inst
    tap_inst = get_instrumented_model("BigGAN-512", "husky", BG_TAP, torch.device("cuda"))
    launches["bg_fit_layers1"] = run_biggan_tap_fit(gpu, tap_inst)
    del tap_inst
    log(f"BigGAN phases wall time: {time.perf_counter() - t0:.1f} s")

    # ProGAN-256 (class bedroom) and the GAN-zoo DCGAN at full width
    t0 = time.perf_counter()
    with ieee_f32():
        launches["pg_checkpoint"] = check_progan_checkpoint(gpu)
        launches["dc_checkpoint"] = check_dcgan_checkpoint(gpu)
    launches["pg_cli"], pg_device = run_progan_cli(gpu)
    pg_inst = get_instrumented_model("ProGAN", "bedroom", "layer2", torch.device("cuda"))
    launches.update(check_progan_stream_gate(gpu, pg_inst, pg_device))
    del pg_inst
    tap_inst = get_instrumented_model("ProGAN", "bedroom", PG_TAP, torch.device("cuda"))
    launches["pg_fit_layer6"], launches["pg_fit_layer6_again"], pg_l6 = run_progan_tap_fits(
        gpu, tap_inst)
    del tap_inst
    launches["dc_cli"] = run_dcgan_cli(gpu)
    log(f"ProGAN and DCGAN phases wall time: {time.perf_counter() - t0:.1f} s")
    # the paper's figure scripts and makesample at full width
    launches.update(run_figures(gpu))
    # the preview policy on BigGAN, ProGAN and DCGAN
    t0 = time.perf_counter()
    launches["pg_cli_bf16"] = run_progan_bf16_cli(gpu, pg_l6)
    viewer_launches, _ = run_viewer_families(gpu)
    launches.update(viewer_launches)
    log(f"BigGAN, ProGAN and DCGAN preview phases wall time: {time.perf_counter() - t0:.1f} s")
    conv_npz = runs["convs2_fit_host"]["arrays"]
    with ieee_f32():
        profile_conv_tap_blocks(gpu)
        check_sketch_gate(gpu)
        check_sketch_vs_cpu()
        check_vs_cpu(conv_npz)
        check_sg1_vs_cpu()
        check_biggan_vs_cpu()
        check_progan_dcgan_vs_cpu()
        check_launched_shapes(recorder, gen)
    log(f"total wall time: {time.perf_counter() - t_start:.1f} s")

    def counts(name):
        by_path = {path: n.get(name, 0) for path, n in launches.items()}
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
        # the bf16 datapath (the preview policy): times at bf16 storage, the
        # viewer's, at StyleGAN2's render shapes at B = 5; kernel B's and the
        # stride-2 kernel's each on a body of its own (implicit_conv_bf16.cuh,
        # upconv2x_bf16.cuh)
        dict(name="modconv3x3_bf16", route="cuda",
             source="ganspace_tpu_torch/csrc/modconv3x3_bf16.cu",
             replaces="ganspace_tpu/ops/pallas/blockconv.py:178",
             **counts("modconv3x3_bf16"), **preview["modconv3x3"]),
        dict(name="conv3x3_bf16", route="cuda",
             source="ganspace_tpu_torch/csrc/modconv3x3_bf16.cu",
             replaces="ganspace_tpu/ops/pallas/blockconv.py:178",
             **counts("conv3x3_bf16"), **preview["conv3x3"]),
        dict(name="upsample_conv_bf16", route="cuda",
             source="ganspace_tpu_torch/csrc/upconv2x_bf16.cu",
             replaces="ganspace_tpu/models/stylegan.py:164",
             **counts("upsample_conv_bf16"), **preview["upsample_conv"]),
    ]
    for row in kernels:
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']}: launched no time on the paths")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
