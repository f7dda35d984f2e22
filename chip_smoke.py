#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``ganspace_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: require CUDA and print the card's name and power limit;
2. build: compile the CUDA kernels from ``ganspace_tpu_torch/csrc``;
3. kernel A (centered Gram) against its plain PyTorch version, on the card;
4. kernel B (modulated 3x3 conv) against its plain version, at the nine
   plain-3x3 shapes of 1024-px StyleGAN2 synthesis plus a ragged one;
5. the main path: ``visualize --model StyleGAN2 --class ffhq --use_w
   --layer style --est ipca -c 80 -n 40960`` on the full-width FFHQ-1024
   generator (seeded random weights), with its launch counts, its cache and
   its grids checked;
6. one 1024-px image through the card (kernels) against the same model on
   the CPU (plain versions).

The last lines are a JSON summary of the kernels, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

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
N_FIT_BLOCKS = 10                      # 40960 samples in blocks of 4096
NPZ_KEYS = {"act_comp", "act_mean", "act_stdev", "lat_comp", "lat_mean",
            "lat_stdev", "var_ratio", "random_stdevs", "_meta"}
# (N, D, explicit mu): the main path's block, then tests/test_pallas_moments.py's
GRAM_CASES = [(4096, 512, False), (300, 130, False), (77, 515, False),
              (256, 128, True)]
# (B, C, Co, H, W): conv1 and convs.1, 3, ..., 15 of 1024-px synthesis at
# B = 2, then a ragged map with channel counts off the 32-channel tile
CONV_CASES = [(2, c, c, r, r) for c, r in ((512, 4), (512, 8), (512, 16),
                                           (512, 32), (512, 64), (256, 128),
                                           (128, 256), (64, 512), (32, 1024))]
CONV_RAGGED = (2, 48, 40, 37, 23)
# A float32 FFMA sum against cuDNN's / cuBLAS's own float32 sum: rounding
# order differs, nothing else.
GRAM_ABS, GRAM_REL = 1e-4, 1e-5         # max|d| <= 1e-5 max|ref| + 1e-4
CONV_REL = 1e-5                         # max|d| / max|ref|
IMAGE_REL = 1e-3                        # 1024 px, 18 layers deep (fullres bar)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build():
    from ganspace_tpu_torch.ops._build import load_kernels
    lib = load_kernels()
    log(f"build: {lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")
    return lib


def check_centered_gram(gen: torch.Generator) -> dict:
    from ganspace_tpu_torch.ops.moments import centered_gram, centered_gram_plain
    worst, timing = 0.0, None
    for n, d, explicit in GRAM_CASES:
        x = torch.randn(n, d, generator=gen, device="cuda") * 2.0 + 0.5
        mu = torch.randn(d, generator=gen, device="cuda") if explicit else None
        got = centered_gram(x, mu)
        ref = centered_gram_plain(x, mu)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        bar = GRAM_REL * float(ref.abs().max()) + GRAM_ABS
        ms = median_ms(lambda: centered_gram(x, mu))
        plain_ms = median_ms(lambda: centered_gram_plain(x, mu))
        log(f"centered_gram N={n} D={d} mu={'given' if explicit else 'mean'}: "
            f"max|d|={err:.3e} (bar {bar:.3e}) kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if not err <= bar:
            raise AssertionError(f"centered_gram {n}x{d}: max|d| {err} > {bar}")
        worst = max(worst, err)
        if timing is None:                      # the main path's shape
            timing = (ms, plain_ms)
    return {"max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def check_modconv3x3(gen: torch.Generator) -> dict:
    from ganspace_tpu_torch.ops.modconv import (
        demodulation, modconv3x3, modconv3x3_plain)
    worst, total_ms, total_plain = 0.0, 0.0, 0.0
    for case in CONV_CASES + [CONV_RAGGED]:
        b, c, co, h, w = case
        x = torch.randn(b, c, h, w, generator=gen, device="cuda")
        wt = torch.randn(co, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
        s = 1.0 + 0.5 * torch.randn(b, c, generator=gen, device="cuda")
        d = demodulation(wt, s)
        got = modconv3x3(x, wt, s, d)
        ref = modconv3x3_plain(x, wt, s, d)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = median_ms(lambda: modconv3x3(x, wt, s, d))
        plain_ms = median_ms(lambda: modconv3x3_plain(x, wt, s, d))
        log(f"modconv3x3 B={b} C={c} Co={co} {h}x{w}: rel={rel:.3e} "
            f"(bar {CONV_REL:.0e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not rel < CONV_REL:
            raise AssertionError(f"modconv3x3 {case}: rel err {rel} >= {CONV_REL}")
        worst = max(worst, err)
        if case != CONV_RAGGED:
            total_ms += ms
            total_plain += plain_ms
        del x, got, ref
    log(f"modconv3x3, the nine synthesis shapes at B=2: kernel {total_ms:.4f} "
        f"ms, plain {total_plain:.4f} ms")
    return {"max_abs_err": worst, "ms": total_ms, "plain_ms": total_plain}


def run_main_path(gpu: str) -> dict:
    from ganspace_tpu_torch.apps import visualize
    from ganspace_tpu_torch.ops.moments import centered_gram
    from ganspace_tpu_torch.ops.modconv import modconv3x3

    with tempfile.TemporaryDirectory() as out:
        os.environ["GANSPACE_OUTPUT_DIR"] = out
        centered_gram.launches = 0
        modconv3x3.launches = 0
        result = visualize.main(list(MAIN_ARGS))
        launches = {"centered_gram": centered_gram.launches,
                    "modconv3x3": modconv3x3.launches}
        log(f"main path launches: {launches}")
        if launches["centered_gram"] != N_FIT_BLOCKS:
            raise AssertionError(f"centered_gram launched {launches['centered_gram']} "
                                 f"times, expected one per fit block ({N_FIT_BLOCKS})")
        if launches["modconv3x3"] <= 0:
            raise AssertionError("modconv3x3 never launched on the main path")

        with np.load(result.cache, allow_pickle=False) as data:
            if set(data.files) != NPZ_KEYS:
                raise AssertionError(f"npz keys {sorted(data.files)}")
            arrays = {k: data[k] for k in NPZ_KEYS - {"_meta"}}
            meta = json.loads(bytes(data["_meta"].item()).decode())
        for k, a in arrays.items():
            if not np.isfinite(a).all():
                raise AssertionError(f"npz {k} is not finite")
        comp = arrays["act_comp"].reshape(80, -1)
        if comp.shape != (80, 512):
            raise AssertionError(f"act_comp shape {arrays['act_comp'].shape}")
        gram_err = float(np.abs(comp @ comp.T - np.eye(80)).max())
        if gram_err > 1e-4:
            raise AssertionError(f"act_comp rows not orthonormal: {gram_err}")
        if not (np.diff(arrays["var_ratio"]) <= 1e-7).all():
            raise AssertionError("var_ratio is not descending")
        if meta.get("device_rng") is not False:
            raise AssertionError(f"_meta {meta}")
        summ = Path(out, "out", "StyleGAN2-ffhq", "style", "ipca", "summ")
        grids = sorted(p.name for p in summ.glob("*.jpg"))
        expected = (["components_W.jpg", "random_dirs_W.jpg"]
                    + [f"samp{i}_real_W.jpg" for i in range(10)])
        if grids != sorted(expected):
            raise AssertionError(f"summ grids {grids}")
        log(f"npz ok: keys, finite, |C C^T - I| = {gram_err:.2e}; "
            f"{len(grids)} grids")
    fit_rate = 40960 / result.fit_seconds
    render_rate = result.images / result.render_seconds
    log(f"fit: {result.fit_seconds:.3f} s, {fit_rate:.1f} samples/s [{gpu}]")
    log(f"render: {result.images} images at 1024 px in "
        f"{result.render_seconds:.3f} s, {render_rate:.2f} images/s [{gpu}]")
    return launches


def check_image_vs_cpu(gen_seed: int = 7) -> None:
    """One W through the full-width generator on the card and on the CPU."""
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
        gram = check_centered_gram(gen)
        conv = check_modconv3x3(gen)
    t0 = time.perf_counter()
    launches = run_main_path(gpu)
    log(f"main path wall time: {time.perf_counter() - t0:.1f} s")
    with ieee_f32():
        check_image_vs_cpu()

    kernels = [
        dict(name="centered_gram", route="cuda",
             source="ganspace_tpu_torch/csrc/centered_gram.cu",
             replaces="ganspace_tpu/ops/pallas/moments.py:58",
             launches=launches["centered_gram"], **gram),
        dict(name="modconv3x3", route="cuda",
             source="ganspace_tpu_torch/csrc/modconv3x3.cu",
             replaces="ganspace_tpu/ops/pallas/blockconv.py:178",
             launches=launches["modconv3x3"], **conv),
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
