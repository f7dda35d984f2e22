"""Where the stride-2 kernel's bf16 datapath spends its time, on the card.

Builds variants of a body with one part removed each (the copies of x, the
pass that forms A, the products, the overlap-add; and a skeleton with all
of them removed), from copies of its sources patched with preprocessor
switches, and times every variant at StyleGAN2's 64 -> 129 and 512 -> 1025
px and StyleGAN's fused 256 -> 512 px shapes in both storages, with
``chip_smoke.median_ms``.  A part's cost is the whole's time less the time
without it; the parts overlap, so they need not sum.

    python -m ganspace_tpu_torch.tools.upconv_split            # this body
    python -m ganspace_tpu_torch.tools.upconv_split --old DIR  # an older one

``--old DIR`` splits the bf16 mode of an older ``upconv2x.cu`` (one
whose bf16 datapath shares the 3xTF32 body, as at commit dc6e524), found
with its headers in DIR, for example the ``csrc/`` of a ``git archive`` of
that commit unpacked into the ignored ``build/``.  Run from the root of a
checkout, on an NVIDIA H100; the builds go to ``build/upconv_split/``.
"""

from __future__ import annotations

import argparse
import ctypes
import time
from pathlib import Path

from ganspace_tpu_torch.ops import _build

SHAPES = [(5, 512, 256, 64, 64, 3, 0, True), (5, 64, 32, 512, 512, 3, 0, True),
          (5, 64, 32, 256, 256, 4, 1, False)]
OUT = _build.BUILD_DIR.parent / "upconv_split"

# (anchor in the source, its replacement): each part's code behind a switch
_NEW_SWITCHES = [
    ("      wgmma::mbar_expect_tx(bar, T.box_bytes);\n"
     "      tensor_copy(raw, xmap, whole ? 3 : 4, c, bar);",
     "#ifdef NO_LOAD\n      wgmma::mbar_expect_tx(bar, 0); (void)c;\n#else\n"
     "      wgmma::mbar_expect_tx(bar, T.box_bytes);\n"
     "      tensor_copy(raw, xmap, whole ? 3 : 4, c, bar);\n#endif"),
    ("    form_a<TX>(asm_", "#ifndef NO_PASS\n    form_a<TX>(asm_"),
    ("T.c - chunk * kKC, pm, pj, poff, psb);\n",
     "T.c - chunk * kKC, pm, pj, poff, psb);\n#endif\n"),
    ("      wgmma_bf16::mma<kN>(acc, da + 2 * j, db + 2 * j, chunk > 0 || j > 0);",
     "#ifndef NO_MMA\n"
     "      wgmma_bf16::mma<kN>(acc, da + 2 * j, db + 2 * j, chunk > 0 || j > 0);\n#endif"),
    ("  const int count = T.spt * nyb * nxb * 2;",
     "#ifdef NO_OA\n  const int count = 0;\n#else\n  const int count = T.spt * nyb * nxb * 2;\n#endif"),
    ("  const int count = T.spt * r.ny * npq;",
     "#ifdef NO_OA\n  const int count = 0;\n#else\n  const int count = T.spt * r.ny * npq;\n#endif"),
    ("      wgmma::mbar_expect_tx(b, L::kBBytes);\n"
     "      wgmma::bulk_copy(bsm + (b_step % kSB) * L::kBBytes, src, L::kBBytes, b);",
     "#ifdef NO_B\n      wgmma::mbar_expect_tx(b, 0); (void)src;\n#else\n"
     "      wgmma::mbar_expect_tx(b, L::kBBytes);\n"
     "      wgmma::bulk_copy(bsm + (b_step % kSB) * L::kBBytes, src, L::kBBytes, b);\n#endif"),
    ("  if (T.has_s) {\n    for (int idx = tid; idx < T.spt * kKC; idx += kThreads) {",
     "#ifdef NO_SD\n  if (false) {\n#else\n  if (T.has_s) {\n#endif\n"
     "    for (int idx = tid; idx < T.spt * kKC; idx += kThreads) {"),
    ("  for (int i = tid; dmod && i < T.spt * kCoT; i += kThreads) {",
     "#ifdef NO_SD\n  for (int i = tid; false; i += kThreads) {\n#else\n"
     "  for (int i = tid; dmod && i < T.spt * kCoT; i += kThreads) {\n#endif"),
]
_OLD_SWITCHES = [
    ("  const int m = load_pixel(T);\n", "  const int m = load_pixel(T);\n#ifndef NO_LOAD\n"),
    ("  if (T.has_s) {\n    float* ss = slot + S::kS;", "#endif\n  if (T.has_s) {\n    float* ss = slot + S::kS;"),
    ("#pragma unroll\n      for (int j = 0; j < 4; ++j) {  // k8 step j",
     "#ifndef NO_MMA\n#pragma unroll\n      for (int j = 0; j < 4; ++j) {  // k8 step j"),
    ("      wgmma::commit();\n      wgmma::wait<0>();\n",
     "      wgmma::commit();\n      wgmma::wait<0>();\n#endif\n"),
    ("    const bool last_r = a.i0 + T.tr >= T.h, last_c = a.j0 + T.tc >= T.w;",
     "#ifdef NO_OA\n    {\n      float sink = 0.f;\n#pragma unroll\n"
     "      for (int i = 0; i < kN / 2; ++i) sink += total[i];\n"
     "      if (sink == 1234.5f) tf32x3::store(y + tid, sink);\n    }\n#else\n"
     "    const bool last_r = a.i0 + T.tr >= T.h, last_c = a.j0 + T.tc >= T.w;"),
    ("    // order these generic accesses before the TMA that refills the slot",
     "#endif\n    // order these generic accesses before the TMA that refills the slot"),
]
NEW_VARIANTS = {"whole": [], "no_load": ["NO_LOAD"], "no_pass": ["NO_PASS"],
                "no_mma": ["NO_MMA"], "no_oa": ["NO_OA"],
                "skeleton": ["NO_LOAD", "NO_PASS", "NO_MMA", "NO_OA", "NO_B", "NO_SD"]}
OLD_VARIANTS = {"whole": [], "no_load": ["NO_LOAD"], "no_mma": ["NO_MMA"],
                "no_oa": ["NO_OA"], "loads_alone": ["NO_MMA", "NO_OA"]}


def _patch(text: str, switches, flags, where: str) -> str:
    """text with each anchor found replaced; every switch in ``flags`` must
    have landed somewhere (an anchor may be absent from a version)."""
    for anchor, repl in switches:
        text = text.replace(anchor, repl)
    missing = [f for f in flags if f not in text]
    if missing:
        raise RuntimeError(f"upconv_split: no place for {missing} in {where}")
    return text


def _sources(old: Path | None) -> tuple[Path, Path]:
    """(the variant source, its include directory) under OUT: the body with
    its switches, in a namespace and under an entry point named by macros."""
    OUT.mkdir(parents=True, exist_ok=True)
    if old is None:
        head = _patch((_build.CSRC / "upconv2x_bf16.cuh").read_text(), _NEW_SWITCHES,
                      NEW_VARIANTS["skeleton"], "upconv2x_bf16.cuh")
        head = head.replace("namespace upconv_bf16 {", "namespace NS {")
        (OUT / "split_body.cuh").write_text(head)
        src = (_build.CSRC / "upconv2x_bf16.cu").read_text()
        src = src.replace('#include "upconv2x_bf16.cuh"', '#include "split_body.cuh"')
        src = src.replace("namespace upconv_bf16 {", "namespace NS {") + '''
extern "C" int ENTRY(const void* x, const void* wimg, const float* s, const float* dmod,
                     void* y, const int* tiling, int b, int c, int h, int w, int co, int k,
                     int p, int mode, void* stream) {
  return static_cast<int>(NS::upsample_conv(x, wimg, s, dmod, y, tiling, b, c, h, w, co, k, p,
                                            mode == 2, static_cast<cudaStream_t>(stream)));
}
'''
        (OUT / "split_body.cu").write_text(src)
        return OUT / "split_body.cu", _build.CSRC
    src = _patch((old / "upconv2x.cu").read_text(), _OLD_SWITCHES,
                 ("NO_LOAD", "NO_MMA", "NO_OA"), str(old / "upconv2x.cu"))
    src = src.replace("namespace upconv {", "namespace NS {").replace("upconv::", "NS::")
    src = src.replace('extern "C" int ganspace_upsample_conv(', 'extern "C" int ENTRY(')
    (OUT / "split_old.cu").write_text(src)
    return OUT / "split_old.cu", old


def build(old: Path | None) -> dict:
    """One library with an entry per variant, all compiled side by side."""
    source, include = _sources(old)
    variants = OLD_VARIANTS if old is not None else NEW_VARIANTS
    tag = "old" if old is not None else "new"
    cmds, objs = [], []
    for name, flags in variants.items():
        obj = OUT / f"{tag}_{name}.o"
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include),
                     *[f"-D{f}" for f in flags], f"-DNS=split_ns_{name}",
                     f"-DENTRY=split_{name}", "-c", "-o", str(obj), str(source)])
        objs.append(obj)
    _build._run(cmds)
    lib_path = OUT / f"libsplit_{tag}.so"
    _build._run([[_build._nvcc(), "-shared", "-o", str(lib_path), *map(str, objs)]])
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for name in variants:
        fn = getattr(lib, f"split_{name}")
        fn.argtypes = _build._SIGNATURES["ganspace_upsample_conv"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> None:
    import torch

    import chip_smoke as cs
    from ganspace_tpu_torch.ops import modconv
    from ganspace_tpu_torch.ops.precision import ieee_f32

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, default=None,
                        help="directory of an older upconv2x.cu and its headers")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("upconv_split: needs an NVIDIA GPU")
    gpu = cs.gpu_line()
    t0 = time.perf_counter()
    fns = build(args.old)
    print(f"built {len(fns)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    with ieee_f32():
        for case in SHAPES:
            b, c, co, h, w, k, pad, _ = case
            x0, wt, s, d = cs.up_inputs(gen, case)
            wr = modconv.round_bf16(wt)
            if args.old is None:
                image = modconv.upsample_weight_image_bf16(wr)
                tiling = modconv.upsample_tiling_bf16(b, h, w)
            else:
                image = modconv.upsample_weight_image(wr)
                tiling = modconv.upsample_tiling(b, h, w)
            tiling = (ctypes.c_int * 9)(*tiling)
            ho = 2 * h + k - 2 - 2 * pad
            for mode in (cs.MODE_BF16, cs.MODE_BF16_OPS):
                x = x0.to(torch.bfloat16 if mode == cs.MODE_BF16 else torch.float32)
                y = torch.empty((b, co, ho, ho), dtype=x.dtype, device="cuda")

                def run(fn):
                    _build.check(fn(x.data_ptr(), image.data_ptr(),
                                    None if s is None else s.data_ptr(),
                                    None if d is None else d.data_ptr(), y.data_ptr(),
                                    ctypes.addressof(tiling), b, c, h, w, co, k, pad, mode,
                                    stream), "upconv_split")
                run(fns["whole"])
                with cs.precision_for(mode):
                    ref = modconv.upsample_conv_plain(x, wt, s, d, pad)
                cs.datapath_err(y, ref, case, " split, whole body", mode)
                ms = {name: cs.median_ms(lambda fn=fn: run(fn)) for name, fn in fns.items()}
                whole = ms["whole"]
                parts = ", ".join(f"{name[3:]} {whole - t:.4f}" for name, t in ms.items()
                                  if name.startswith("no_"))
                rest = ", ".join(f"{name} {t:.4f}" for name, t in ms.items()
                                 if not name.startswith("no_"))
                print(f"B={b} C={c} Co={co} {h}->{ho} px k={k}, "
                      f"{'bf16' if mode == cs.MODE_BF16 else 'float32'} storage: {rest} ms; "
                      f"parts (whole less the variant without): {parts} ms [{gpu}]",
                      flush=True)


if __name__ == "__main__":
    main()
