// Kernel B, 3x3 mode: a 3x3 convolution, stride 1, zero padding 1, NCHW,
// with an optional style scale and demodulation:
//
//   y[b,o,h,w] = d[b,o] * sum_{c,u,v} wt[o,c,u,v] * s[b,c] * x[b,c,h+u-1,w+v-1]
//
// with wt the He-scaled weight in its own OIHW layout, s the per-sample
// style scales and d the demodulation coefficients.  With s and d both null
// (the plain mode) it is the TPU kernel's own function.
//
// Replaces ganspace_tpu/ops/pallas/blockconv.py::conv3x3_blocks_pallas:
//   * modulated (s given): every non-upsampling StyledConv of StyleGAN2
//     synthesis, with the style scale and demodulation that
//     ganspace_tpu/ops/s2d.py::modulated_conv3x3_blocks applies around the
//     TPU kernel;
//   * plain (s and d null): StyleGAN's conv, conv1 and sub-128-px conv0_up
//     (the JAX call site ganspace_tpu/models/stylegan.py:321, through
//     ops/s2d.py::conv3x3_blocks).
// The TPU kernel's 2x2 space-to-depth layout and 16C patch packing exist
// for 128-lane TPU registers and are not carried over: this kernel works on
// the plain NCHW maps.  The implicit GEMM itself, and what bounds it, are
// described in implicit_conv.cuh; this mode reads a 3x3 window (K = 9C per
// output pixel), which makes it compute-bound at every synthesis shape but
// the 4-8 px ones, where reading the weight once is the bound.  Under the
// preview policy (ops/precision.py) it runs the TPU kernel's bf16 case:
// operands rounded to bf16, float32 accumulation, y in x's storage (float32
// or bf16), on a body of its own (implicit_conv_bf16.cuh,
// modconv3x3_bf16.cu).

#include <cstdint>

#include "implicit_conv.cuh"

// The bf16 datapath, modes 1 and 2 (modconv3x3_bf16.cu).
cudaError_t modconv3x3_bf16(const void* x, const void* wt, const float* s, const float* dmod,
                            void* y, int b, int c, int h, int w, int co, int mode,
                            cudaStream_t stream);

// x [b, c, h, w], s [b, c] or null, dmod [b, co] or null, y [b, co, h, w]:
// contiguous device buffers.  mode 0: x and y float32, wt [co, c, 3, 3]
// float32, 3xTF32; mode 1: x and y float32, the bf16 datapath (x * s
// rounded to bf16 in the kernel); mode 2: x and y bf16, the bf16 datapath.
// On the bf16 datapath wt is the weight rounded to bf16 by the caller, [co,
// 3, 3, cp] with cp = c rounded up to 16 (ops/modconv.bf16_taps).  s and
// dmod are float32 in every mode.  Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int ganspace_modconv3x3(const void* x, const void* wt, const float* s,
                                   const float* dmod, void* y, int b, int c,
                                   int h, int w, int co, int mode, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1 || mode == 2)
    return static_cast<int>(modconv3x3_bf16(x, wt, s, dmod, y, b, c, h, w, co, mode, st));
  if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  implicit_conv::Launch L = {};
  L.b = b, L.c = c, L.h = h, L.w = w, L.co = co;
  implicit_conv::Geometry& q = L.g;
  q.wt = static_cast<const float*>(wt), q.krow = static_cast<long long>(c) * 9;
  q.oh = h, q.ow = w;
  // 16-byte copies of four float32 values
  q.xvec = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  q.wvec = (c % 4 == 0) && (reinterpret_cast<uintptr_t>(wt) % 16 == 0);
  return static_cast<int>(implicit_conv::launch_for(
      static_cast<const float*>(x), s, dmod, static_cast<float*>(y), L, st));
}
