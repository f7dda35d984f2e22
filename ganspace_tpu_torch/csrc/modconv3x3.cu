// Kernel B, 3x3 mode: a 3x3 convolution, stride 1, zero padding 1, NCHW
// float32, with an optional style scale and demodulation:
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
// the 4-8 px ones, where reading the weight once is the bound.

#include <cstdint>

#include "implicit_conv.cuh"

// x [b, c, h, w], wt [co, c, 3, 3], s [b, c] or null, dmod [b, co] or null,
// y [b, co, h, w]: contiguous float32 device buffers.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int ganspace_modconv3x3(const float* x, const float* wt, const float* s,
                                   const float* dmod, float* y, int b, int c,
                                   int h, int w, int co, void* stream) {
  implicit_conv::Launch L = {};
  L.b = b, L.c = c, L.h = h, L.w = w, L.co = co;
  implicit_conv::Geometry& q = L.g;
  q.wt = wt, q.krow = static_cast<long long>(c) * 9;
  q.oh = h, q.ow = w;
  q.xvec = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  q.wvec = (c % 4 == 0) && (reinterpret_cast<uintptr_t>(wt) % 16 == 0);
  return static_cast<int>(
      implicit_conv::launch_for(x, s, dmod, y, L, static_cast<cudaStream_t>(stream)));
}
