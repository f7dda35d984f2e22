// Kernel B, 3x3 mode, on the bf16 datapath (the preview policy of
// ops/precision.py): the body of implicit_conv_bf16.cuh for the modulated
// and the plain mode, in both storages, compiled apart from the 3xTF32
// body (modconv3x3.cu), which calls it for modes 1 and 2.  Replaces the
// bf16 case of ganspace_tpu/ops/pallas/blockconv.py::conv3x3_blocks_pallas
// (the weight cast to x's dtype, :164; the policy's precision, :177-180; the
// output in x's dtype, :188).

#include <cstdint>

#include "implicit_conv_bf16.cuh"

// x [b, c, h, w] (float32 for mode 1, bf16 for mode 2), wt [co, 3, 3, cp]
// bf16 with cp = c rounded up to 16 (zeros past c), s [b, c] or null, dmod
// [b, co] or null (float32), y [b, co, h, w] in x's storage: contiguous
// device buffers.  Launches on `stream`; returns the launch's error.
cudaError_t modconv3x3_bf16(const void* x, const void* wt, const float* s, const float* dmod,
                            void* y, int b, int c, int h, int w, int co, int mode,
                            cudaStream_t stream) {
  implicit_conv_bf16::Launch L = {};
  L.b = b, L.c = c, L.h = h, L.w = w, L.co = co;
  implicit_conv_bf16::Geometry& q = L.g;
  q.wt = static_cast<const __nv_bfloat16*>(wt);
  q.cp = (c + implicit_conv_bf16::kCK - 1) / implicit_conv_bf16::kCK * implicit_conv_bf16::kCK;
  q.oh = h, q.ow = w;
  if (reinterpret_cast<uintptr_t>(wt) % 16 != 0) return cudaErrorInvalidValue;
  using implicit_conv_bf16::launch_for;
  if (mode == 1)
    return launch_for<float>(static_cast<const float*>(x), s, dmod, static_cast<float*>(y), L,
                             stream);
  if (mode == 2)
    return launch_for<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), s, dmod,
                                     static_cast<__nv_bfloat16*>(y), L, stream);
  return cudaErrorInvalidValue;
}
