// One m16n8k8 3xTF32 step of tf32x3.cuh on one warp: d = a @ b^T for
// a [16, 8], b [8, 8] (row n holds column n of the product's right operand)
// and d [16, 8], all row-major float32.  It exists to check the header's
// fragment layouts against a plain product on the card, apart from the
// two kernels that use them.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

__global__ void tf32x3_tile_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b, float* __restrict__ d) {
  const int g = threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  uint32_t a_hi[1][4], a_lo[1][4], b_hi[1][2], b_lo[1][2];
  tf32x3::split(a[g * 8 + t], a_hi[0][0], a_lo[0][0]);
  tf32x3::split(a[(g + 8) * 8 + t], a_hi[0][1], a_lo[0][1]);
  tf32x3::split(a[g * 8 + t + 4], a_hi[0][2], a_lo[0][2]);
  tf32x3::split(a[(g + 8) * 8 + t + 4], a_hi[0][3], a_lo[0][3]);
  tf32x3::split(b[g * 8 + t], b_hi[0][0], b_lo[0][0]);
  tf32x3::split(b[g * 8 + t + 4], b_hi[0][1], b_lo[0][1]);
  float acc[1][1][4] = {};
  tf32x3::mma_3xtf32(acc, a_hi, a_lo, b_hi, b_lo);
  d[g * 8 + 2 * t] = acc[0][0][0];
  d[g * 8 + 2 * t + 1] = acc[0][0][1];
  d[(g + 8) * 8 + 2 * t] = acc[0][0][2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[0][0][3];
}

}  // namespace

extern "C" int ganspace_tf32x3_tile(const float* a, const float* b, float* d,
                                    void* stream) {
  tf32x3_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, d);
  return static_cast<int>(cudaGetLastError());
}
