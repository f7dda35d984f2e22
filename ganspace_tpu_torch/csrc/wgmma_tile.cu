// The wgmma products of the stride-2 kernel's two datapaths, each on one
// tile and one warpgroup, apart from the kernel that uses them: they exist
// to check the headers' operand layouts against a plain product on the card.
//
// ganspace_wgmma_tile: one 3xTF32 wgmma product of wgmma_tf32.cuh: d = a @ b^T
// for a [64, 32], b [n, 32] (n = 128 or 144) and d [64, n], all row-major
// float32, as the stride-2 kernel forms it: A split in registers, B's hi and
// lo halves read from shared memory through the descriptor, four k8 steps of
// three products each.  b_hi and b_lo are the split B in the layout the
// descriptor reads (ops/tf32x3.py::sw128_image).
//
// ganspace_wgmma_tile_bf16: one bf16 wgmma product of wgmma_bf16.cuh, as the
// bf16 datapath (upconv2x_bf16.cuh) forms it: d = bf16(a) @ b^T for a
// [64, 64] float32, b the bf16 image of [n, 64] (n = 144 or 256) and d
// [64, n] float32.

#include <cuda_runtime.h>

#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(128)
wgmma_tile_kernel(const float* __restrict__ a, const float* __restrict__ b_hi,
                  const float* __restrict__ b_lo, float* __restrict__ d) {
  __shared__ __align__(1024) float bs[2][N * 32];
  for (int i = threadIdx.x; i < N * 32; i += 128) {
    bs[0][i] = b_hi[i];
    bs[1][i] = b_lo[i];
  }
  wgmma::fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;
  uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tf32x3::split(a[r0 * 32 + 8 * j + t], a_hi[j][0], a_lo[j][0]);
    tf32x3::split(a[(r0 + 8) * 32 + 8 * j + t], a_hi[j][1], a_lo[j][1]);
    tf32x3::split(a[r0 * 32 + 8 * j + t + 4], a_hi[j][2], a_lo[j][2]);
    tf32x3::split(a[(r0 + 8) * 32 + 8 * j + t + 4], a_hi[j][3], a_lo[j][3]);
  }
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint64_t dh = wgmma::desc_sw128(wgmma::smem_addr(bs[0]));
  const uint64_t dl = wgmma::desc_sw128(wgmma::smem_addr(bs[1]));
#pragma unroll
  for (int i = 0; i < N / 2; ++i) wgmma::fence_operand(acc[i]);
  wgmma::fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a k8 step advances the start 32 bytes
    wgmma::mma<N>(acc, a_lo[j], dh + 2 * j, j > 0);
    wgmma::mma<N>(acc, a_hi[j], dl + 2 * j, 1);
    wgmma::mma<N>(acc, a_hi[j], dh + 2 * j, 1);
  }
  wgmma::commit();
  wgmma::wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) wgmma::fence_operand(acc[i]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wgmma::fence_operand(a_hi[j][e]);
      wgmma::fence_operand(a_lo[j][e]);
    }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * t + (i % 2);
    d[row * N + col] = acc[i];
  }
}

// d = bf16(a) @ b^T for a [64, 64] float32 and b the bf16 image of [N, 64]
// (N = 144 or 256): A rounded and written into its K-major 128-byte-swizzled
// tile by the helpers the stride-2 kernel's bf16 pass uses, then four k16
// steps with both operands read from shared memory.
template <int N>
__global__ void __launch_bounds__(128)
wgmma_tile_bf16_kernel(const float* __restrict__ a, const __nv_bfloat16* __restrict__ b_img,
                       float* __restrict__ d) {
  __shared__ __align__(1024) unsigned char as[64 * 128];
  __shared__ __align__(1024) __nv_bfloat16 bs[N * 64];
  for (int i = threadIdx.x; i < N * 64; i += 128) bs[i] = b_img[i];
  for (int i = threadIdx.x; i < 64 * 8; i += 128) {   // row i / 8, chunk i % 8
    const int r = i / 8, j = i % 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = a[r * 64 + 8 * j + e];
    wgmma_bf16::store_chunk(as, r, j, wgmma_bf16::pack8(v));
  }
  wgmma::fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint64_t da = wgmma::desc_sw128(wgmma::smem_addr(as));
  const uint64_t db = wgmma::desc_sw128(wgmma::smem_addr(bs));
#pragma unroll
  for (int i = 0; i < N / 2; ++i) wgmma::fence_operand(acc[i]);
  wgmma::fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)   // a k16 step advances both starts 32 bytes
    wgmma_bf16::mma<N>(acc, da + 2 * j, db + 2 * j, j > 0);
  wgmma::commit();
  wgmma::wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) wgmma::fence_operand(acc[i]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * t + (i % 2);
    d[row * N + col] = acc[i];
  }
}

}  // namespace

extern "C" int ganspace_wgmma_tile_bf16(const float* a, const void* b_img, float* d, int n,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(b_img);
  if (n == 144)
    wgmma_tile_bf16_kernel<144><<<1, 128, 0, s>>>(a, b, d);
  else if (n == 256)
    wgmma_tile_bf16_kernel<256><<<1, 128, 0, s>>>(a, b, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ganspace_wgmma_tile(const float* a, const float* b_hi, const float* b_lo,
                                   float* d, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 144)
    wgmma_tile_kernel<144><<<1, 128, 0, s>>>(a, b_hi, b_lo, d);
  else if (n == 128)
    wgmma_tile_kernel<128><<<1, 128, 0, s>>>(a, b_hi, b_lo, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
