// Error-compensated TF32 ("3xTF32") products on Hopper's tensor cores, and
// the cp.async helpers that stage their operands.
//
// Why three passes.  The TPU kernels this port replaces compute their
// float32 products at Precision.HIGHEST, which the TPU's matrix unit runs
// as several bf16 passes.  The H100's counterpart is 3xTF32: each float32
// operand is split into hi = tf32(a) and lo = tf32(a - hi), and the
// product is hi*hi + hi*lo + lo*hi on the TF32 tensor cores with float32
// accumulation (the lo*lo term is below float32's rounding).  At the port's
// main-path shapes this is as close to the exact product as IEEE float32
// FFMA is (tests/test_torch_port_tf32x3.py emulates it): the centered Gram
// at N = 4096, D = 512 and the modulated conv as a K = 4608 GEMM both stay
// more than 10x inside their bars.  A single TF32 pass keeps only about
// three decimal digits and misses both bars, which is why the port's
// float32 policy keeps TF32 off for cuBLAS and cuDNN.
//
// Kernel A and kernel B's 3x3 modes use warp-level mma.sync because every
// operand needs an element-wise transform between shared memory and the
// tensor core (the centering, the style scale, the split): mma.sync takes
// its fragments from registers, where that costs a few instructions.  The
// stride-2 mode splits its weight once per layer, so it reads B from shared
// memory through wgmma (wgmma_tf32.cuh) and transforms only A.

#pragma once

#include <cstdint>

namespace tf32x3 {

// Round to TF32 (10-bit mantissa), to nearest with ties away from zero:
// the rounding of cvt.rna.tf32.f32, which on sm_90 compiles to a guarded
// sequence of four or five instructions.  For finite x, adding half a TF32
// unit to the magnitude bits and clearing the 13 dropped bits gives the same
// bits in two integer instructions; this is the split's inner loop, so the
// difference shows in both kernels' times.  (An infinite x turns into a NaN
// here, and a NaN stays a NaN.)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (below float32 rounding), both halves TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a * b for one m16n8k8 tile.  Fragment layouts (g = lane / 4,
// t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[m][n] += a[m] * b[n] in 3xTF32 for an m x n grid of tiles: the two
// small products first, then the large one.  The products are issued pass
// by pass over the whole grid, so that m * n independent mma instructions
// stand between two that add into the same accumulator.
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[M][N][4], const uint32_t (&a_hi)[M][4],
                                           const uint32_t (&a_lo)[M][4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m) mma_tf32(d[m][n], a_lo[m], b_hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m) mma_tf32(d[m][n], a_hi[m], b_lo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m) mma_tf32(d[m][n], a_hi[m], b_hi[n]);
}

// Asynchronous global -> shared copies; a copy with ok == false writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n groups of this thread are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

}  // namespace tf32x3
