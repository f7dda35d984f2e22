// Launcher of the stride-2 kernel's bf16 datapath (upconv2x_bf16.cuh):
// modes 1 and 2 of ganspace_upsample_conv (upconv2x.cu).

#include "upconv2x_bf16.cuh"

namespace upconv_bf16 {

namespace {

template <int kK, typename TX>
cudaError_t launch(const TX* x, const __nv_bfloat16* wimg, const float* s, const float* dmod,
                   TX* y, const Tiling& T, const CUtensorMap& xmap, cudaStream_t stream) {
  constexpr int kBytes = Layout<kK, TX>::kBytes;
  static_assert(kBytes <= kMaxSmem, "the rings do not fit in shared memory");
  auto kernel = upconv_bf16_kernel<kK, TX>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = T.tiles < sms ? T.tiles : sms;  // one block per SM
  kernel<<<blocks, kThreads, kBytes, stream>>>(x, wimg, s, dmod, y, T, xmap);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_for(int k, const void* x, const void* wimg, const float* s,
                       const float* dmod, void* y, const Tiling& T, const CUtensorMap& xmap,
                       cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(wimg);
  TX* yt = static_cast<TX*>(y);
  return k == 3 ? launch<3, TX>(xt, wt, s, dmod, yt, T, xmap, stream)
                : launch<4, TX>(xt, wt, s, dmod, yt, T, xmap, stream);
}

// cuTensorMapEncodeTiled of libcuda, found once through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of x for the tiling's box: whole samples as a 3-d view
// [b][c][h * w] with a box of [spt][64][h * w], or rows as the 4-d x
// [b][c][h][w] with a box of [1][64][lr][rw] (its columns from j0 - hc -
// coff, a 16-byte boundary).  False where x's strides or the tile's columns
// are not multiples of 16 bytes (or libcuda refuses the map).
bool x_map(CUtensorMap* map, const void* x, const Tiling& T, bool bf16) {
  const int es = bf16 ? 2 : 4;
  const bool whole = T.hr == 0 && T.hc == 0;
  const long long hw = static_cast<long long>(T.h) * T.w;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(x) % 16 != 0) return false;
  const CUtensorMapDataType dt =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r;
  if (whole) {
    if (hw * es % 16 != 0 || T.rw != hw) return false;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hw), static_cast<cuuint64_t>(T.c),
                                static_cast<cuuint64_t>(T.b)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hw * es),
                                   static_cast<cuuint64_t>(hw * es * T.c)};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(hw), kKC,
                               static_cast<cuuint32_t>(T.spt)};
    r = fn(map, dt, 3, const_cast<void*>(x), dims, strides, box, ones,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    if (static_cast<long long>(T.w) * es % 16 != 0 || T.rw > 256
        || (T.hc && T.tc % (16 / es) != 0))
      return false;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(T.w), static_cast<cuuint64_t>(T.h),
                                static_cast<cuuint64_t>(T.c), static_cast<cuuint64_t>(T.b)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(T.w) * es,
                                   static_cast<cuuint64_t>(hw * es),
                                   static_cast<cuuint64_t>(hw * es * T.c)};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(T.rw), static_cast<cuuint32_t>(T.lr),
                               kKC, 1};
    r = fn(map, dt, 4, const_cast<void*>(x), dims, strides, box, ones,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS;
}

}  // namespace

cudaError_t upsample_conv(const void* x, const void* wimg, const float* s, const float* dmod,
                          void* y, const int* tiling, int b, int c, int h, int w, int co, int k,
                          int p, bool bf16_storage, cudaStream_t stream) {
  Tiling T = {};
  T.b = b, T.c = c, T.h = h, T.w = w, T.co = co, T.p = p;
  T.oh = 2 * h + k - 2 - 2 * p, T.ow = 2 * w + k - 2 - 2 * p;
  T.spt = tiling[0];
  T.tr = tiling[1], T.lr = tiling[2], T.hr = tiling[3], T.tiles_r = tiling[4];
  T.tc = tiling[5], T.lc = tiling[6], T.hc = tiling[7], T.tiles_c = tiling[8];
  T.n_co = (co + kCoT - 1) / kCoT;
  T.chunks = (c + kKC - 1) / kKC;
  T.has_s = s != nullptr;
  bool ok = (k == 3 || k == 4) && (p == 0 || p == 1) && b > 0 && c > 0 && co > 0 && h > 0
            && w > 0 && T.spt >= 1 && T.spt <= kMaxSpt && T.lr * T.lc * T.spt <= kM
            && T.tr >= 1 && T.tc >= 1 && (T.hr == 0 || T.hr == 1) && (T.hc == 0 || T.hc == 1)
            && T.lr == T.tr + T.hr && T.lc == T.tc + T.hc
            && (T.hr == 1 || T.tr == h) && (T.hc == 1 || T.tc == w)
            && T.tiles_r == (h + T.tr - 1) / T.tr && T.tiles_c == (w + T.tc - 1) / T.tc
            && (T.spt == 1 || (T.hr == 0 && T.hc == 0))
            && static_cast<long long>(b) * c * h * w < (1LL << 31)
            && reinterpret_cast<uintptr_t>(wimg) % 16 == 0;
  if (!ok) return cudaErrorInvalidValue;
  // the raw layout of a stage (Tiling): runs of a multiple of 16 bytes
  const int es = bf16_storage ? 2 : 4, kv = 16 / es;
  if (T.hr == 0 && T.hc == 0) {
    T.rw = (h * w + kv - 1) / kv * kv;
    T.cs = T.rw, T.ss = kKC * T.rw;
    T.run = h * w, T.runs = T.spt;
    T.box_bytes = T.spt * kKC * h * w * es;
    ok = T.spt * T.rw <= kRawPix;
  } else {
    T.coff = T.hc ? kv - 1 : 0;
    T.rw = (T.coff + T.lc + kv - 1) / kv * kv;
    T.cs = T.lr * T.rw, T.ss = 0;
    T.run = T.lc, T.runs = T.lr;
    T.box_bytes = kKC * T.lr * T.rw * es;
    ok = T.lr * T.rw <= kRawPix;
  }
  T.m_run = div_magic(T.run), T.m_runs = div_magic(T.runs);
  // the output pairs of a tile's overlap-add index below 2^16 (fast_div)
  const long long pairs = static_cast<long long>(T.spt) * (2 * T.lr + 2) * (T.lc + 2);
  ok = ok && T.run < (1 << 16) && pairs < (1 << 16);
  const long long tiles = static_cast<long long>((b + T.spt - 1) / T.spt) * T.tiles_r
                          * T.tiles_c * T.n_co;
  if (!ok || tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  T.tiles = static_cast<int>(tiles);
  CUtensorMap xmap = {};
  T.tma = x_map(&xmap, x, T, bf16_storage);
  return bf16_storage ? launch_for<__nv_bfloat16>(k, x, wimg, s, dmod, y, T, xmap, stream)
                      : launch_for<float>(k, x, wimg, s, dmod, y, T, xmap, stream);
}

}  // namespace upconv_bf16
