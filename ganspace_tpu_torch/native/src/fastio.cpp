// fastio: native async image-writer pool for ganspace_tpu_torch, a copy of
// ganspace_tpu/native/src/fastio.cpp (host code: no device, no JAX).
//
// Replaces the reference's fork-based WorkerPool
// (netdissect/workerpool.py:35-157), which exists to keep image encoding and
// disk IO off the hot path.  A fork pool costs a full process image per
// worker and pickles every frame across the pipe; this is a std::thread pool
// inside the process — frames arrive as raw uint8 buffers via ctypes (no
// copies beyond the enqueue snapshot), PNG encoding (zlib) and file writes
// happen off the GIL, and completion is observable via wait().
//
// C ABI (consumed by ganspace_tpu_torch/native/__init__.py via ctypes):
//   void*  fastio_pool_create(int n_threads);
//   int    fastio_submit_png(void* pool, const char* path,
//                            const uint8_t* rgb, int h, int w, int c);
//   int    fastio_submit_raw(void* pool, const char* path,
//                            const uint8_t* data, long n_bytes);
//   void   fastio_pool_wait(void* pool);      // barrier: queue drained
//   long   fastio_pool_errors(void* pool);    // failed jobs so far
//   void   fastio_pool_destroy(void* pool);   // join + free
//
// PNG writer: minimal, correct subset — 8-bit RGB/RGBA/gray, filter 0,
// one zlib-deflated IDAT.  Matches what the visualization pipeline needs;
// everything else stays with PIL on the Python side.  An image of more
// than kSplitBytes deflates in pieces on threads of its own, each piece a
// raw deflate stream ended by a full flush (the last by the final block),
// joined under one zlib header with the combined Adler-32: one valid
// stream, as pigz writes it.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal PNG encoder
// ---------------------------------------------------------------------------

constexpr size_t kSplitBytes = 8u << 20;   // deflate in pieces above this
constexpr size_t kPieceBytes = 4u << 20;   // scanline bytes per piece

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, static_cast<uInt>(len + 4));
  put_be32(out, crc);
}

// One piece of a split deflate: raw deflate (no header) at level 6.
bool deflate_piece(const uint8_t* in, size_t n, bool last, std::vector<uint8_t>& out) {
  z_stream zs{};
  if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK) return false;
  out.resize(deflateBound(&zs, static_cast<uLong>(n)) + 16);
  zs.next_in = const_cast<uint8_t*>(in);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = deflate(&zs, last ? Z_FINISH : Z_FULL_FLUSH);
  bool ok = last ? rc == Z_STREAM_END : (rc == Z_OK && zs.avail_in == 0);
  out.resize(zs.total_out);
  deflateEnd(&zs);
  return ok;
}

// The zlib stream of ``raw``: one compress2 call, or pieces on threads.
bool deflate_zlib(const std::vector<uint8_t>& raw, std::vector<uint8_t>& out) {
  if (raw.size() <= kSplitBytes) {
    uLongf bound = compressBound(static_cast<uLong>(raw.size()));
    out.resize(bound);
    if (compress2(out.data(), &bound, raw.data(), static_cast<uLong>(raw.size()), 6) != Z_OK) {
      return false;
    }
    out.resize(bound);
    return true;
  }
  const size_t n = (raw.size() + kPieceBytes - 1) / kPieceBytes;
  std::vector<std::vector<uint8_t>> parts(n);
  std::vector<uLong> adlers(n);
  std::atomic<bool> ok{true};
  std::atomic<size_t> next{0};
  auto work = [&]() {
    for (size_t i = next++; i < n; i = next++) {
      const size_t off = i * kPieceBytes;
      const size_t len = std::min(kPieceBytes, raw.size() - off);
      adlers[i] = adler32(1L, raw.data() + off, static_cast<uInt>(len));
      if (!deflate_piece(raw.data() + off, len, i + 1 == n, parts[i])) ok = false;
    }
  };
  const size_t k = std::min<size_t>(n, std::max(1u, std::thread::hardware_concurrency()));
  std::vector<std::thread> threads;
  for (size_t t = 0; t < k; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  if (!ok) return false;
  out.assign({0x78, 0x9c});            // deflate, 32K window, default level
  uLong adler = adlers[0];
  for (size_t i = 0; i < n; ++i) {
    out.insert(out.end(), parts[i].begin(), parts[i].end());
    if (i) {
      const size_t len = std::min(kPieceBytes, raw.size() - i * kPieceBytes);
      adler = adler32_combine(adler, adlers[i], static_cast<z_off_t>(len));
    }
  }
  put_be32(out, static_cast<uint32_t>(adler));
  return true;
}

bool encode_png(const uint8_t* pixels, int h, int w, int channels,
                std::vector<uint8_t>& out) {
  if (channels != 1 && channels != 3 && channels != 4) return false;
  static const uint8_t color_type[] = {0, 0, 0, 2, 6};  // gray, -, -, rgb, rgba

  out.clear();
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  out.insert(out.end(), magic, magic + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;                       // bit depth
  ihdr[9] = color_type[channels];
  ihdr[10] = ihdr[11] = ihdr[12] = 0;  // deflate, filter 0, no interlace
  put_chunk(out, "IHDR", ihdr, 13);

  // Raw scanlines with filter byte 0.
  const size_t stride = static_cast<size_t>(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;
    std::memcpy(&raw[y * (stride + 1) + 1], pixels + y * stride, stride);
  }

  std::vector<uint8_t> compressed;
  if (!deflate_zlib(raw, compressed)) return false;
  put_chunk(out, "IDAT", compressed.data(), compressed.size());
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

bool write_file(const std::string& path, const uint8_t* data, size_t len) {
  std::FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  size_t written = std::fwrite(data, 1, len, f);
  std::fclose(f);
  return written == len;
}

// ---------------------------------------------------------------------------
// Worker pool
// ---------------------------------------------------------------------------

class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false), pending_(0), errors_(0) {
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i) {
      threads_.emplace_back([this] { this->run(); });
    }
  }

  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void submit(std::function<bool()> job) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
      ++pending_;
    }
    cv_.notify_one();
  }

  void wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

  long errors() const { return errors_.load(); }

 private:
  void run() {
    for (;;) {
      std::function<bool()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
      }
      bool ok = false;
      try {
        ok = job();
      } catch (...) {
        ok = false;
      }
      if (!ok) errors_.fetch_add(1);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::queue<std::function<bool()>> jobs_;
  std::vector<std::thread> threads_;
  bool stop_;
  long pending_;
  std::atomic<long> errors_;
};

}  // namespace

extern "C" {

void* fastio_pool_create(int n_threads) { return new Pool(n_threads); }

int fastio_submit_png(void* pool, const char* path, const uint8_t* rgb,
                      int h, int w, int c) {
  if (!pool || !path || !rgb || h <= 0 || w <= 0) return -1;
  // Snapshot the pixels: the caller's buffer (numpy array) may be reused.
  std::vector<uint8_t> pixels(rgb, rgb + static_cast<size_t>(h) * w * c);
  std::string p(path);
  static_cast<Pool*>(pool)->submit([p = std::move(p),
                                    px = std::move(pixels), h, w, c]() {
    std::vector<uint8_t> png;
    if (!encode_png(px.data(), h, w, c, png)) return false;
    return write_file(p, png.data(), png.size());
  });
  return 0;
}

int fastio_submit_raw(void* pool, const char* path, const uint8_t* data,
                      long n_bytes) {
  if (!pool || !path || !data || n_bytes < 0) return -1;
  std::vector<uint8_t> buf(data, data + n_bytes);
  std::string p(path);
  static_cast<Pool*>(pool)->submit([p = std::move(p), b = std::move(buf)]() {
    return write_file(p, b.data(), b.size());
  });
  return 0;
}

void fastio_pool_wait(void* pool) { static_cast<Pool*>(pool)->wait(); }

long fastio_pool_errors(void* pool) { return static_cast<Pool*>(pool)->errors(); }

void fastio_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

}  // extern "C"
