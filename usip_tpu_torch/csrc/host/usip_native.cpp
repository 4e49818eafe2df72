// usip_native: the host data-path library of usip_tpu_torch (the port's own
// copy of usip_tpu's native/usip_native.cpp: the same C ABI and the same
// draws, so one seed gives both packages the same batches).
//
// The reference implements its hot CPU paths as native code (pthread index_max in
// models/index_max_ext/index_max.cpp:33-70) and leans on DataLoader worker
// processes for load+FPS+subsample (SURVEY.md §3.1). On the card the device-side
// kernels are the CUDA sources of usip_tpu_torch/csrc; this library is the native
// equivalent of the *host* runtime: .npy loading, fixed-size subsampling,
// farthest-point sampling, greedy NMS, and a thread-pooled batch loader, exposed
// through a C ABI consumed via ctypes (usip_tpu_torch/native.py).
//
// Build: usip_tpu_torch/_build.py build_host (g++, at first use, into build/).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <random>
#include <string>
#include <thread>
#include <vector>

#if defined(__F16C__)
#include <immintrin.h>
#endif

// fp32 -> fp16 (round-to-nearest-even, matching numpy astype(float16)).
// Hardware F16C when the build has it (-march=native on any modern x86);
// portable bit-twiddling fallback otherwise.
static void f32_to_f16(const float* src, int64_t n, uint16_t* dst) {
#if defined(__F16C__)
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m256 v = _mm256_loadu_ps(src + i);
    __m128i h = _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT |
                                       _MM_FROUND_NO_EXC);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i), h);
  }
  for (; i < n; ++i)
    dst[i] = _cvtss_sh(src[i], _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
#else
  for (int64_t i = 0; i < n; ++i) {
    uint32_t x;
    std::memcpy(&x, src + i, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
    uint32_t mant = x & 0x7FFFFFu;
    uint16_t h;
    if (((x >> 23) & 0xFF) == 0xFF) {           // inf / nan
      h = (uint16_t)(sign | 0x7C00u | (mant ? 0x200u : 0));
    } else if (exp >= 0x1F) {                   // overflow -> inf
      h = (uint16_t)(sign | 0x7C00u);
    } else if (exp <= 0) {                      // subnormal / zero
      if (exp < -10) {
        h = (uint16_t)sign;
      } else {
        mant |= 0x800000u;
        int shift = 14 - exp;
        uint32_t half = mant >> shift;
        uint32_t rem = mant & ((1u << shift) - 1);
        uint32_t mid = 1u << (shift - 1);
        if (rem > mid || (rem == mid && (half & 1))) half++;
        h = (uint16_t)(sign | half);
      }
    } else {
      uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
      uint32_t rem = mant & 0x1FFFu;
      if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
      h = (uint16_t)(sign | half);
    }
    dst[i] = h;
  }
#endif
}

extern "C" {

// ---------------------------------------------------------------- RNG -------
// xorshift128+ for reproducible, fast per-call randomness.
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed * 0x9E3779B97F4A7C15ull + 1;
    s1 = (seed ^ 0xBF58476D1CE4E5B9ull) * 0x94D049BB133111EBull + 1;
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
};

// -------------------------------------------------------------- subsample ---
// Random subset of exactly `target` rows from (n, c) float32 data; pads by
// whole-array repetition when short (matches data/common.py subsample_fixed and
// the reference's fix_idx loop, kitti_detector_loader.py:126-133).
void usip_subsample(const float* data, int64_t n, int64_t c, int64_t target,
                    uint64_t seed, float* out) {
  Rng rng(seed);
  if (n >= target) {
    // partial Fisher-Yates over an index array for a no-replacement subset
    std::vector<int64_t> idx(n);
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    for (int64_t i = 0; i < target; ++i) {
      int64_t j = i + (int64_t)rng.below((uint64_t)(n - i));
      std::swap(idx[i], idx[j]);
    }
    for (int64_t i = 0; i < target; ++i)
      std::memcpy(out + i * c, data + idx[i] * c, sizeof(float) * c);
    return;
  }
  // short cloud: whole-array repetition + a no-replacement remainder, then a
  // full shuffle — downstream slice-mode device sampling takes prefix/suffix
  // crops and requires uniformly random row order (data/common.py contract)
  std::vector<int64_t> sel((size_t)target);
  int64_t filled = 0;
  while (filled + n <= target) {
    for (int64_t i = 0; i < n; ++i) sel[(size_t)(filled + i)] = i;
    filled += n;
  }
  int64_t remain = target - filled;
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  for (int64_t i = 0; i < remain; ++i) {
    int64_t j = i + (int64_t)rng.below((uint64_t)(n - i));
    std::swap(idx[i], idx[j]);
  }
  for (int64_t i = 0; i < remain; ++i) sel[(size_t)(filled + i)] = idx[i];
  for (int64_t i = target - 1; i > 0; --i) {
    int64_t j = (int64_t)rng.below((uint64_t)(i + 1));
    std::swap(sel[(size_t)i], sel[(size_t)j]);
  }
  for (int64_t i = 0; i < target; ++i)
    std::memcpy(out + i * c, data + sel[(size_t)i] * c, sizeof(float) * c);
}

// ------------------------------------------------------------------- FPS ----
// Farthest point sampling over (n, 3) points -> k samples; same recurrence as
// the reference's FarthestSampler (modelnet_shrec_loader.py:115-129).
void usip_fps(const float* pts, int64_t n, int64_t k, uint64_t seed,
              float* out_pts, int64_t* out_idx) {
  Rng rng(seed);
  std::vector<float> dist(n);
  int64_t cur = (int64_t)rng.below((uint64_t)n);
  out_idx[0] = cur;
  std::memcpy(out_pts, pts + cur * 3, sizeof(float) * 3);
  const float* p0 = pts + cur * 3;
  for (int64_t i = 0; i < n; ++i) {
    float dx = pts[i * 3] - p0[0], dy = pts[i * 3 + 1] - p0[1],
          dz = pts[i * 3 + 2] - p0[2];
    dist[i] = dx * dx + dy * dy + dz * dz;
  }
  for (int64_t s = 1; s < k; ++s) {
    int64_t far = 0;
    float best = -1.f;
    for (int64_t i = 0; i < n; ++i)
      if (dist[i] > best) { best = dist[i]; far = i; }
    out_idx[s] = far;
    const float* pf = pts + far * 3;
    std::memcpy(out_pts + s * 3, pf, sizeof(float) * 3);
    for (int64_t i = 0; i < n; ++i) {
      float dx = pts[i * 3] - pf[0], dy = pts[i * 3 + 1] - pf[1],
            dz = pts[i * 3 + 2] - pf[2];
      float d = dx * dx + dy * dy + dz * dz;
      if (d < dist[i]) dist[i] = d;
    }
  }
}

// ------------------------------------------------------------------- NMS ----
// Greedy sigma-ascending NMS (save_keypoints.py:180-216). Returns kept count;
// writes kept keypoints/sigmas in selection order.
int64_t usip_nms(const float* kp, const float* sigmas, int64_t m, float radius,
                 float* out_kp, float* out_sig) {
  std::vector<char> alive(m, 1);
  std::vector<int64_t> order(m);
  for (int64_t i = 0; i < m; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return sigmas[a] < sigmas[b]; });
  int64_t kept = 0;
  float r2 = radius * radius;
  for (int64_t oi = 0; oi < m; ++oi) {
    int64_t i = order[oi];
    if (!alive[i]) continue;
    std::memcpy(out_kp + kept * 3, kp + i * 3, sizeof(float) * 3);
    out_sig[kept] = sigmas[i];
    ++kept;
    for (int64_t oj = oi + 1; oj < m; ++oj) {
      int64_t j = order[oj];
      if (!alive[j]) continue;
      float dx = kp[j * 3] - kp[i * 3], dy = kp[j * 3 + 1] - kp[i * 3 + 1],
            dz = kp[j * 3 + 2] - kp[i * 3 + 2];
      if (dx * dx + dy * dy + dz * dz <= r2) alive[j] = 0;
    }
  }
  return kept;
}

// ------------------------------------------------------------- npy reader ---
// Minimal .npy v1/v2 parser for C-contiguous little-endian f4/f8 2-D arrays.
// Returns 0 on success; fills rows/cols and writes float32 into `out` (caller
// allocates rows*cols floats after a probe call with out == nullptr).
int usip_npy_probe(const char* path, int64_t* rows, int64_t* cols) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return 1;
  char magic[6];
  f.read(magic, 6);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return 2;
  unsigned char ver[2];
  f.read((char*)ver, 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h;
    f.read((char*)&h, 2);
    hlen = h;
  } else {
    f.read((char*)&hlen, 4);
  }
  std::string header(hlen, '\0');
  f.read(&header[0], hlen);
  auto fpos = header.find("'shape':");
  if (fpos == std::string::npos) return 3;
  auto open = header.find('(', fpos);
  auto close = header.find(')', open);
  std::string shape = header.substr(open + 1, close - open - 1);
  int64_t r = 0, c = 1;
  if (sscanf(shape.c_str(), "%ld, %ld", &r, &c) < 1) return 4;
  *rows = r;
  *cols = c;
  return 0;
}

int usip_npy_read_f32(const char* path, float* out, int64_t capacity) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return 1;
  char magic[6];
  f.read(magic, 6);
  unsigned char ver[2];
  f.read((char*)ver, 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h;
    f.read((char*)&h, 2);
    hlen = h;
  } else {
    f.read((char*)&hlen, 4);
  }
  std::string header(hlen, '\0');
  f.read(&header[0], hlen);
  bool f8 = header.find("<f8") != std::string::npos;
  bool f4 = header.find("<f4") != std::string::npos;
  if (!f4 && !f8) return 5;
  if (header.find("'fortran_order': True") != std::string::npos) return 6;
  auto fpos = header.find("'shape':");
  auto open = header.find('(', fpos);
  auto close = header.find(')', open);
  std::string shape = header.substr(open + 1, close - open - 1);
  int64_t r = 0, c = 1;
  if (sscanf(shape.c_str(), "%ld, %ld", &r, &c) < 1) return 4;
  int64_t count = r * c;
  if (count > capacity) return 7;
  if (f4) {
    f.read((char*)out, count * 4);
  } else {
    std::vector<double> tmp(count);
    f.read((char*)tmp.data(), count * 8);
    for (int64_t i = 0; i < count; ++i) out[i] = (float)tmp[i];
  }
  return f.good() || f.eof() ? 0 : 8;
}

// -------------------------------------------- thread-pooled batch loading ---
// Load B npy files, subsample each to `target` rows, split xyz / sn channels.
// paths: B concatenated zero-terminated strings. Returns 0 on success.
// as_half: outputs are uint16-encoded fp16 (the engine's float16 wire encoded
// here, GIL-free and F16C-accelerated, instead of a numpy astype pass on the
// prefetch thread — PERFORMANCE.md "wire format A/B").
static int batch_load_core(const char* const* paths, int64_t batch,
                           int64_t target, int64_t sn_len, uint64_t seed,
                           int threads, int as_half, void* out_pc,
                           void* out_sn) {
  std::atomic<int64_t> next(0);
  std::atomic<int> status(0);
  int nthreads = threads > 0 ? threads
                             : (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, (int)batch));

  auto worker = [&]() {
    std::vector<float> buf;
    std::vector<float> sub;
    std::vector<float> row_pc, row_sn;
    row_pc.resize((size_t)(target * 3));
    if (sn_len > 0) row_sn.resize((size_t)(target * sn_len));
    while (true) {
      int64_t b = next.fetch_add(1);
      if (b >= batch || status.load() != 0) break;
      int64_t rows = 0, cols = 0;
      if (usip_npy_probe(paths[b], &rows, &cols) != 0) {
        status.store(10);
        break;
      }
      // sn_len==1 reads the LAST column (reflectance mode); otherwise the
      // split needs 3 coord + sn_len normal columns — reject short rows
      // instead of overreading into the next row / past the buffer
      int64_t need = sn_len == 1 ? 4 : 3 + sn_len;
      if (cols < need) {
        status.store(12);
        break;
      }
      buf.resize((size_t)(rows * cols));
      if (usip_npy_read_f32(paths[b], buf.data(), rows * cols) != 0) {
        status.store(11);
        break;
      }
      sub.resize((size_t)(target * cols));
      usip_subsample(buf.data(), rows, cols, target, seed + (uint64_t)b * 7919,
                     sub.data());
      float* pc = as_half ? row_pc.data()
                          : (float*)out_pc + b * target * 3;
      float* sn = as_half ? row_sn.data()
                          : (float*)out_sn + b * target * sn_len;
      for (int64_t i = 0; i < target; ++i) {
        std::memcpy(pc + i * 3, &sub[(size_t)(i * cols)], sizeof(float) * 3);
        if (sn_len == 1) {
          sn[i] = sub[(size_t)(i * cols + cols - 1)];
        } else if (sn_len > 0) {
          std::memcpy(sn + i * sn_len, &sub[(size_t)(i * cols + 3)],
                      sizeof(float) * sn_len);
        }
      }
      if (as_half) {
        f32_to_f16(pc, target * 3, (uint16_t*)out_pc + b * target * 3);
        if (sn_len > 0)
          f32_to_f16(sn, target * sn_len,
                     (uint16_t*)out_sn + b * target * sn_len);
      }
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return status.load();
}

int usip_batch_load_subsample(const char* const* paths, int64_t batch,
                              int64_t target, int64_t sn_len, uint64_t seed,
                              int threads, float* out_pc, float* out_sn) {
  return batch_load_core(paths, batch, target, sn_len, seed, threads, 0,
                         out_pc, out_sn);
}

int usip_batch_load_subsample_f16(const char* const* paths, int64_t batch,
                                  int64_t target, int64_t sn_len,
                                  uint64_t seed, int threads,
                                  uint16_t* out_pc, uint16_t* out_sn) {
  return batch_load_core(paths, batch, target, sn_len, seed, threads, 1,
                         out_pc, out_sn);
}

}  // extern "C"
