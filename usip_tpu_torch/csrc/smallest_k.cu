// Exact k smallest entries of each row: values ascending and their indices.
//
// Replaces usip_tpu/ops/pallas_kernels.py smallest_k_pallas /
// _smallest_k_kernel (iterative min-extraction on a VMEM-resident row tile).
//
// Order: ascending value, ties to the lowest index. Non-finite entries (+inf,
// -inf, NaN) are "absent": they come after every finite entry, in ascending
// index order, with value +inf (the Pallas kernel's sentinel encoding; it
// diverges from lax.top_k for -inf and NaN, and this kernel keeps that).
// -0.0 and +0.0 tie (broken by index) and come back as they were given.
// Picks past the row's end (k > N) get index N-1 and value +inf, the Pallas
// kernel's clamp of its lane padding.
//
// What bounds it on the H100: bytes. Each row is read from device memory
// once (64 KiB at N=16384; 268 MB for the (8, 512, 16384) ball selection,
// 0.08 ms at 3.35 TB/s); the selection itself is a few passes over shared
// memory or registers.
//
// What the design does about it: a select by threshold, not k dependent
// rounds of an argmin. Every value becomes an order-preserving uint32 key
// (sign bit flipped, or all bits for a negative; -0.0 -> the key of +0.0;
// non-finite -> the key of +inf), so that the (key, index) order is the
// contract's order. Then:
//   1. find T, the k-th smallest key, and c_less, the count of keys below it;
//   2. compact the candidates: every key < T, and the first k - c_less keys
//      equal to T in index order (the ball scores hold thousands of tied +inf
//      keys per row, so the tie order matters);
//   3. sort the k candidates by (key, index) and write the original values
//      (read again from the row, so a -0.0 stays -0.0).
// Two forms, chosen by the host per call:
//   * long rows (or k > 32): one block per row, the keys in shared memory;
//     T by a 4 x 8-bit radix select. The first pass is counted while the
//     row loads; the later passes run over a list of the keys in the first
//     pass's bin (at most 2048; past that, over the row again), and not at
//     all when that bin holds only +inf keys (T is +inf: a ball with fewer
//     than k points). Histogram counts are warp-aggregated: a warp whose
//     keys share one bin counts them in a register, else __match_any_sync
//     groups the lanes, one shared atomic per group. The candidates: where
//     every key up to T fits 1024 slots, one unordered scan gathers them
//     with their indices and the sort by (key, index) orders the ties; else
//     each warp takes a contiguous segment of the row, so that per-warp
//     counts and ballots keep index order. A bitonic sort of the candidates;
//   * short rows (N <= 1024, k <= 32, the node kNN's (512, k=16)): one warp
//     per row, 8 rows a block, the row in registers (E keys a lane); T by a
//     32-step bitwise search with warp-wide sums (__reduce_add_sync), no
//     block barrier at all; a warp bitonic sort of the <= 32 candidates in
//     registers.
// What holds the block form at ~3x its bound (measured on an H100, see
// PERF.md): instructions, not bytes. Each of its passes over the row in
// shared memory (the first histogram with the loads, the list, the
// candidates) costs a few warp votes per key.

#include <cuda_runtime.h>
#include <cstdint>
#include <cmath>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBins = 256;
constexpr int kRowWarps = 8;  // rows (warps) per block in the warp form
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kInfKey = 0xff800000u;  // the key of +inf
constexpr uint32_t kPadKey = 0xffffffffu;  // above every real key
constexpr size_t kMaxSmem = 232448;  // shared memory a block may take
constexpr size_t kStaticSmem = 256;  // the block form's static part, rounded
constexpr int kListCap = 2048;  // keys of the first pass's bin kept aside
// candidates one unordered scan may gather, in the list's room
constexpr int kGatherCap = 1024;
static_assert(kBins * 2 + kListCap * 4 >= kGatherCap * 8, "gather room");

__device__ __forceinline__ uint32_t to_key(float v) {
  if (!isfinite(v)) return kInfKey;
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0) u = 0;  // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float out_value(const float* row, int i) {
  const float v = row[i];
  return isfinite(v) ? v : INFINITY;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// ------------------------------------------------------- block per row --

// Counts a warp's bins (kBins: no bin) into hist, two 16-bit counts a
// word. No atomic when no lane has a bin; a register count (`run` of
// `run_bin`, warp-wide) while the warp's bins stay one (runs of +inf, of
// tied values); else one atomic per group of lanes __match_any_sync finds.
struct BinCounter {
  uint32_t* hist;
  int lane;
  int run_bin = kBins;
  uint32_t run = 0;

  __device__ __forceinline__ void add(int bin) {
    const unsigned valid = __ballot_sync(kFull, bin < kBins);
    if (valid == 0) return;
    const int lead_bin = __shfl_sync(kFull, bin, __ffs(valid) - 1);
    if (__all_sync(kFull, bin == lead_bin || bin == kBins)) {
      if (lead_bin != run_bin) {
        flush();
        run_bin = lead_bin;
      }
      run += __popc(valid);
      return;
    }
    const unsigned peers = __match_any_sync(kFull, bin);
    if (bin < kBins && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[bin >> 1], static_cast<uint32_t>(__popc(peers))
                                     << (16 * (bin & 1)));
    }
  }
  __device__ __forceinline__ void flush() {
    if (lane == 0 && run) {
      atomicAdd(&hist[run_bin >> 1], run << (16 * (run_bin & 1)));
    }
    run = 0;
  }
};

// counts the bin (key >> shift) & 0xff of every key of arr[0, m) inside
// the prefix
__device__ __forceinline__ void radix_hist(const uint32_t* arr, int m,
                                           uint32_t prefix, uint32_t mask,
                                           int shift, uint32_t* hist,
                                           int tid, int nthreads, int lane) {
  BinCounter count{hist, lane};
  for (int i0 = 0; i0 < m; i0 += nthreads) {
    const int i = i0 + tid;
    int bin = kBins;  // no bin: past the end or outside the prefix
    if (i < m) {
      const uint32_t key = arr[i];
      if ((key & mask) == prefix) bin = (key >> shift) & 0xff;
    }
    count.add(bin);
  }
  count.flush();
}

// one warp: the bin that holds the krem-th key, the count below it and in it
__device__ __forceinline__ void pick_bin(const uint32_t* hist, int krem,
                                         uint32_t* sel, int lane) {
  uint32_t part[8];
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    part[j] = (hist[lane * 4 + j / 2] >> (16 * (j & 1))) & 0xffffu;
    s += part[j];
  }
  uint32_t incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  uint32_t below = incl - s;
  const uint32_t want = static_cast<uint32_t>(krem);
  if (below < want && want <= incl) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (below + part[j] >= want) {
        sel[0] = lane * 8 + j;
        sel[1] = below;
        sel[2] = part[j];
        break;
      }
      below += part[j];
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
smallest_k_block(const float* __restrict__ scores, float* __restrict__ vals,
                 int* __restrict__ idx, int n, int k, int sort_len,
                 int list_cap, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  // after the keys (n rounded up to 4): during the select, the histogram
  // (two 16-bit counts a word: a row holds fewer than 65536 keys) and the
  // list of the keys in the first pass's bin (list_cap of them, 0 where
  // they do not fit); then the candidates (key << 32 | index) for the sort
  unsigned char* aux = smem + static_cast<size_t>((n + 3) & ~3) * 4;
  uint32_t* hist = reinterpret_cast<uint32_t*>(aux);
  uint32_t* list = hist + kBins / 2;
  uint64_t* cand = reinterpret_cast<uint64_t*>(aux);
  __shared__ uint32_t sel[3];  // bin, count below it, count in it
  __shared__ int n_inf, list_len;
  __shared__ int warp_lt[kMaxWarps], warp_eq[kMaxWarps];

  const size_t r = blockIdx.x;
  const float* src = scores + r * n;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int keff = k < n ? k : n;

  if (tid == 0) {
    n_inf = 0;
    list_len = 0;
  }
  for (int b = tid; b < kBins / 2; b += nthreads) hist[b] = 0;
  __syncthreads();
  // the row -> keys in shared memory, counting the +inf keys and, while
  // the loads are in flight, the first radix pass (the top 8 bits)
  int my_inf = 0;
  BinCounter top{hist, lane};
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    uint4* k4 = reinterpret_cast<uint4*>(keys);
    for (int i0 = 0; i0 < n / 4; i0 += nthreads) {
      const int i = i0 + tid;
      uint4 kk = make_uint4(kPadKey, kPadKey, kPadKey, kPadKey);
      if (i < n / 4) {
        const float4 v = s4[i];
        kk = make_uint4(to_key(v.x), to_key(v.y), to_key(v.z), to_key(v.w));
        k4[i] = kk;
      }
      my_inf += (kk.x == kInfKey) + (kk.y == kInfKey) + (kk.z == kInfKey) +
                (kk.w == kInfKey);
      top.add(kk.x == kPadKey ? kBins : static_cast<int>(kk.x >> 24));
      top.add(kk.y == kPadKey ? kBins : static_cast<int>(kk.y >> 24));
      top.add(kk.z == kPadKey ? kBins : static_cast<int>(kk.z >> 24));
      top.add(kk.w == kPadKey ? kBins : static_cast<int>(kk.w >> 24));
    }
  } else {
    for (int i0 = 0; i0 < n; i0 += nthreads) {
      const int i = i0 + tid;
      const uint32_t key = i < n ? to_key(src[i]) : kPadKey;
      if (i < n) keys[i] = key;
      my_inf += key == kInfKey;
      top.add(key == kPadKey ? kBins : static_cast<int>(key >> 24));
    }
  }
  top.flush();
  my_inf = static_cast<int>(__reduce_add_sync(kFull, my_inf));
  if (lane == 0 && my_inf) atomicAdd(&n_inf, my_inf);
  __syncthreads();

  // 1. radix select of the keff-th smallest key, 8 bits a pass: the first
  // pass over the row; the others over the list of the first pass's bin
  // where it fits, else over the row again
  uint32_t prefix = 0, mask = 0;
  int krem = keff, c_less = 0;
  int n_eq_all = 0;  // the keys equal to the prefix's bin after the pass
  const uint32_t* arr = keys;
  int m = n;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (shift != 24) {  // the first pass was counted with the loads
      for (int b = tid; b < kBins / 2; b += nthreads) hist[b] = 0;
      __syncthreads();
      radix_hist(arr, m, prefix, mask, shift, hist, tid, nthreads, lane);
      __syncthreads();
    }
    if (warp == 0) pick_bin(hist, krem, sel, lane);
    __syncthreads();
    prefix |= sel[0] << shift;
    mask |= 0xffu << shift;
    krem -= static_cast<int>(sel[1]);
    c_less += static_cast<int>(sel[1]);
    n_eq_all = static_cast<int>(sel[2]);
    if (shift != 24) continue;
    // the bin of +inf keys holds nothing else: T is +inf
    if (prefix == (kInfKey & 0xff000000u) && n_eq_all == n_inf) {
      prefix = kInfKey;
      break;
    }
    if (static_cast<int>(sel[2]) <= list_cap) {
      for (int i0 = 0; i0 < n; i0 += nthreads) {
        const int i = i0 + tid;
        const uint32_t key = i < n ? keys[i] : kPadKey;
        const bool in = i < n && (key & mask) == prefix;
        const unsigned ballot = __ballot_sync(kFull, in);
        if (ballot == 0) continue;
        int base = 0;
        if (lane == 0) base = atomicAdd(&list_len, __popc(ballot));
        base = __shfl_sync(kFull, base, 0);
        if (in) list[base + __popc(ballot & lanemask_lt())] = key;
      }
      __syncthreads();
      arr = list;
      m = static_cast<int>(sel[2]);
    }
  }
  const uint32_t t_key = prefix;  // the keff-th smallest key
  const int need_eq = krem;       // keys equal to T that are picked, >= 1

  // 2. the candidates. Where every key <= T fits the buffer (all rows but
  // those whose ties at T run long, such as balls of fewer than k points),
  // one scan gathers them unordered with their indices: the sort by (key,
  // index) puts the ties in index order. Else the first need_eq keys equal
  // to T are taken in index order: warp w owns keys [w * seg, (w + 1) * seg)
  int len = sort_len;  // candidates to sort, a power of two
  if (list_cap > 0 && c_less + n_eq_all <= kGatherCap) {
    if (tid == 0) list_len = 0;
    __syncthreads();  // also: the histogram and list are dead
    for (int i0 = 0; i0 < n; i0 += nthreads) {
      const int i = i0 + tid;
      const uint32_t key = i < n ? keys[i] : kPadKey;
      const bool in = key <= t_key;
      const unsigned ballot = __ballot_sync(kFull, in);
      if (ballot == 0) continue;
      int base = 0;
      if (lane == 0) base = atomicAdd(&list_len, __popc(ballot));
      base = __shfl_sync(kFull, base, 0);
      if (in) {
        cand[base + __popc(ballot & lanemask_lt())] =
            (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(i);
      }
    }
    for (len = 1; len < c_less + n_eq_all; len <<= 1) {
    }
    for (int j = c_less + n_eq_all + tid; j < len; j += nthreads) {
      cand[j] = ~0ull;
    }
  } else {
    const int seg = ((n + nwarps * 32 - 1) / (nwarps * 32)) * 32;
    const int lo = warp * seg;
    const int hi = min(n, lo + seg);
    int n_lt = 0, n_eq = 0;
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const uint32_t key = i < hi ? keys[i] : kPadKey;
      n_lt += __popc(__ballot_sync(kFull, key < t_key));
      n_eq += __popc(__ballot_sync(kFull, key == t_key));
    }
    if (lane == 0) {
      warp_lt[warp] = n_lt;
      warp_eq[warp] = n_eq;
    }
    __syncthreads();  // also: the histogram is dead, cand may overwrite it
    int base_lt = 0, base_eq = 0;
    for (int w = 0; w < warp; ++w) {
      base_lt += warp_lt[w];
      base_eq += warp_eq[w];
    }
    const unsigned below_me = lanemask_lt();
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const uint32_t key = i < hi ? keys[i] : kPadKey;
      const unsigned lt = __ballot_sync(kFull, key < t_key);
      const unsigned eq = __ballot_sync(kFull, key == t_key);
      const uint64_t packed = (static_cast<uint64_t>(key) << 32) |
                              static_cast<uint32_t>(i);
      if (key < t_key) cand[base_lt + __popc(lt & below_me)] = packed;
      if (key == t_key) {
        const int rank = base_eq + __popc(eq & below_me);
        if (rank < need_eq) cand[c_less + rank] = packed;
      }
      base_lt += __popc(lt);
      base_eq += __popc(eq);
    }
    for (int j = keff + tid; j < len; j += nthreads) cand[j] = ~0ull;
  }
  __syncthreads();

  // 3. bitonic sort of the len (a power of two >= keff) candidates
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < len / 2; t += nthreads) {
        const int a = 2 * t - (t & (stride - 1));
        const int b = a + stride;
        const bool up = (a & size) == 0;
        const uint64_t x = cand[a], y = cand[b];
        if ((x > y) == up) {
          cand[a] = y;
          cand[b] = x;
        }
      }
      __syncthreads();
    }
  }
  float* out_v = vals + r * k;
  int* out_i = idx + r * k;
  for (int j = tid; j < k; j += nthreads) {
    if (j < keff) {
      const int i = static_cast<int>(cand[j] & 0xffffffffu);
      out_i[j] = i;
      out_v[j] = out_value(src, i);
    } else {  // past the row's end: the lane-padding clamp
      out_i[j] = n - 1;
      out_v[j] = INFINITY;
    }
  }
}

// -------------------------------------------------------- warp per row --

template <int E>
__global__ void __launch_bounds__(kRowWarps * 32)
smallest_k_warp(const float* __restrict__ scores, float* __restrict__ vals,
                int* __restrict__ idx, int rows, int n, int k) {
  __shared__ uint64_t cand_all[kRowWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t r = static_cast<size_t>(blockIdx.x) * kRowWarps + warp;
  if (r >= static_cast<size_t>(rows)) return;  // whole warps leave
  const float* src = scores + r * n;
  uint64_t* cand = cand_all[warp];
  const int keff = k < n ? k : n;

  // element lane + 32 j lives in key[j]: coalesced loads, index order
  // j-major then lane
  uint32_t key[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = j * 32 + lane;
    key[j] = i < n ? to_key(src[i]) : kPadKey;
  }

  // 1. T = the keff-th smallest key, bit by bit from the top: T is the
  // largest t with fewer than keff keys below it
  uint32_t t_key = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t test = t_key | (1u << bit);
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) c += key[j] < test;
    if (__reduce_add_sync(kFull, c) < static_cast<unsigned>(keff)) {
      t_key = test;
    }
  }
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) c += key[j] < t_key;
  const int c_less = static_cast<int>(__reduce_add_sync(kFull, c));
  const int need_eq = keff - c_less;

  // 2. compaction in index order
  const unsigned below_me = lanemask_lt();
  int run_lt = 0, run_eq = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const unsigned lt = __ballot_sync(kFull, key[j] < t_key);
    const unsigned eq = __ballot_sync(kFull, key[j] == t_key);
    const uint64_t packed = (static_cast<uint64_t>(key[j]) << 32) |
                            static_cast<uint32_t>(j * 32 + lane);
    if (key[j] < t_key) cand[run_lt + __popc(lt & below_me)] = packed;
    if (key[j] == t_key) {
      const int rank = run_eq + __popc(eq & below_me);
      if (rank < need_eq) cand[c_less + rank] = packed;
    }
    run_lt += __popc(lt);
    run_eq += __popc(eq);
  }
  __syncwarp();

  // 3. bitonic sort of 32 in registers, one candidate a lane
  uint64_t x = lane < keff ? cand[lane] : ~0ull;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t y = __shfl_xor_sync(kFull, x, stride);
      const bool lower = (lane & stride) == 0;
      const bool up = (lane & size) == 0;
      // the lower lane of an ascending pair keeps the smaller
      x = (lower == up) ? (x < y ? x : y) : (x < y ? y : x);
    }
  }
  if (lane < k) {
    float* out_v = vals + r * k;
    int* out_i = idx + r * k;
    if (lane < keff) {
      const int i = static_cast<int>(x & 0xffffffffu);
      out_i[lane] = i;
      out_v[lane] = out_value(src, i);
    } else {
      out_i[lane] = n - 1;
      out_v[lane] = INFINITY;
    }
  }
}

template <int E>
int launch_warp(const float* s, float* v, int* i, int rows, int n, int k,
                cudaStream_t stream) {
  const int grid = (rows + kRowWarps - 1) / kRowWarps;
  smallest_k_warp<E><<<grid, kRowWarps * 32, 0, stream>>>(s, v, i, rows, n,
                                                          k);
  return static_cast<int>(cudaGetLastError());
}

// shared memory the block form takes for rows of n, k picks and a key
// list of list_cap (kernels.smallest_k_smem, which the wrapper checks,
// computes it without a list, the least the kernel runs with)
size_t block_smem(int n, int k, int list_cap) {
  int sort_len = 1;
  while (sort_len < (k < n ? k : n)) sort_len <<= 1;
  size_t aux = static_cast<size_t>(sort_len) * 8;
  const size_t sel = kBins * 2 + static_cast<size_t>(list_cap) * 4;
  if (aux < sel) aux = sel;
  return static_cast<size_t>((n + 3) & ~3) * 4 + aux;
}

}  // namespace

extern "C" int usip_smallest_k(const void* scores, void* vals, void* idx,
                               int rows, int n, int k, void* stream) {
  const auto s = static_cast<const float*>(scores);
  const auto v = static_cast<float*>(vals);
  const auto i = static_cast<int*>(idx);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= 32 && n <= 1024) {
    if (n <= 64) return launch_warp<2>(s, v, i, rows, n, k, st);
    if (n <= 128) return launch_warp<4>(s, v, i, rows, n, k, st);
    if (n <= 256) return launch_warp<8>(s, v, i, rows, n, k, st);
    if (n <= 512) return launch_warp<16>(s, v, i, rows, n, k, st);
    return launch_warp<32>(s, v, i, rows, n, k, st);
  }
  int sort_len = 1;
  while (sort_len < (k < n ? k : n)) sort_len <<= 1;
  // about 32 keys a thread, whole warps, 32 to 512 threads
  int threads = ((n + 32 * 32 - 1) / (32 * 32)) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  // the first pass's bin as a list for the later passes, where it fits
  int list_cap = kListCap;
  if (block_smem(n, k, list_cap) + kStaticSmem > kMaxSmem) list_cap = 0;
  const size_t smem = block_smem(n, k, list_cap);
  cudaError_t err = cudaFuncSetAttribute(
      smallest_k_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec4 = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(scores) % 16 == 0);
  smallest_k_block<<<rows, threads, smem, st>>>(s, v, i, n, k, sort_len,
                                                list_cap, vec4);
  return static_cast<int>(cudaGetLastError());
}
