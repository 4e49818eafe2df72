// Exact k smallest entries of each row: values ascending and their indices.
//
// Replaces usip_tpu/ops/pallas_kernels.py smallest_k_pallas /
// _smallest_k_kernel (iterative min-extraction on a VMEM-resident row tile).
//
// Order: ascending value, ties to the lowest index. Non-finite entries (+inf,
// -inf, NaN) are "absent": they come after every finite entry, in ascending
// index order, with value +inf (the Pallas kernel's sentinel encoding; it
// diverges from lax.top_k for -inf and NaN, and this kernel keeps that).
// Picks past the row's end (k > N) get index N-1 and value +inf, the Pallas
// kernel's clamp of its lane padding.
//
// What bounds it on the H100: the k dependent rounds, each a block-wide
// argmin with two barriers. The row is read from device memory once (64 KiB
// at N=16384), so bytes are far below the card's limit.
//
// What the design does about it: one block per row, of about one thread for
// 16 elements (32 to 512 threads); the row lives in shared memory, but each
// element is touched only by the thread that owns it (index i belongs to
// thread i % blockDim), so a round costs no pass over the row.
// Every thread keeps the (value, index) minimum of its own live elements in
// registers; a round reduces those minima across the block (warp shuffles,
// then across the warps), and only the thread whose element was picked
// retires it (stores NaN, which compares false with everything) and rescans
// its N / blockDim elements.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// strict (value, index) order of the selection: smaller value, then smaller
// index; a NaN value (a retired element) is never better than anything
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmin(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// the minimum of this thread's live elements; (+inf, INT_MAX) when none is
// left, which every live element (index < INT_MAX) beats
__device__ __forceinline__ void local_min(const float* row, int n, int tid,
                                          int nthreads, float& bv, int& bi) {
  bv = INFINITY;
  bi = INT_MAX;
#pragma unroll 4
  for (int i = tid; i < n; i += nthreads) {
    const float v = row[i];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
}

__global__ void smallest_k_kernel(const float* __restrict__ scores,
                                  float* __restrict__ vals,
                                  int* __restrict__ idx, int n, int k) {
  extern __shared__ float row[];
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_i[kMaxWarps];
  __shared__ int pick_i;

  const size_t r = blockIdx.x;
  const float* src = scores + r * n;
  float* out_v = vals + r * k;
  int* out_i = idx + r * k;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // absent entries (non-finite) become +inf: they then sort after every
  // finite entry and, tied with each other, in ascending index order
  for (int i = tid; i < n; i += nthreads) {
    const float v = src[i];
    row[i] = isfinite(v) ? v : INFINITY;
  }
  float lv;
  int li;
  local_min(row, n, tid, nthreads, lv, li);

  for (int j = 0; j < k; ++j) {
    float bv = lv;
    int bi = li;
    warp_argmin(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_argmin(bv, bi);
      if (lane == 0) {
        pick_i = bi;
        // nothing live is left only when k > n: the lane-padding clamp
        out_v[j] = bi == INT_MAX ? INFINITY : bv;
        out_i[j] = bi == INT_MAX ? n - 1 : bi;
      }
    }
    __syncthreads();
    const int p = pick_i;
    if (p != INT_MAX && p % nthreads == tid) {
      row[p] = NAN;
      local_min(row, n, tid, nthreads, lv, li);
    }
  }
}

}  // namespace

extern "C" int usip_smallest_k(const void* scores, void* vals, void* idx,
                               int rows, int n, int k, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      smallest_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // about 16 elements a thread, whole warps, 32 to 512 threads: a round's
  // block-wide argmin costs more with every warp, a rescan with every
  // element a thread owns (measured on the H100: at N=512 one warp is 4x
  // faster than 512 threads, at N=16384 512 threads are the fastest)
  int threads = ((n + 16 * 32 - 1) / (16 * 32)) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  smallest_k_kernel<<<rows, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(vals),
      static_cast<int*>(idx), n, k);
  return static_cast<int>(cudaGetLastError());
}
