// Masked scatter-max of point features onto nodes, forward only.
//
// Replaces scripts/bench_scatter_pallas.py scatter_max_pallas / make_kernel
// (node accumulators kept in VMEM, points streamed through): for features
// f (B, N, C) and node ids (B, N) in [0, M), out[b, m, c] is the max of
// f[b, n, c] over the points n with ids[b, n] == m, and 0 for a node that no
// point maps to.
//
// What bounds it on the H100: the read-modify-write of the accumulators. Each
// point updates C cells of its node's row, in an order that depends on the
// data, so on device memory every update would be an atomic in L2. The bytes
// are only f and ids read once.
//
// What the design does about it: one block per (cloud, tile of 8 channels)
// keeps the whole (M, 8) accumulator of its tile in shared memory, where the
// update is a native 32-bit atomic max. Floats are mapped onto ints whose
// signed order is the float order (the ordered-int encoding), and the
// accumulator starts at INT_MIN, below every encoded float, which marks a
// node that no point reached. Eight neighbouring threads read one point's 8
// channels (one 32-byte sector); each thread keeps 4 loads in flight before
// its atomics. The block writes its tile of the output once, at the end.
//
// NaN features are outside the contract. An id outside [0, M) fails a device
// assertion.

#include <cuda_runtime.h>
#include <cassert>
#include <climits>

namespace {

constexpr int kTile = 8;
constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kEmpty = INT_MIN;

__device__ __forceinline__ int encode(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float decode(int e) {
  return __int_as_float(e >= 0 ? e : e ^ 0x7fffffff);
}

__global__ void scatter_max_kernel(const float* __restrict__ f,
                                   const long long* __restrict__ ids,
                                   float* __restrict__ out, int n, int m,
                                   int c) {
  extern __shared__ int acc[];  // (m, kTile)
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kTile;
  const int ct = min(kTile, c - c0);
  for (int i = threadIdx.x; i < m * kTile; i += blockDim.x) acc[i] = kEmpty;
  __syncthreads();

  const int ch = threadIdx.x % kTile;
  const int per_pass = blockDim.x / kTile;
  const float* fb = f + static_cast<size_t>(b) * n * c + c0 + ch;
  const long long* ib = ids + static_cast<size_t>(b) * n;
  if (ch < ct) {
    for (int p0 = threadIdx.x / kTile; p0 < n; p0 += per_pass * kUnroll) {
      float v[kUnroll];
      long long id[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * per_pass;
        if (p < n) {
          v[u] = fb[static_cast<size_t>(p) * c];
          id[u] = ib[p];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p0 + u * per_pass < n) {
          assert(id[u] >= 0 && id[u] < m);
          atomicMax(&acc[static_cast<int>(id[u]) * kTile + ch], encode(v[u]));
        }
      }
    }
  }
  __syncthreads();

  float* ob = out + static_cast<size_t>(b) * m * c + c0;
  for (int i = threadIdx.x; i < m * kTile; i += blockDim.x) {
    const int node = i / kTile;
    const int cc = i % kTile;
    if (cc < ct) {
      const int e = acc[i];
      ob[static_cast<size_t>(node) * c + cc] = e == kEmpty ? 0.0f : decode(e);
    }
  }
}

}  // namespace

extern "C" int usip_scatter_max(const void* f, const void* ids, void* out,
                                int b, int n, int m, int c, void* stream) {
  const size_t smem = static_cast<size_t>(m) * kTile * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c + kTile - 1) / kTile, b);
  scatter_max_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const long long*>(ids),
      static_cast<float*>(out), n, m, c);
  return static_cast<int>(cudaGetLastError());
}
