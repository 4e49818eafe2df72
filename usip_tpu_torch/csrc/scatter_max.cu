// Masked scatter-max of point features onto nodes, forward only.
//
// Replaces scripts/bench_scatter_pallas.py scatter_max_pallas / make_kernel
// (node accumulators kept in VMEM, points streamed through): for features
// f (B, N, C) and node ids (B, N) in [0, M), out[b, m, c] is the max of
// f[b, n, c] over the points n with ids[b, n] == m, and 0 for a node that no
// point maps to.
//
// What bounds it on the H100: the bytes of f, read once (the ids and the
// output are small beside them), and, in their way, the read-modify-write of
// the accumulators: each point updates C cells of its node's row in an order
// that depends on the data, so on device memory every update would be an
// atomic in L2; and the fixed cost of a launch whose blocks set up and merge
// accumulators.
//
// What the design does about it:
// * Shared accumulators. A block keeps the (M, T) accumulator of its tile of
//   T channels (T = 32 for M <= 1816, 64 KB at M = 512) in shared memory,
//   where the update is a native 32-bit atomic max. Floats are mapped onto
//   ints whose signed order is the float order (the ordered-int encoding);
//   the accumulator starts at INT_MIN, below every encoded float, which marks
//   a node that no point reached.
// * Enough blocks, each byte read once. A cluster of `ns` blocks (at most 8,
//   the portable size) splits the N points of one (cloud, tile): the grid is
//   (ns, C / T, B); at N = 16384, ns = 4 gives 64 blocks for C = 64 and 128
//   for C = 128 (ns = 8 doubles them, but its merge costs more than they
//   gain). T / 4 threads read a point's T-channel row segment (128 bytes at
//   T = 32) as one float4 each.
// * Loads ahead of the atomics. Each thread keeps 8 points' loads in flight,
//   and issues the next 8 before the atomics of these.
// * Bank conflicts are left alone. With one channel order the 4 points of a
//   warp collide 4 ways in the banks (the row stride is 32 words); rotating
//   each lane group's channel order by its slot in the warp removes that,
//   but its selects cost more than the conflicts (kRotate, the ablation).
// * Cluster merge. After cluster.sync() each block max-reduces its 1/ns of
//   the nodes over the ns accumulators through distributed shared memory,
//   decodes them and writes that part of the output once: one launch, no
//   global atomics, no scratch tensor, and the result exact in any order,
//   because max is. A second cluster.sync() keeps every block resident until
//   its peers have read its accumulator.
// The form (ns and T) is chosen by the caller
// (usip_tpu_torch/ops/kernels.py scatter_max_form).
//
// NaN features are outside the contract. An id outside [0, M) fails a device
// assertion.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cassert>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 8;
constexpr int kEmpty = INT_MIN;
constexpr int kMaxCluster = 8;
// the lane group of point slot g updates its channels in the order rotated by
// g, 32 distinct banks a warp's atomic (true), or all in the same order
// (false)
constexpr bool kRotate = false;
// the next batch's loads are issued before this batch's atomics (true), or
// after them (false)
constexpr bool kPrefetch = true;

__device__ __forceinline__ int encode(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float decode(int e) {
  return e == kEmpty ? 0.0f : __int_as_float(e >= 0 ? e : e ^ 0x7fffffff);
}

__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                   max(a.w, b.w));
}

// T channels a block, T / 4 threads a point, 4 channels a thread
template <int T>
__global__ void __launch_bounds__(kThreads)
scatter_max_kernel(const float* __restrict__ f,
                   const long long* __restrict__ ids,
                   float* __restrict__ out, int n, int m, int c, int chunk,
                   int vec) {
  constexpr int kLanes = T / 4;  // threads of one point
  constexpr int kPerPass = kThreads / kLanes;
  extern __shared__ int4 acc4[];  // (m, T) ordered ints, 4 to an int4
  int* acc = reinterpret_cast<int*>(acc4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ns = static_cast<int>(cluster.num_blocks());
  const int c0 = blockIdx.y * T;
  const int ct = min(T, c - c0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  for (int i = tid; i < m * kLanes; i += kThreads)
    acc4[i] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  __syncthreads();

  const int cb = 4 * (tid % kLanes);  // this thread's first channel
  const int g = kRotate ? (tid / kLanes) & 3 : 0;
  const int p_begin = rank * chunk;
  const int p_end = min(n, p_begin + chunk);
  const float* fb = f + static_cast<size_t>(b) * n * c + c0 + cb;
  const long long* ib = ids + static_cast<size_t>(b) * n;
  if (cb < ct) {
    struct Batch {
      float4 v[kUnroll];
      long long id[kUnroll];
    };
    // the loads of kUnroll points, kPerPass apart, from p0 on
    auto load = [&](int p0, Batch& bt) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kPerPass;
        if (p < p_end) {
          bt.id[u] = ib[p];
          const float* row = fb + static_cast<size_t>(p) * c;
          if (vec) {
            bt.v[u] = *reinterpret_cast<const float4*>(row);
          } else {
            bt.v[u].x = row[0];
            bt.v[u].y = cb + 1 < ct ? row[1] : 0.0f;
            bt.v[u].z = cb + 2 < ct ? row[2] : 0.0f;
            bt.v[u].w = cb + 3 < ct ? row[3] : 0.0f;
          }
        }
      }
    };
    auto update = [&](int p0, const Batch& bt) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p0 + u * kPerPass < p_end) {
          assert(bt.id[u] >= 0 && bt.id[u] < m);
          int* cell = acc + static_cast<int>(bt.id[u]) * T + cb;
          // e_q = the encoded channel (q + g) & 3, by two conditional
          // rotations
          const int e0 = encode(bt.v[u].x), e1 = encode(bt.v[u].y);
          const int e2 = encode(bt.v[u].z), e3 = encode(bt.v[u].w);
          const bool r1 = g & 1, r2 = g & 2;
          const int a0 = r1 ? e1 : e0, a1 = r1 ? e2 : e1;
          const int a2 = r1 ? e3 : e2, a3 = r1 ? e0 : e3;
          const int e[4] = {r2 ? a2 : a0, r2 ? a3 : a1, r2 ? a0 : a2,
                            r2 ? a1 : a3};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ch = (q + g) & 3;
            if (cb + ch < ct) atomicMax(cell + ch, e[q]);
          }
        }
      }
    };
    constexpr int kStep = kPerPass * kUnroll;
    int p0 = p_begin + tid / kLanes;
    Batch cur;
    load(p0, cur);
    for (; p0 < p_end; p0 += kStep) {
      Batch next;
      if constexpr (kPrefetch) load(p0 + kStep, next);
      update(p0, cur);
      if constexpr (!kPrefetch) load(p0 + kStep, next);
      cur = next;
    }
  }
  cluster.sync();

  // this block's share of the nodes, max-reduced over the cluster
  const int mb = (m + ns - 1) / ns;
  const int m0 = rank * mb;
  const int m1 = min(m, m0 + mb);
  float* ob = out + static_cast<size_t>(b) * m * c + c0;
  for (int i = tid; i < (m1 - m0) * kLanes; i += kThreads) {
    const int node = m0 + i / kLanes;
    const int q4 = i % kLanes;
    const int cc = 4 * q4;
    if (cc >= ct) continue;
    const int at = node * kLanes + q4;
    // all ns loads in flight at once (ranks past ns read this block's own)
    int4 part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      part[r] = cluster.map_shared_rank(acc4, r < ns ? r : rank)[at];
    int4 e = part[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) e = max4(e, part[r]);
    float* dst = ob + static_cast<size_t>(node) * c + cc;
    if (vec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(decode(e.x), decode(e.y), decode(e.z), decode(e.w));
    } else {
      dst[0] = decode(e.x);
      if (cc + 1 < ct) dst[1] = decode(e.y);
      if (cc + 2 < ct) dst[2] = decode(e.z);
      if (cc + 3 < ct) dst[3] = decode(e.w);
    }
  }
  cluster.sync();
}

template <int T>
int launch(const void* f, const void* ids, void* out, int b, int n, int m,
           int c, int ns, int vec, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * T * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, (c + T - 1) / T, b);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int chunk = (n + ns - 1) / ns;
  err = cudaLaunchKernelEx(&cfg, scatter_max_kernel<T>,
                           static_cast<const float*>(f),
                           static_cast<const long long*>(ids),
                           static_cast<float*>(out), n, m, c, chunk, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cluster: blocks splitting one (cloud, tile)'s points, 1 to 8; tile: 8, 16
// or 32 channels a block; vec: C % 4 == 0 and f 16-byte aligned (float4
// loads and stores)
extern "C" int usip_scatter_max(const void* f, const void* ids, void* out,
                                int b, int n, int m, int c, int cluster,
                                int tile, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster < 1 || cluster > kMaxCluster || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile) {
    case 8: return launch<8>(f, ids, out, b, n, m, c, cluster, vec, st);
    case 16: return launch<16>(f, ids, out, b, n, m, c, cluster, vec, st);
    case 32: return launch<32>(f, ids, out, b, n, m, c, cluster, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
