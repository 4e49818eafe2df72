// Query -> nearest candidate: min squared distance and first argmin.
//
// Replaces usip_tpu/ops/pallas_kernels.py min_argmin_pallas /
// _min_argmin_kernel, and with it the (B, N, M) distance matrix that
// usip_tpu builds with XLA for the point->node assignment
// (assign_points_to_nodes, bf16) and for the losses' nearest neighbour
// (ops/geometry.py nearest_neighbor, fp32): 268 MB in fp32 at B=8,
// N=16384, M=512, and as much at the keypoint->cloud shape (8, 512) x 16384.
//
// What bounds it on the H100: issue slots on the CUDA cores. The result must
// be bit-identical to the plain version, so each distance is
// p_sq - 2 (p . n) + n_sq with round-to-nearest multiplies and adds and no
// FMA: 8 instructions a (query, candidate) pair (three products, two sums,
// the doubling, the difference and the sum), no tensor cores. The bytes
// (the points in, two words out a query) are far below the memory rate.
//
// What the design does about it:
// * Register blocking. Each thread keeps P queries (1 to 8) in registers, so
//   one shared-memory load of a candidate serves P pairs, and the loop over
//   candidates is unrolled (4 pairs in bf16, 8 candidates in fp32) for
//   independent work between the dependent steps of a distance.
// * One 16-byte load a candidate. A tile of candidates is staged in shared
//   memory as float4 (x, y, z, n_sq): one LDS.128, the same address for the
//   whole warp (a broadcast).
// * A packed key in the bf16 mode. After the rounding to bf16 and the clamp
//   a distance is a non-negative bf16, so (bf16 bits << 16) | j orders as an
//   unsigned int exactly as (distance, first index) does. One
//   cvt.rn.relu.bf16x2.f32 rounds and clamps two distances, an AND turns a
//   -0 into +0 (whose key would otherwise sort after every positive
//   distance), one prmt builds each key, and one unsigned min a pair
//   replaces the compare and two selects. j counts inside the tile; after a
//   tile each thread folds its best into a 64-bit key (value bits << 32 |
//   global index), so any M works. The fp32 mode keeps a float compare.
// * Tiles of candidates, streamed through shared memory, so M is unbounded.
// * A split of the candidates when queries are few: a cluster of S blocks (at
//   most 16) shares one tile of queries, each block taking 1/S of the
//   candidates; the blocks merge their 64-bit keys through distributed shared
//   memory, each writing 1/S of the outputs. The first minimum survives the
//   merge because the key orders by (value, index).
// The form (threads, P, S, tile) is chosen on the host
// (usip_tpu_torch/ops/kernels.py min_argmin_form).
//
// Numerics: d = p_sq - 2 (px nx + py ny + pz nz) + n_sq, left to right, the
// order of pallas_kernels.py _min_argmin_kernel and of the plain version.
// With round_bf16 each distance is rounded to bf16 (nearest even), usip_tpu's
// compute_dtype=bfloat16 assignment. Distances are clamped at 0 before the
// compare (as assign_points_to_nodes clamps its matrix), and the argmin keeps
// the first of equal values. Inputs are finite.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long Key;

constexpr int kMaxThreads = 256;
// clusters of more than 8 blocks (the portable size) need the non-portable
// attribute; Hopper takes up to 16
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// p_sq - 2 (p . n) + n_sq, rounded at every step; c holds (x, y, z, n_sq).
// Staging (2x, 2y, 2z) to skip the doubling would be exact except where a
// product is subnormal, so the doubling stays.
__device__ __forceinline__ float dist(float px, float py, float pz, float psq,
                                      float4 c) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(px, c.x),
                                          __fmul_rn(py, c.y)),
                                __fmul_rn(pz, c.z));
  return __fadd_rn(__fsub_rn(psq, __fmul_rn(2.0f, cross)), c.w);
}

// a and b rounded to bf16 (nearest even) and clamped at +0, packed with a in
// the upper half
__device__ __forceinline__ unsigned bf16x2_relu(float a, float b) {
  unsigned r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(a), "f"(b));
  return r & 0x7fff7fffu;
}

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned sel) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

__device__ __forceinline__ Key make_key(float v, int j) {
  return (static_cast<Key>(__float_as_uint(v)) << 32) |
         static_cast<unsigned>(j);
}

// one block: P queries a thread, blockDim.x threads, over its cluster rank's
// range of candidates, tile by tile
template <int P, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
min_argmin_kernel(const float* __restrict__ points,
                  const float* __restrict__ nodes, float* __restrict__ mins,
                  int* __restrict__ idx, int n, int m, int chunk, int tile) {
  extern __shared__ float4 stage[];  // the tile; the merge keys after it
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ns = static_cast<int>(cluster.num_blocks());
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int q0 = blockIdx.y * threads * P;

  float px[P], py[P], pz[P], psq[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int q = q0 + tid + k * threads;
    px[k] = py[k] = pz[k] = 0.0f;
    if (q < n) {
      const float* p = points + (static_cast<size_t>(b) * n + q) * 3;
      px[k] = p[0];
      py[k] = p[1];
      pz[k] = p[2];
    }
    psq[k] = sq3(px[k], py[k], pz[k]);
  }

  const int c_begin = rank * chunk;
  const int c_end = min(m, c_begin + chunk);
  const float* nb = nodes + static_cast<size_t>(b) * m * 3;
  Key best[P];
  float bv[P];
  int bj[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    best[k] = ~0ull;
    bv[k] = INFINITY;
    bj[k] = c_begin;
  }

  for (int t0 = c_begin; t0 < c_end; t0 += tile) {
    const int len = min(tile, c_end - t0);
    // an odd tile ends with a pad at +inf, which loses every tie: it comes
    // last
    const int len2 = (len + 1) & ~1;
    __syncthreads();
    for (int j = tid; j < len2; j += threads) {
      float4 c = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
      if (j < len) {
        const float* nd = nb + static_cast<size_t>(t0 + j) * 3;
        const float x = nd[0], y = nd[1], z = nd[2];
        c = make_float4(x, y, z, sq3(x, y, z));
      }
      stage[j] = c;
    }
    __syncthreads();
    if constexpr (BF16) {
      unsigned kb[P];
#pragma unroll
      for (int k = 0; k < P; ++k) kb[k] = ~0u;
      // (j + 1) << 16 | j: the two candidates' indices in the tile
      unsigned jj = 0x00010000u;
#pragma unroll 4
      for (int j = 0; j < len2; j += 2) {
        const float4 c0 = stage[j], c1 = stage[j + 1];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const unsigned v = bf16x2_relu(dist(px[k], py[k], pz[k], psq[k], c0),
                                         dist(px[k], py[k], pz[k], psq[k], c1));
          // (v.hi << 16 | j), (v.lo << 16 | j + 1)
          const unsigned k0 = prmt(v, jj, 0x3254u);
          const unsigned k1 = prmt(v, jj, 0x1076u);
          kb[k] = min(kb[k], min(k0, k1));
        }
        jj += 0x00020002u;
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const Key key = (static_cast<Key>(kb[k] & 0xffff0000u) << 32) |
                        static_cast<unsigned>(t0 + (kb[k] & 0xffffu));
        best[k] = min(best[k], key);
      }
    } else {
#pragma unroll 8
      for (int j = 0; j < len; ++j) {
        const float4 c = stage[j];
        const int jg = t0 + j;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float d = fmaxf(dist(px[k], py[k], pz[k], psq[k], c), 0.0f);
          if (d < bv[k]) {
            bv[k] = d;
            bj[k] = jg;
          }
        }
      }
    }
  }
  if constexpr (!BF16) {
    if (c_begin < c_end) {
#pragma unroll
      for (int k = 0; k < P; ++k) best[k] = make_key(bv[k], bj[k]);
    }
  }

  float* mb = mins + static_cast<size_t>(b) * n;
  int* ib = idx + static_cast<size_t>(b) * n;
  if (ns == 1) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = q0 + tid + k * threads;
      if (q < n) {
        mb[q] = __uint_as_float(static_cast<unsigned>(best[k] >> 32));
        ib[q] = static_cast<int>(static_cast<unsigned>(best[k]));
      }
    }
    return;
  }

  // cluster merge: every block's keys in its shared memory, after the tile
  Key* keys = reinterpret_cast<Key*>(stage + tile);
#pragma unroll
  for (int k = 0; k < P; ++k) keys[tid + k * threads] = best[k];
  cluster.sync();
  const int nq = threads * P;
  const int share = (nq + ns - 1) / ns;
  const int i_end = min(nq, (rank + 1) * share);
  for (int i = rank * share + tid; i < i_end; i += threads) {
    Key part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      part[r] = cluster.map_shared_rank(keys, r < ns ? r : rank)[i];
    Key key = part[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) key = min(key, part[r]);
    const int q = q0 + i;
    if (q < n) {
      mb[q] = __uint_as_float(static_cast<unsigned>(key >> 32));
      ib[q] = static_cast<int>(static_cast<unsigned>(key));
    }
  }
  // keep every block resident until its peers have read its keys
  cluster.sync();
}

template <int P, bool BF16>
int launch(const void* points, const void* nodes, void* mins, void* idx,
           int b, int n, int m, int threads, int split, int tile,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile) * sizeof(float4) +
                      (split > 1 ? static_cast<size_t>(threads) * P *
                                       sizeof(Key)
                                 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      min_argmin_kernel<P, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split > 8) {
    err = cudaFuncSetAttribute(min_argmin_kernel<P, BF16>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (n + threads * P - 1) / (threads * P), b);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int chunk = (m + split - 1) / split;
  err = cudaLaunchKernelEx(&cfg, min_argmin_kernel<P, BF16>,
                           static_cast<const float*>(points),
                           static_cast<const float*>(nodes),
                           static_cast<float*>(mins), static_cast<int*>(idx),
                           n, m, chunk, tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dispatch(const void* points, const void* nodes, void* mins, void* idx,
             int b, int n, int m, int threads, int ppt, int split, int tile,
             cudaStream_t st) {
  switch (ppt) {
    case 1: return launch<1, BF16>(points, nodes, mins, idx, b, n, m,
                                   threads, split, tile, st);
    case 2: return launch<2, BF16>(points, nodes, mins, idx, b, n, m,
                                   threads, split, tile, st);
    case 4: return launch<4, BF16>(points, nodes, mins, idx, b, n, m,
                                   threads, split, tile, st);
    case 8: return launch<8, BF16>(points, nodes, mins, idx, b, n, m,
                                   threads, split, tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// threads: a multiple of 32, at most 256; ppt: queries a thread, 1, 2, 4 or
// 8; split: blocks of a cluster that share a tile of queries, 1 to 16; tile:
// candidates staged at a time, even
extern "C" int usip_min_argmin(const void* points, const void* nodes,
                               void* mins, void* idx, int b, int n, int m,
                               int round_bf16, int threads, int ppt,
                               int split, int tile, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      split < 1 || split > kMaxCluster || tile < 2 || tile % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return round_bf16 ? dispatch<true>(points, nodes, mins, idx, b, n, m,
                                     threads, ppt, split, tile, st)
                    : dispatch<false>(points, nodes, mins, idx, b, n, m,
                                      threads, ppt, split, tile, st);
}
