// Point -> nearest node: min squared distance and first argmin.
//
// Replaces usip_tpu/ops/pallas_kernels.py min_argmin_pallas /
// _min_argmin_kernel, and with it the (B, N, M) distance matrix that
// usip_tpu's assign_points_to_nodes builds with XLA (268 MB in fp32 at
// B=8, N=16384, M=512).
//
// What bounds it on the H100: arithmetic on the CUDA cores. Per (point, node)
// pair it does about ten fp32 operations and a compare; the bytes are only
// the points in and two words out per point, so device memory is far below
// its limit. The matrix never exists.
//
// What the design does about it: one thread per point, all M nodes and their
// squared norms staged once per block in shared memory, where every thread of
// a warp reads the same node (a broadcast, no bank conflicts). The point's
// coordinates and norm stay in registers.
//
// Numerics: d = p_sq - 2 (px nx + py ny + pz nz) + n_sq, evaluated left to
// right with round-to-nearest intrinsics (no FMA contraction), the order of
// pallas_kernels.py _min_argmin_kernel and of the plain version. With
// round_bf16 each distance is rounded to bf16 (nearest even) first, which is
// usip_tpu's compute_dtype=bfloat16 assignment. Distances are clamped at 0
// before the compare (as assign_points_to_nodes clamps its matrix), and the
// argmin keeps the first of equal values. No M % 128 or N % tile rule: a
// ragged tail of points is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void min_argmin_kernel(const float* __restrict__ points,
                                  const float* __restrict__ nodes,
                                  float* __restrict__ mins,
                                  int* __restrict__ idx, int n, int m,
                                  int round_bf16) {
  extern __shared__ float smem[];
  float* nx = smem;
  float* ny = nx + m;
  float* nz = ny + m;
  float* nsq = nz + m;

  const int b = blockIdx.y;
  const float* nd = nodes + static_cast<size_t>(b) * m * 3;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float x = nd[3 * j], y = nd[3 * j + 1], z = nd[3 * j + 2];
    nx[j] = x;
    ny[j] = y;
    nz[j] = z;
    nsq[j] = sq3(x, y, z);
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = points + (static_cast<size_t>(b) * n + i) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float psq = sq3(px, py, pz);
  float best = INFINITY;
  int best_j = 0;
  for (int j = 0; j < m; ++j) {
    const float cross = __fadd_rn(
        __fadd_rn(__fmul_rn(px, nx[j]), __fmul_rn(py, ny[j])),
        __fmul_rn(pz, nz[j]));
    float d = __fadd_rn(__fsub_rn(psq, __fmul_rn(2.0f, cross)), nsq[j]);
    if (round_bf16) d = __bfloat162float(__float2bfloat16_rn(d));
    d = fmaxf(d, 0.0f);
    if (d < best) {
      best = d;
      best_j = j;
    }
  }
  mins[static_cast<size_t>(b) * n + i] = best;
  idx[static_cast<size_t>(b) * n + i] = best_j;
}

}  // namespace

extern "C" int usip_min_argmin(const void* points, const void* nodes,
                               void* mins, void* idx, int b, int n, int m,
                               int round_bf16, void* stream) {
  const size_t smem = static_cast<size_t>(m) * 4 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      min_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  min_argmin_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(nodes),
      static_cast<float*>(mins), static_cast<int*>(idx), n, m, round_bf16);
  return static_cast<int>(cudaGetLastError());
}
