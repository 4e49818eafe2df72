// Farthest point sampling, one thread block per cloud.
//
// Replaces usip_tpu/ops/pallas_kernels.py fps_pallas / _fps_kernel.
//
// What bounds it on the H100: latency. Each of the k-1 steps depends on the
// previous pick, and a step is a few microseconds of work (S distance updates
// and one argmax over S values), so the time is k times the latency of one
// step: the block-wide reduction and its barriers, not bytes or FLOPs.
//
// What the design does about it: the whole sequential loop runs inside one
// launch, with the cloud (three coordinate planes) and the running
// min-distance row in shared memory; a step touches no device memory. The
// argmax is a warp shuffle reduction followed by one across the warps, with
// two barriers a step. Each thread keeps its own points' distances, so the
// update and the local argmax are one pass.
//
// Numerics: each squared distance is dx*dx + dy*dy + dz*dz with
// round-to-nearest intrinsics, so nvcc cannot contract it into FMAs; the plain
// version computes the same three products and two sums as separate ops, so
// the picks are bit-identical. Ties of the argmax go to the smaller index,
// like jnp.argmax and torch.argmax.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        float qx, float qy, float qz) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (value, index) pair order of the argmax: larger value, then smaller index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void fps_kernel(const float* __restrict__ points,
                           const int* __restrict__ first,
                           int* __restrict__ out, int s, int k) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + s;
  float* zs = ys + s;
  float* mind = zs + s;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int pick;

  const int b = blockIdx.x;
  const float* p = points + static_cast<size_t>(b) * s * 3;
  int* o = out + static_cast<size_t>(b) * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < s; i += kThreads) {
    xs[i] = p[3 * i];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
  }
  if (tid == 0) {
    pick = first[b];
    o[0] = first[b];
  }
  __syncthreads();

  int cur = pick;
  for (int step = 1; step < k; ++step) {
    const float qx = xs[cur], qy = ys[cur], qz = zs[cur];
    float bv = -FLT_MAX;
    int bi = INT32_MAX;
    for (int i = tid; i < s; i += kThreads) {
      const float d = sqdist(xs[i], ys[i], zs[i], qx, qy, qz);
      const float m = step == 1 ? d : fminf(mind[i], d);
      mind[i] = m;
      if (better(m, i, bv, bi)) {
        bv = m;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -FLT_MAX;
      bi = lane < kWarps ? red_i[lane] : INT32_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        pick = bi;
        o[step] = bi;
      }
    }
    __syncthreads();
    cur = pick;
  }
}

}  // namespace

extern "C" int usip_fps(const void* points, const void* first, void* out,
                        int b, int s, int k, void* stream) {
  const size_t smem = static_cast<size_t>(s) * 4 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const int*>(first),
      static_cast<int*>(out), s, k);
  return static_cast<int>(cudaGetLastError());
}
