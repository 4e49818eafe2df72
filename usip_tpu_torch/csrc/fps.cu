// Farthest point sampling, one thread block per cloud.
//
// Replaces usip_tpu/ops/pallas_kernels.py fps_pallas / _fps_kernel.
//
// What bounds it on the H100: latency. Each of the k-1 steps depends on the
// previous pick, so the time is k times one step's critical path: the S
// distance updates and compares, spread over one SM's four schedulers, then a
// block-wide argmax (warp reductions, a barrier, shared-memory round trips)
// and the load of the pick's coordinates. Neither bytes nor FLOPs of the
// card come near it.
//
// What the design does about it:
// * Registers. Thread t keeps the points t + j T (j < P) in registers: their
//   coordinates and running minimum (S <= 8192), or only the minimum, the
//   coordinates read from shared memory each step (larger S). A thread visits
//   its points in index order, so its argmax is one strict compare a point.
//   A block of at most 256 threads is compiled for that size, so that the
//   compiler keeps every address in a register instead of recomputing it
//   from special registers on the step's critical path (the 64-register
//   budget of a 1024-thread block forces it to).
// * One 64-bit key for the argmax: (bits of the value << 32) | ~index. A
//   squared distance is >= +0, so its bits order like the float, and the
//   largest key is the larger value, then the smaller index. A warp reduces
//   it with two redux.sync: the max of the high words, then of the low words
//   among the lanes that hold that max.
// * One barrier a step. Each warp's leader writes its key to a slot of a
//   double-buffered array; after one __syncthreads every warp reduces all the
//   slots itself, so every thread knows the pick with no second barrier and
//   no broadcast. A warp can only overwrite a buffer two steps later, after
//   the next barrier, when every warp has read it.
// * The cloud stays in shared memory as three read-only coordinate planes,
//   from which each step loads the pick's coordinates.
// The kernel's form (T threads, P points a thread, coordinates in registers
// or not) is chosen by the caller (usip_tpu_torch/ops/kernels.py fps_form).
//
// Numerics: each squared distance is dx*dx + dy*dy + dz*dz with
// round-to-nearest intrinsics, so nvcc cannot contract it into FMAs; the plain
// version computes the same three products and two sums as separate ops, so
// the picks are bit-identical. Ties of the argmax go to the smaller index,
// like jnp.argmax and torch.argmax. NaN coordinates are outside the contract.

#include <cuda_runtime.h>
#include <cmath>

namespace {

using Key = unsigned long long;

constexpr int kMaxWarps = 32;
// the warp stage: two redux.sync on the key's halves (true), or five shuffle
// rounds on the whole key (false)
constexpr bool kRedux = true;
// one barrier a step, every warp reducing the slots (true); or warp 0 alone
// reduces them and hands the pick on through shared memory after a second
// barrier (false)
constexpr bool kOneBarrier = true;
// the most threads of a block compiled for fewer registers a thread
constexpr int kSmallBlock = 256;

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        float qx, float qy, float qz) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// the largest key of the warp, in every lane
__device__ __forceinline__ Key warp_max_key(Key key) {
  if constexpr (kRedux) {
    const unsigned hi = static_cast<unsigned>(key >> 32);
    const unsigned whi = __reduce_max_sync(0xffffffffu, hi);
    const unsigned wlo = __reduce_max_sync(
        0xffffffffu, hi == whi ? static_cast<unsigned>(key) : 0u);
    return (static_cast<Key>(whi) << 32) | wlo;
  } else {
    for (int off = 16; off > 0; off >>= 1) {
      const Key other = __shfl_xor_sync(0xffffffffu, key, off);
      key = other > key ? other : key;
    }
    return key;
  }
}

// P points a thread; kRegs: their coordinates in registers, else read from
// the shared planes each step; blocks of at most kMaxThreads threads
template <int P, bool kRegs, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ points, const int* __restrict__ first,
           int* __restrict__ out, int s, int k) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + s;
  float* zs = ys + s;
  __shared__ Key red[2][kMaxWarps];

  const int b = blockIdx.x;
  const float* p = points + static_cast<size_t>(b) * s * 3;
  int* o = out + static_cast<size_t>(b) * k;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  for (int i = tid; i < s; i += nthreads) {
    xs[i] = p[3 * i];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
  }
  __syncthreads();

  float px[kRegs ? P : 1], py[kRegs ? P : 1], pz[kRegs ? P : 1];
  float pm[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = tid + j * nthreads;
    // a point past the cloud's end never wins: its minimum stays -inf
    pm[j] = i < s ? INFINITY : -INFINITY;
    if constexpr (kRegs) {
      const int r = min(i, s - 1);
      px[j] = xs[r];
      py[j] = ys[r];
      pz[j] = zs[r];
    }
  }
  int cur = first[b];
  if (tid == 0) o[0] = cur;

  for (int step = 1; step < k; ++step) {
    const float qx = xs[cur], qy = ys[cur], qz = zs[cur];
    float bv = -1.0f;
    int bj = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float x, y, z;
      if constexpr (kRegs) {
        x = px[j];
        y = py[j];
        z = pz[j];
      } else {
        const int r = min(tid + j * nthreads, s - 1);
        x = xs[r];
        y = ys[r];
        z = zs[r];
      }
      const float m = fminf(pm[j], sqdist(x, y, z, qx, qy, qz));
      pm[j] = m;
      if (m > bv) {
        bv = m;
        bj = j;
      }
    }
    // a thread with no point of the cloud holds key 0, below every point's
    const Key key =
        bv >= 0.0f
            ? (static_cast<Key>(__float_as_uint(bv)) << 32) |
                  ~static_cast<unsigned>(tid + bj * nthreads)
            : 0ull;
    const Key wkey = warp_max_key(key);
    Key* slot = red[step & 1];
    if (lane == 0) slot[warp] = wkey;
    __syncthreads();
    if constexpr (kOneBarrier) {
      const Key all = warp_max_key(lane < nwarps ? slot[lane] : 0ull);
      cur = static_cast<int>(~static_cast<unsigned>(all));
    } else {
      __shared__ int pick;
      if (warp == 0) {
        const Key all = warp_max_key(lane < nwarps ? slot[lane] : 0ull);
        if (lane == 0) pick = static_cast<int>(~static_cast<unsigned>(all));
      }
      __syncthreads();
      cur = pick;
    }
    if (tid == 0) o[step] = cur;
  }
}

template <int P, bool kRegs, int kMaxThreads>
int launch(const void* points, const void* first, void* out, int b, int s,
           int k, int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(s) * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<P, kRegs, kMaxThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<P, kRegs, kMaxThreads><<<b, threads, smem, stream>>>(
      static_cast<const float*>(points), static_cast<const int*>(first),
      static_cast<int*>(out), s, k);
  return static_cast<int>(cudaGetLastError());
}

// coordinates in registers, P <= 8: the small-block build where it fits
template <int P>
int launch_regs(const void* points, const void* first, void* out, int b,
                int s, int k, int threads, cudaStream_t stream) {
  if (threads <= kSmallBlock)
    return launch<P, true, kSmallBlock>(points, first, out, b, s, k, threads,
                                        stream);
  return launch<P, true, 1024>(points, first, out, b, s, k, threads, stream);
}

}  // namespace

// threads (a multiple of 32, at most 1024) x points_per_thread must cover s;
// in_registers: coordinates in registers (1, 2, 4, 8 or 16 points a thread,
// 16 only up to 512 threads) or read from shared memory (16 points a thread)
extern "C" int usip_fps(const void* points, const void* first, void* out,
                        int b, int s, int k, int threads,
                        int points_per_thread, int in_registers,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > 1024 || threads % 32 != 0 ||
      static_cast<long long>(threads) * points_per_thread < s || k < 1 ||
      k > s)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!in_registers) {
    if (points_per_thread == 16)
      return launch<16, false, 1024>(points, first, out, b, s, k, threads,
                                     st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (points_per_thread) {
    case 1: return launch_regs<1>(points, first, out, b, s, k, threads, st);
    case 2: return launch_regs<2>(points, first, out, b, s, k, threads, st);
    case 4: return launch_regs<4>(points, first, out, b, s, k, threads, st);
    case 8: return launch_regs<8>(points, first, out, b, s, k, threads, st);
    case 16:
      if (threads > 512) return static_cast<int>(cudaErrorInvalidValue);
      return launch<16, true, 512>(points, first, out, b, s, k, threads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
