// Train-mode BatchNorm over channels-last rows: statistics, finalise, the
// fused normalise + affine + ReLU + cast, and the two-pass backward.
//
// Replaces no TPU kernel. usip_tpu left BatchNorm (usip_tpu/nn/layers.py
// BatchNorm) to XLA, which fuses its reductions and elementwise passes into
// the code around them; PyTorch runs the same arithmetic as separate fp32
// passes (a cast, two reductions, four elementwise passes, a cast back, the
// ReLU, and their backward in reverse), about 180 bytes of device traffic for
// each element of a 2-byte activation in a train step.
//
// What bounds it on the H100: bytes. Each element needs one read for the
// statistics, a read and a write to apply, a read of dy and x for the
// backward sums, and a read of both and a write of dx: about 16 bytes an
// element a step in bf16 (32 in fp32), at 3.35 TB/s; the per-channel
// vectors are small beside them.
//
// What the design does about it:
// * One pass a stage, intermediates in registers. The input is read in its
//   own type (bf16 or fp32) and every sum is taken in fp32 registers; no fp32
//   copy of an activation is ever written, and the backward keeps only the
//   input, the mean and 1/std: x_hat and the ReLU mask are recomputed from
//   them with the forward's own rounding steps (__fsub_rn, __fmul_rn,
//   __fadd_rn), so the mask is the forward's bit for bit.
// * 16-byte loads. A row's channels are cut into vectors of `vec` elements
//   (16 bytes where C and the pointers allow, else 8, 4 or 2); a block of
//   256 threads covers `tile` vectors of `256 / tile` rows at a time and
//   walks a contiguous chunk of rows, four loads in flight a thread. Wide
//   rows (more than 256 vectors) take several channel tiles (grid.y).
// * Enough blocks: the caller (usip_tpu_torch/ops/kernels.py
//   batch_norm_form) gives the card's 132 SMs four blocks each.
// * Deterministic, no atomics. Each block writes its per-channel partial sums
//   to its own row of a scratch tensor; one small kernel merges the rows in a
//   fixed order, in fp64. The same input gives the same bits on every run and
//   under CUDA-graph replay.
// * Capture-safe: no host synchronisation, no allocation (the wrapper makes
//   outputs and scratch with torch.empty); the count of rows is a device
//   float (after a process group's all-reduce, the global count), so one
//   path serves one card and several ranks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// merge: channels a block, partial rows read side by side
constexpr int kMergeCols = 32;
constexpr int kMergeRows = 16;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// the machine word of a vector's bytes, so that a vector moves as one load
// or store (16 bytes: one 128-bit access)
template <int Bytes> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// A thread's place in its block: `slot` its vector of the row, `sub` its
// row of the block's `per` rows at a time, `c0` its first channel.
struct Place {
  int slot, sub, per, c0;
  long long begin, end;
  bool active;
};

template <int V>
__device__ __forceinline__ Place place(long long rows, int c, int tile,
                                       int rows_per_block) {
  Place p;
  const int tid = threadIdx.x;
  p.slot = tid % tile;
  p.sub = tid / tile;
  p.per = kThreads / tile;
  p.c0 = (blockIdx.y * tile + p.slot) * V;
  p.begin = static_cast<long long>(blockIdx.x) * rows_per_block;
  p.end = min(rows, p.begin + rows_per_block);
  p.active = p.sub < p.per && p.c0 < c;
  return p;
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* base, long long row,
                                          int c, int c0) {
  using W = typename Word<sizeof(T) * V>::type;
  Vec<T, V> v;
  *reinterpret_cast<W*>(&v) =
      *reinterpret_cast<const W*>(base + row * c + c0);
  return v;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* base, long long row, int c, int c0,
                                      const Vec<T, V>& v) {
  using W = typename Word<sizeof(T) * V>::type;
  *reinterpret_cast<W*>(base + row * c + c0) =
      *reinterpret_cast<const W*>(&v);
}

// x_hat = (x - mean) * rstd, as the plain version rounds it
__device__ __forceinline__ float normalise(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

// the output before the ReLU, rounded to T as the forward stores it
template <typename T>
__device__ __forceinline__ float affine(float xhat, float w, float b) {
  return to_f<T>(from_f<T>(__fadd_rn(__fmul_rn(xhat, w), b)));
}

// The block's per-thread sums a[V], b[V] -> partials[blockIdx.x] (sums of a
// at [0, C), of b at [C, 2C)), added over the block's rows in a fixed order.
template <int V>
__device__ __forceinline__ void block_partials(const Place& p, const float* a,
                                               const float* b, int c,
                                               int tile,
                                               float* __restrict__ partials) {
  __shared__ float red[2][kThreads * V];
  const int width = tile * V;
  if (p.active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[0][p.sub * width + p.slot * V + i] = a[i];
      red[1][p.sub * width + p.slot * V + i] = b[i];
    }
  }
  __syncthreads();
  const int cb = blockIdx.y * width;
  float* out = partials + static_cast<long long>(blockIdx.x) * 2 * c;
  for (int j = threadIdx.x; j < width && cb + j < c; j += kThreads) {
    float sa = 0.0f, sb = 0.0f;
    for (int k = 0; k < p.per; ++k) {
      sa += red[0][k * width + j];
      sb += red[1][k * width + j];
    }
    out[cb + j] = sa;
    out[c + cb + j] = sb;
  }
}

// Stage 1: per-block sums of x and x^2, by channel.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                long long rows, int c, int tile, int rows_per_block) {
  const Place p = place<V>(rows, c, tile, rows_per_block);
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
  if (p.active) {
    for (long long r = p.begin + p.sub; r < p.end; r += kUnroll * p.per) {
      Vec<T, V> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * p.per < p.end) v[u] = load<T, V>(x, r + u * p.per, c, p.c0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * p.per < p.end) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float f = to_f<T>(v[u].v[i]);
            s[i] += f;
            q[i] = fmaf(f, f, q[i]);
          }
        }
      }
    }
  }
  block_partials<V>(p, s, q, c, tile, partials);
}

// Merge `parts` rows of partial sums in row order, in fp64: out0 the first C
// columns, out1 the next C; count_out (when given) gets `count`.
__global__ void __launch_bounds__(kMergeCols * kMergeRows)
bn_merge_kernel(const float* __restrict__ partials, int parts, int c,
                float* __restrict__ out0, float* __restrict__ out1,
                float* __restrict__ count_out, float count) {
  __shared__ double red[2][kMergeRows][kMergeCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kMergeCols + tx;
  double a = 0.0, b = 0.0;
  if (ch < c) {
    const long long stride = 2LL * c;
#pragma unroll 4
    for (int k = ty; k < parts; k += kMergeRows) {
      a += partials[k * stride + ch];
      b += partials[k * stride + c + ch];
    }
  }
  red[0][ty][tx] = a;
  red[1][ty][tx] = b;
  __syncthreads();
  if (ty == 0 && ch < c) {
    double sa = 0.0, sb = 0.0;
    for (int k = 0; k < kMergeRows; ++k) {
      sa += red[0][k][tx];
      sb += red[1][k][tx];
    }
    out0[ch] = static_cast<float>(sa);
    out1[ch] = static_cast<float>(sb);
  }
  if (count_out != nullptr && blockIdx.x == 0 && tx == 0 && ty == 0)
    *count_out = count;
}

// Stage 2: totals (sum (C), sum of squares (C), count) -> mean, 1/std; the
// running statistics (unbiased variance) and the batch count in place.
__global__ void bn_finalise_kernel(const float* __restrict__ totals, int c,
                                   float* __restrict__ running_mean,
                                   float* __restrict__ running_var,
                                   long long* __restrict__ batches,
                                   double momentum, double eps,
                                   float* __restrict__ mean_out,
                                   float* __restrict__ rstd_out) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch == 0) *batches += 1;
  if (ch >= c) return;
  const double n = totals[2 * c];
  const double mean = totals[ch] / n;
  const float var = static_cast<float>(
      fmax(static_cast<double>(totals[c + ch]) / n - mean * mean, 0.0));
  const float m = static_cast<float>(mean);
  mean_out[ch] = m;
  rstd_out[ch] = 1.0f / sqrtf(__fadd_rn(var, static_cast<float>(eps)));
  const float keep = static_cast<float>(1.0 - momentum);
  const float mom = static_cast<float>(momentum);
  const float unbiased =
      __fmul_rn(var, static_cast<float>(n / fmax(n - 1.0, 1.0)));
  running_mean[ch] =
      __fadd_rn(__fmul_rn(keep, running_mean[ch]), __fmul_rn(mom, m));
  running_var[ch] =
      __fadd_rn(__fmul_rn(keep, running_var[ch]), __fmul_rn(mom, unbiased));
}

struct Channels {
  float mean, rstd, w, b;
};

template <int V>
__device__ __forceinline__ void load_channels(Channels (&ch)[V], int c0,
                                              const float* mean,
                                              const float* rstd,
                                              const float* w, const float* b) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    ch[i] = {mean[c0 + i], rstd[c0 + i], w[c0 + i], b[c0 + i]};
}

// Stage 3: y = act((x - mean) * rstd * w + b), stored in T.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y,
                long long rows, int c, int tile, int rows_per_block) {
  const Place p = place<V>(rows, c, tile, rows_per_block);
  if (!p.active) return;
  Channels ch[V];
  load_channels<V>(ch, p.c0, mean, rstd, w, b);
  for (long long r = p.begin + p.sub; r < p.end; r += kUnroll * p.per) {
    Vec<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * p.per < p.end) v[u] = load<T, V>(x, r + u * p.per, c, p.c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * p.per;
      if (row < p.end) {
        Vec<T, V> out;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float z = affine<T>(
              normalise(to_f<T>(v[u].v[i]), ch[i].mean, ch[i].rstd), ch[i].w,
              ch[i].b);
          out.v[i] = from_f<T>(kRelu && z <= 0.0f ? 0.0f : z);
        }
        store<T, V>(y, row, c, p.c0, out);
      }
    }
  }
}

// dy masked by the forward's ReLU (the output's sign as it was stored)
template <typename T, bool kRelu>
__device__ __forceinline__ float grad_out(T dy, float xhat,
                                          const Channels& ch) {
  const float g = to_f<T>(dy);
  return kRelu && !(affine<T>(xhat, ch.w, ch.b) > 0.0f) ? 0.0f : g;
}

// Stage 4: per-block sums of g and g * x_hat, by channel (the bias's and the
// weight's gradients once merged).
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_backward_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          float* __restrict__ partials, long long rows, int c,
                          int tile, int rows_per_block) {
  const Place p = place<V>(rows, c, tile, rows_per_block);
  float sg[V], sgx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sg[i] = sgx[i] = 0.0f;
  if (p.active) {
    Channels ch[V];
    load_channels<V>(ch, p.c0, mean, rstd, w, b);
    for (long long r = p.begin + p.sub; r < p.end; r += kUnroll * p.per) {
      Vec<T, V> gv[kUnroll], xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * p.per < p.end) {
          gv[u] = load<T, V>(dy, r + u * p.per, c, p.c0);
          xv[u] = load<T, V>(x, r + u * p.per, c, p.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * p.per < p.end) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xhat =
                normalise(to_f<T>(xv[u].v[i]), ch[i].mean, ch[i].rstd);
            const float g = grad_out<T, kRelu>(gv[u].v[i], xhat, ch[i]);
            sg[i] += g;
            sgx[i] = fmaf(g, xhat, sgx[i]);
          }
        }
      }
    }
  }
  block_partials<V>(p, sg, sgx, c, tile, partials);
}

// Stage 5: dx = rstd * w * (g - sum_g / n - x_hat * sum_gx / n), stored in
// T; the sums and n are the group's (global) ones.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_backward_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const float* __restrict__ w,
                         const float* __restrict__ b,
                         const float* __restrict__ sum_g,
                         const float* __restrict__ sum_gx,
                         const float* __restrict__ count, T* __restrict__ dx,
                         long long rows, int c, int tile, int rows_per_block) {
  const Place p = place<V>(rows, c, tile, rows_per_block);
  if (!p.active) return;
  Channels ch[V];
  load_channels<V>(ch, p.c0, mean, rstd, w, b);
  const float n = *count;
  float scale[V], mg[V], mgx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale[i] = ch[i].rstd * ch[i].w;
    mg[i] = sum_g[p.c0 + i] / n;
    mgx[i] = sum_gx[p.c0 + i] / n;
  }
  for (long long r = p.begin + p.sub; r < p.end; r += kUnroll * p.per) {
    Vec<T, V> gv[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * p.per < p.end) {
        gv[u] = load<T, V>(dy, r + u * p.per, c, p.c0);
        xv[u] = load<T, V>(x, r + u * p.per, c, p.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * p.per;
      if (row < p.end) {
        Vec<T, V> out;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat =
              normalise(to_f<T>(xv[u].v[i]), ch[i].mean, ch[i].rstd);
          const float g = grad_out<T, kRelu>(gv[u].v[i], xhat, ch[i]);
          out.v[i] = from_f<T>(scale[i] * (g - fmaf(xhat, mgx[i], mg[i])));
        }
        store<T, V>(dx, row, c, p.c0, out);
      }
    }
  }
}

template <typename T, int V, bool R>
struct Form {
  using type = T;
  static constexpr int vec = V;
  static constexpr bool relu = R;
};

template <typename T, int V, typename F>
int with_relu(int relu, F& f) {
  return relu ? f(Form<T, V, true>{}) : f(Form<T, V, false>{});
}

// Calls f(Form<T, vec, relu>) for the element type (bf16 or fp32) and the
// vector width; a width the type does not take returns cudaErrorInvalidValue.
template <typename F>
int dispatch(int bf16, int vec, int relu, F&& f) {
  if (bf16) {
    switch (vec) {
      case 8: return with_relu<__nv_bfloat16, 8>(relu, f);
      case 4: return with_relu<__nv_bfloat16, 4>(relu, f);
      case 2: return with_relu<__nv_bfloat16, 2>(relu, f);
      case 1: return with_relu<__nv_bfloat16, 1>(relu, f);
    }
  } else {
    switch (vec) {
      case 4: return with_relu<float, 4>(relu, f);
      case 2: return with_relu<float, 2>(relu, f);
      case 1: return with_relu<float, 1>(relu, f);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

int usip_bn_stats(const void* x, void* partials, int rows, int c, int bf16,
                  int vec, int tile, int tiles, int rows_per_block,
                  int blocks, cudaStream_t stream) {
  return dispatch(bf16, vec, 0, [&](auto form) {
    using F = decltype(form);
    using T = typename F::type;
    bn_stats_kernel<T, F::vec><<<dim3(blocks, tiles), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<float*>(partials), rows, c,
        tile, rows_per_block);
    return last_error();
  });
}

int usip_bn_merge(const void* partials, int parts, int c, void* out0,
                  void* out1, void* count_out, float count,
                  cudaStream_t stream) {
  const int grid = (c + kMergeCols - 1) / kMergeCols;
  bn_merge_kernel<<<grid, dim3(kMergeCols, kMergeRows), 0, stream>>>(
      static_cast<const float*>(partials), parts, c,
      static_cast<float*>(out0), static_cast<float*>(out1),
      static_cast<float*>(count_out), count);
  return last_error();
}

int usip_bn_finalise(const void* totals, int c, void* running_mean,
                     void* running_var, void* batches, double momentum,
                     double eps, void* mean, void* rstd,
                     cudaStream_t stream) {
  const int grid = (c + kThreads - 1) / kThreads;
  bn_finalise_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(totals), c,
      static_cast<float*>(running_mean), static_cast<float*>(running_var),
      static_cast<long long*>(batches), momentum, eps,
      static_cast<float*>(mean), static_cast<float*>(rstd));
  return last_error();
}

int usip_bn_apply(const void* x, const void* mean, const void* rstd,
                  const void* w, const void* b, void* y, int rows, int c,
                  int bf16, int relu, int vec, int tile, int tiles,
                  int rows_per_block, int blocks, cudaStream_t stream) {
  return dispatch(bf16, vec, relu, [&](auto form) {
    using F = decltype(form);
    using T = typename F::type;
    bn_apply_kernel<T, F::vec, F::relu>
        <<<dim3(blocks, tiles), kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const float*>(mean),
            static_cast<const float*>(rstd), static_cast<const float*>(w),
            static_cast<const float*>(b), static_cast<T*>(y), rows, c, tile,
            rows_per_block);
    return last_error();
  });
}

int usip_bn_backward_reduce(const void* dy, const void* x, const void* mean,
                            const void* rstd, const void* w, const void* b,
                            void* partials, int rows, int c, int bf16,
                            int relu, int vec, int tile, int tiles,
                            int rows_per_block, int blocks,
                            cudaStream_t stream) {
  return dispatch(bf16, vec, relu, [&](auto form) {
    using F = decltype(form);
    using T = typename F::type;
    bn_backward_reduce_kernel<T, F::vec, F::relu>
        <<<dim3(blocks, tiles), kThreads, 0, stream>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x),
            static_cast<const float*>(mean), static_cast<const float*>(rstd),
            static_cast<const float*>(w), static_cast<const float*>(b),
            static_cast<float*>(partials), rows, c, tile, rows_per_block);
    return last_error();
  });
}

int usip_bn_backward_apply(const void* dy, const void* x, const void* mean,
                           const void* rstd, const void* w, const void* b,
                           const void* sum_g, const void* sum_gx,
                           const void* count, void* dx, int rows, int c,
                           int bf16, int relu, int vec, int tile, int tiles,
                           int rows_per_block, int blocks,
                           cudaStream_t stream) {
  return dispatch(bf16, vec, relu, [&](auto form) {
    using F = decltype(form);
    using T = typename F::type;
    bn_backward_apply_kernel<T, F::vec, F::relu>
        <<<dim3(blocks, tiles), kThreads, 0, stream>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x),
            static_cast<const float*>(mean), static_cast<const float*>(rstd),
            static_cast<const float*>(w), static_cast<const float*>(b),
            static_cast<const float*>(sum_g),
            static_cast<const float*>(sum_gx),
            static_cast<const float*>(count), static_cast<T*>(dx), rows, c,
            tile, rows_per_block);
    return last_error();
  });
}

}  // extern "C"
