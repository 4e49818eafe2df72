// Eval-mode kNN-fusion chain with BatchNorm folded into the weights.
//
// Replaces usip_tpu/ops/pallas_kernels.py fused_fusion_chain /
// _fusion_chain_kernel: per node, over its K neighbours,
//   h = 3 x (dense, ReLU, -> bf16); h_max = max_K h;
//   y = ReLU(h @ w4h + (h_max @ w4m + b4)) -> bf16   (split after0)
//   out = max_K ReLU(y @ w5 + b5)                     (fp32)
// with bf16 operands, fp32 products and sums.
//
// What bounds it on the H100: at B=8, M=512, K=16, Cin=131, C=256, C2=512
// the chain is ~73 GFLOP on 1.4 MB of bf16 weights and 34 MB of input.
// Unfused, its (B, M, K, C) activations would cross device memory five
// times; fused, the tensor-core work is small and the limit is how fast each
// block can feed its tensor cores: weight reads from L2 and the
// shared-memory reads of the activation fragments.
//
// What the design does about it: one block of 8 warps per tile of 64 / K
// nodes (64 rows of K neighbours). The tile's activations stay in shared
// memory, in bf16, across all five layers: two ping-pong buffers
// (64 x max(Cin, C, C2) and 64 x C), the per-node max and the after0 side
// term, ~117 KB at the kitti widths, above the 48 KB default (hence
// cudaFuncAttributeMaxDynamicSharedMemorySize). Only the input is read and
// only the (B, M, C2) output written. Each layer multiplies on the tensor
// cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate): a warp owns 32
// output columns and all 64 rows (4 x 4 tiles, 64 accumulators a thread),
// reads the A fragments from shared memory and the B fragments straight
// from the weight in global memory / L2. The weights (1.4 MB) do not fit
// shared memory; each block streams them once per layer. Row strides are
// padded to 8 mod 64 elements so that a warp's fragment loads hit 32
// distinct banks. wgmma, TMA and a weight ring in shared memory are later
// work.
//
// The weights come transposed, (Cout, Kp) row-major, which is the
// reference's conv layout, with the contraction length Kp padded to a
// multiple of 16 by the host: Cin = 131 is zero-padded to 144 (the padded
// input columns are zero too, so they add nothing).
//
// Rounding points are those of _fusion_chain_kernel: after each of the three
// `before` ReLUs, the per-node max (bf16 already), after the after0 ReLU; the
// last ReLU and the max over K stay fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 64;  // rows (nodes x neighbours) per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpCols = 32;  // output columns a warp owns per pass
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may take

enum Epilogue { kReluBf16, kSide, kAfter0, kAfter1Max };

// shared-memory row stride (elements) for a row of w bf16 values
__host__ __device__ constexpr int ld_of(int w) { return (w + 63) / 64 * 64 + 8; }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Dense {
  const __nv_bfloat16* a;   // activations in shared memory, row stride lda
  int lda;
  int mtiles;               // 16-row tiles of a (1..4)
  int kp;                   // contraction length, a multiple of 16
  const __nv_bfloat16* wt;  // weight, (cout, kp) row-major, global memory
  const float* bias;        // cout, or nullptr
  int cout;                 // a multiple of kWarpCols
};

struct Tile {
  int k;            // neighbours per node
  int tm;           // nodes in this tile's layout
  int nodes_valid;  // nodes of the tile inside the batch
};

template <Epilogue E>
__device__ void dense(const Dense& d, const Tile& tile,
                      __nv_bfloat16* out_bf, int ldo, float* side,
                      float* out_g) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  for (int n0 = warp * kWarpCols; n0 < d.cout; n0 += kWarps * kWarpCols) {
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

#pragma unroll 2
    for (int k0 = 0; k0 < d.kp; k0 += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* w =
            d.wt + static_cast<size_t>(n0 + nt * 8 + g) * d.kp + k0 + 2 * t;
        b[nt][0] = ld32(w);
        b[nt][1] = ld32(w + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < d.mtiles) {
          const __nv_bfloat16* a = d.a + (mt * 16 + g) * d.lda + k0 + 2 * t;
          const uint32_t af[4] = {ld32(a), ld32(a + 8 * d.lda), ld32(a + 8),
                                  ld32(a + 8 * d.lda + 8)};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, b[nt]);
        }
      }
    }

    // epilogue; thread holds rows mt*16 + g (+8), columns col, col + 1
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      if (E == kAfter1Max) {
        const float b0 = d.bias[col], b1 = d.bias[col + 1];
        for (int node = 0; node < tile.tm; ++node) {
          const int lo = node * tile.k, hi = lo + tile.k;
          float m0 = 0.0f, m1 = 0.0f;  // ReLU outputs are >= 0
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = mt * 16 + g + 8 * h;
              if (mt < d.mtiles && r >= lo && r < hi) {
                m0 = fmaxf(m0, fmaxf(acc[mt][nt][2 * h] + b0, 0.0f));
                m1 = fmaxf(m1, fmaxf(acc[mt][nt][2 * h + 1] + b1, 0.0f));
              }
            }
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          if (g == 0 && node < tile.nodes_valid) {
            out_g[static_cast<size_t>(node) * d.cout + col] = m0;
            out_g[static_cast<size_t>(node) * d.cout + col + 1] = m1;
          }
        }
        continue;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= d.mtiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
          float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if (E == kSide) {
            if (r < tile.tm) {
              side[r * d.cout + col] = v0 + d.bias[col];
              side[r * d.cout + col + 1] = v1 + d.bias[col + 1];
            }
            continue;
          }
          if (E == kReluBf16) {
            v0 += d.bias[col];
            v1 += d.bias[col + 1];
          } else {  // kAfter0: the side term of the row's node
            const int node = r / tile.k;
            if (node < tile.tm) {
              v0 += side[node * d.cout + col];
              v1 += side[node * d.cout + col + 1];
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(out_bf + r * ldo + col) =
              __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) fusion_chain_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w3,
    const float* __restrict__ b3, const __nv_bfloat16* __restrict__ w4m,
    const __nv_bfloat16* __restrict__ w4h, const float* __restrict__ b4,
    const __nv_bfloat16* __restrict__ w5, const float* __restrict__ b5,
    float* __restrict__ out, int bm, int k, int cin, int kp1, int c, int c2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tm = kRows / k;
  const int hm_rows = (tm + 15) / 16 * 16;
  const int ldp = ld_of(max(kp1, max(c, c2)));
  const int ldq = ld_of(c);
  __nv_bfloat16* bufp = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bufq = bufp + kRows * ldp;
  __nv_bfloat16* hmax = bufq + kRows * ldq;
  float* side = reinterpret_cast<float*>(hmax + hm_rows * ldq);

  const int node0 = blockIdx.x * tm;
  const Tile tile{k, tm, min(tm, bm - node0)};
  const int rows_valid = tile.nodes_valid * k;
  const float* xb = x + static_cast<size_t>(node0) * k * cin;

  // input tile -> bf16, zero outside the valid rows and past Cin
  for (int e = threadIdx.x; e < kRows * kp1; e += kThreads) {
    const int r = e / kp1;
    const int col = e - r * kp1;
    const float v = (r < rows_valid && col < cin) ? xb[r * cin + col] : 0.0f;
    bufp[r * ldp + col] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  dense<kReluBf16>({bufp, ldp, 4, kp1, w1, b1, c}, tile, bufq, ldq, nullptr,
                   nullptr);
  __syncthreads();
  dense<kReluBf16>({bufq, ldq, 4, c, w2, b2, c}, tile, bufp, ldp, nullptr,
                   nullptr);
  __syncthreads();
  dense<kReluBf16>({bufp, ldp, 4, c, w3, b3, c}, tile, bufq, ldq, nullptr,
                   nullptr);
  __syncthreads();

  // per-node max over the K neighbours; rows past tm stay zero
  for (int e = threadIdx.x; e < hm_rows * c; e += kThreads) {
    const int node = e / c;
    const int ch = e - node * c;
    float m = 0.0f;
    if (node < tm) {
      m = __bfloat162float(bufq[(node * k) * ldq + ch]);
      for (int kk = 1; kk < k; ++kk) {
        m = fmaxf(m, __bfloat162float(bufq[(node * k + kk) * ldq + ch]));
      }
    }
    hmax[node * ldq + ch] = __float2bfloat16_rn(m);  // exact: a bf16 input
  }
  __syncthreads();

  dense<kSide>({hmax, ldq, hm_rows / 16, c, w4m, b4, c2}, tile, nullptr, 0,
               side, nullptr);
  __syncthreads();
  dense<kAfter0>({bufq, ldq, 4, c, w4h, nullptr, c2}, tile, bufp, ldp, side,
                 nullptr);
  __syncthreads();
  dense<kAfter1Max>({bufp, ldp, 4, c2, w5, b5, c2}, tile, nullptr, 0, nullptr,
                    out + static_cast<size_t>(node0) * c2);
}

}  // namespace

extern "C" int usip_fusion_chain(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* w3,
                                 const void* b3, const void* w4m,
                                 const void* w4h, const void* b4,
                                 const void* w5, const void* b5, void* out,
                                 int bm, int k, int cin, int c, int c2,
                                 void* stream) {
  if (k < 1 || k > kRows || c % kWarpCols || c2 % kWarpCols || cin < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tm = kRows / k;
  const int hm_rows = (tm + 15) / 16 * 16;
  const int kp1 = (cin + 15) / 16 * 16;
  int wide = kp1 > c ? kp1 : c;
  wide = wide > c2 ? wide : c2;
  const size_t smem = 2 * static_cast<size_t>(kRows) * ld_of(wide) +
                      2 * static_cast<size_t>(kRows + hm_rows) * ld_of(c) +
                      4 * static_cast<size_t>(tm) * c2;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fusion_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (bm + tm - 1) / tm;
  using bf = const __nv_bfloat16*;
  fusion_chain_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<bf>(w1),
      static_cast<const float*>(b1), static_cast<bf>(w2),
      static_cast<const float*>(b2), static_cast<bf>(w3),
      static_cast<const float*>(b3), static_cast<bf>(w4m),
      static_cast<bf>(w4h), static_cast<const float*>(b4),
      static_cast<bf>(w5), static_cast<const float*>(b5),
      static_cast<float*>(out), bm, k, cin, kp1, c, c2);
  return static_cast<int>(cudaGetLastError());
}
