// Eval-mode kNN-fusion chain with BatchNorm folded into the weights.
//
// Replaces usip_tpu/ops/pallas_kernels.py fused_fusion_chain /
// _fusion_chain_kernel: per node, over its K neighbours,
//   h = 3 x (dense, ReLU, -> bf16); h_max = max_K h;
//   y = ReLU([h_max, h] @ w4 + b4) -> bf16        (after0 on the concat)
//   out = max_K ReLU(y @ w5 + b5)                  (fp32)
// with bf16 operands, fp32 products and sums. The rounding points are those
// of _fusion_chain_kernel: after each of the three `before` ReLUs, the
// per-node max (bf16 already), after the after0 ReLU; the last ReLU and the
// max over K stay fp32. after0's two halves (h_max rows of w4, then h rows)
// are one K = 2C contraction into one fp32 accumulator: the A operand's
// first C columns are h_max broadcast to each of the node's K rows, its last
// C columns are h. That is the concat of the Pallas kernel, summed in
// another order.
//
// What bounds it on the H100: at B=8, M=512, K=16, Cin=131, C=256, C2=512
// the chain is ~74.6 GFLOP of bf16 tensor-core work (0.075 ms at 989
// TFLOP/s) on 34 MB of input and 8 MB of output (0.013 ms at 3.35 TB/s), so
// the tensor cores bound it; each 64-row tile also needs all 1.4 MB of
// weights, ~1.4 GB of L2 reads over the call if every block fetched them.
//
// What the design does about it (sm_90a):
// * wgmma. Two consumer warpgroups each own half the output columns of
//   every layer (m64nNk16, N = C/2 or C2/2); A (the tile's activations) and
//   B (a weight slice) are both read from shared memory through matrix
//   descriptors in the no-swizzle K-major layout: 8x8 core matrices of 128
//   contiguous bytes. The accumulators start at the layer's bias, and each
//   epilogue writes ReLU -> bf16 straight back into that layout (a warp's
//   bf16x2 stores fill one core matrix, no bank conflict); the activations
//   never leave shared memory.
// * A weight ring. One producer warp streams the weights, 32 contraction
//   rows at a time (a "slice", 64 x Cout bytes), into a ring of 4 stages (3
//   where 4 do not fit) with bulk asynchronous copies that complete on
//   mbarriers; the consumers release a stage (another mbarrier) once the
//   wgmmas that read it are done, one slice behind the one in flight.
// * Fewer L2 bytes. Blocks run as clusters of 2 on neighbouring SMs, each
//   with its own 64-row tile; each producer fetches half of every slice and
//   multicasts it into both blocks' rings, so the weights cross L2 once per
//   pair of tiles (about 0.7 GB per call instead of 1.4 GB). A stage is
//   refilled only after the consumers of both blocks released it. The
//   remote release is a plain mbarrier arrive: with a cluster-scope release
//   on every arrive the kernel takes 0.65 ms instead of 0.24 ms on an H100
//   (python -m usip_tpu_torch.ablate).
// * Persistent clusters: as many clusters as fit on the card at once, each
//   walking over pairs of tiles; the ring runs on across tile boundaries,
//   so the next tile's first slices load while the last one finishes.
// * The weights are packed once on the host (kernels.prepare_chain): every
//   slice already in the core-matrix layout the B descriptor reads, so a
//   slice is one contiguous bulk copy and nothing is re-laid out per call.
// What holds it at ~3x its bound (measured on an H100, see PERF.md): the
// weight stream. A block takes in all 1.4 MB for every 64-row tile; with
// the tensor cores idle the kernel still takes ~0.19 ms.
//
// The shared-memory budget decides the tile: 64 rows (64 / K nodes of K
// neighbours). At C=256, C2=512, Cin=131 (padded to 160):
//   P   64 x 512 bf16 (input, h2, h_max broadcast, y)  66,560 B
//   Q   64 x 256 bf16 (h1, h3; the output staging,
//       4 nodes x 512 fp32, during after1)             33,280 B
//   ring 4 stages x 32 x 512 bf16                     131,072 B
//   8 mbarriers and padding                                64 B
// = 230,976 of the 232,448 bytes a block may take. 128 rows do not fit
// with a ring: the 512-wide y and the 256-wide h3 coexist in after0, 192 KB
// before any weight stage. Each k-group of 8 columns is 64 rows x 16 B =
// 1,024 B plus 16 B of padding, so that the node-max pass, whose lanes
// read one row across k-groups, spreads over all 32 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 64;        // rows (nodes x neighbours) per tile
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kCluster = 2;
constexpr int kMaxStages = 4;  // weight stages, as many as fit (3 or 4)
constexpr int kSlice = 32;       // contraction rows per weight slice
constexpr int kPack = 32;        // the host pads each layer's rows to this
constexpr int kGroupBytes = kRows * 16 + 16;  // one k-group of a buffer
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ------------------------------------------------------------- PTX glue --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// arrive on the barrier at the same offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      ::"r"(bar), "r"(rank) : "memory");
}

// bulk copy of `bytes` from global memory into the same shared-memory
// offset of every block of the cluster, completing on each block's `bar`
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar) {
  if constexpr (kCluster == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
  } else {
    const uint16_t mask = (1u << kCluster) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the 256 consumer threads only (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// generic-proxy shared-memory writes made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, no swizzle, K-major:
// lbo = bytes between the two core matrices along K,
// sbo = bytes between core matrices along M (or N for B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// byte offset of element (row r, column c) in an activation buffer:
// k-group c / 8 (kGroupBytes apart), then 8-row group, row, column
__device__ __forceinline__ int act_off(int r, int c) {
  return (c >> 3) * kGroupBytes + (r >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

// D (64 x N fp32) += A (64 x 16 bf16) . B (16 x N bf16), one warpgroup
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ------------------------------------------------------ the weight ring --

struct Ring {
  uint32_t base;   // shared address of stage 0
  uint32_t full;   // full[0]: a slice has landed (8 bytes a stage)
  uint32_t empty;  // empty[0]: the cluster's consumers released a stage
  uint32_t stage_bytes;
  int stages;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  // every consumer warp of the cluster arrives on every block's empty[s]
  __device__ __forceinline__ void release(int s, int lane) const {
    if (lane != 0) return;
    mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int r = 1; r < kCluster; ++r) {
      mbar_arrive_cluster(empty + 8 * s, (cluster_rank() + r) % kCluster);
    }
  }
};

// The accumulator fragment of m64nNk16: warp wi of the warpgroup holds rows
// 16 wi + g and 16 wi + g + 8 (g = lane / 4); acc[4 j .. 4 j + 3] are the
// columns 8 j + 2 (lane % 4) and the one after, of those two rows.

// acc (64 x N fp32) = bias + A (64 x kp) . the warpgroup's N columns
// [col0, col0 + N) of the layer's weight, slice by slice from the ring. A's
// columns [0, split) are in activation buffer a0, [split, kp) in a1
// (after0's concat). The accumulator starts at the bias (fp32), so the
// epilogue has no add and the bias loads overlap the first slice's wait.
template <int N>
__device__ __forceinline__ void mma_layer(float (&acc)[N / 2], Ring& ring,
                                          uint32_t a0, uint32_t a1, int split,
                                          int kp, int n_total,
                                          const float* __restrict__ bias,
                                          int wg, int lane) {
  const float* b = bias + wg * N + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j);
    acc[4 * j] = acc[4 * j + 2] = bb.x;
    acc[4 * j + 1] = acc[4 * j + 3] = bb.y;
  }
  fence_regs(acc);
  const uint32_t lbo_b = n_total * 16;  // next k-group of a slice
  const uint32_t col_b = wg * (N / 8) * 128;
  int prev = -1;
  for (int k0 = 0; k0 < kp; k0 += kSlice) {
    mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    const uint32_t b = ring.base + ring.stage * ring.stage_bytes + col_b;
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kSlice / 16; ++h) {
      const int kk = k0 + 16 * h;
      const uint32_t a = kk < split ? a0 + (kk >> 3) * kGroupBytes
                                    : a1 + ((kk - split) >> 3) * kGroupBytes;
      Wgmma<N>::mma(acc, make_desc(a, kGroupBytes, 128),
                    make_desc(b + h * 2 * lbo_b, lbo_b, 128), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products are done
    if (prev >= 0) ring.release(prev, lane);
    prev = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(prev, lane);
}

// ReLU -> bf16 into an activation buffer: one base address a thread, the
// n8 blocks kGroupBytes apart and row + 8 128 bytes on
template <int N>
__device__ __forceinline__ void store_relu_bf16(const float (&acc)[N / 2],
                                                unsigned char* buf, int col0,
                                                int wi, int lane) {
  unsigned char* p =
      buf + act_off(wi * 16 + (lane >> 2), col0 + 2 * (lane & 3));
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(p + j * kGroupBytes) =
        __floats2bfloat162_rn(fmaxf(acc[4 * j], 0.0f),
                              fmaxf(acc[4 * j + 1], 0.0f));
    *reinterpret_cast<__nv_bfloat162*>(p + j * kGroupBytes + 128) =
        __floats2bfloat162_rn(fmaxf(acc[4 * j + 2], 0.0f),
                              fmaxf(acc[4 * j + 3], 0.0f));
  }
}

// ReLU, max over each node's K rows (fp32) into the tile's output
// staging: ReLU outputs are >= 0, so their bits order as ints
template <int N>
__device__ __forceinline__ void store_node_max(const float (&acc)[N / 2],
                                               int* staging, int col0,
                                               int n_total, int k,
                                               int nodes_valid, int wi,
                                               int lane) {
  const int g = lane >> 2;
  const int r0 = wi * 16 + g;
  if (k % 16 == 0) {  // the warp's 16 rows belong to one node
    const int node = (wi * 16) / k;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + j * 8 + 2 * (lane & 3);
      float m0 = fmaxf(fmaxf(acc[4 * j], acc[4 * j + 2]), 0.0f);
      float m1 = fmaxf(fmaxf(acc[4 * j + 1], acc[4 * j + 3]), 0.0f);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      if (g == 0 && node < nodes_valid) {
        atomicMax(staging + node * n_total + col, __float_as_int(m0));
        atomicMax(staging + node * n_total + col + 1, __float_as_int(m1));
      }
    }
    return;
  }
  const int n0 = r0 / k, n1 = (r0 + 8) / k;  // >= nodes_valid: not stored
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + j * 8 + 2 * (lane & 3);
    if (n0 < nodes_valid) {
      int* o = staging + n0 * n_total + col;
      atomicMax(o, __float_as_int(fmaxf(acc[4 * j], 0.0f)));
      atomicMax(o + 1, __float_as_int(fmaxf(acc[4 * j + 1], 0.0f)));
    }
    if (n1 < nodes_valid) {
      int* o = staging + n1 * n_total + col;
      atomicMax(o, __float_as_int(fmaxf(acc[4 * j + 2], 0.0f)));
      atomicMax(o + 1, __float_as_int(fmaxf(acc[4 * j + 3], 0.0f)));
    }
  }
}

// the tile's input rows (rows_valid x cin fp32, contiguous) -> bf16 in
// buffer P, zero outside the valid rows and past cin. The loads of a thread
// are all issued before the first store (kLoadBatch at a time), so a tile
// costs a few memory latencies, not one per element.
constexpr int kLoadBatch = 8;

__device__ __forceinline__ void load_input(const float* __restrict__ xb,
                                           unsigned char* buf, int rows_valid,
                                           int cin, int kp1, int tid) {
  const int total = rows_valid * cin;
  const bool vec = (reinterpret_cast<uintptr_t>(xb) & 15) == 0;
  const int nvec = vec ? total / 4 : 0;
  for (int v0 = 0; v0 < nvec; v0 += kLoadBatch * kConsumers) {
    float4 v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = v0 + j * kConsumers + tid;
      v[j] = i < nvec ? reinterpret_cast<const float4*>(xb)[i]
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = v0 + j * kConsumers + tid;
      if (i >= nvec) break;
      const float f[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      int r = (4 * i) / cin, col = 4 * i - r * cin;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<__nv_bfloat16*>(buf + act_off(r, col)) =
            __float2bfloat16_rn(f[q]);
        if (++col == cin) {
          col = 0;
          ++r;
        }
      }
    }
  }
  for (int s0 = 4 * nvec; s0 < total; s0 += kLoadBatch * kConsumers) {
    float v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = s0 + j * kConsumers + tid;
      v[j] = i < total ? xb[i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = s0 + j * kConsumers + tid;
      if (i < total) {
        const int r = i / cin;
        *reinterpret_cast<__nv_bfloat16*>(buf + act_off(r, i - r * cin)) =
            __float2bfloat16_rn(v[j]);
      }
    }
  }
  // zero: the columns past cin of the valid rows, every column of the rest
  const int pad = kp1 - cin;
  for (int e = tid; e < rows_valid * pad; e += kConsumers) {
    const int r = e / pad;
    *reinterpret_cast<__nv_bfloat16*>(buf + act_off(r, cin + e - r * pad)) =
        __float2bfloat16_rn(0.0f);
  }
  for (int e = tid; e < (kRows - rows_valid) * (kp1 / 2); e += kConsumers) {
    const int r = rows_valid + e / (kp1 / 2);
    const int col = 2 * (e % (kp1 / 2));
    *reinterpret_cast<__nv_bfloat162*>(buf + act_off(r, col)) =
        __floats2bfloat162_rn(0.0f, 0.0f);
  }
}

template <int N>
__device__ __forceinline__ void relu_layer_n(
    Ring& ring, uint32_t a0, uint32_t a1, int split, int kp, int n_total,
    const float* __restrict__ bias, unsigned char* out, bool in_place, int wg,
    int wi, int lane) {
  float acc[N / 2];
  mma_layer<N>(acc, ring, a0, a1, split, kp, n_total, bias, wg, lane);
  // the epilogue overwrites what the other warpgroup may still be reading
  if (in_place) consumers_sync();
  store_relu_bf16<N>(acc, out, wg * N, wi, lane);
}

template <int N>
__device__ __forceinline__ void max_layer_n(
    Ring& ring, uint32_t a, int kp, int n_total,
    const float* __restrict__ bias, int* staging, int k, int nodes_valid,
    int wg, int wi, int lane) {
  float acc[N / 2];
  mma_layer<N>(acc, ring, a, a, kp, kp, n_total, bias, wg, lane);
  store_node_max<N>(acc, staging, wg * N, n_total, k, nodes_valid, wi, lane);
}

// the wgmma width is an immediate: one instantiation per warpgroup width
#define USIP_WITH_WIDTH(nw, CALL)  \
  switch (nw) {                    \
    case 16: CALL(16); break;      \
    case 32: CALL(32); break;      \
    case 64: CALL(64); break;      \
    case 128: CALL(128); break;    \
    default: CALL(256); break;     \
  }

// Shared-memory layout of a block: P, Q, the output staging (inside Q when
// it fits: Q's h3 is dead by after1), the weight ring (4 stages where they
// fit, else 3), the mbarriers. kernels.fusion_chain_smem mirrors it.
struct Layout {
  int tm, stages;
  uint32_t stage_bytes;
  size_t q, staging, ring, bars, total;
};

__host__ __device__ inline Layout layout_of(int k, int kp1, int c, int c2) {
  Layout l;
  const int wp = kp1 > c ? (kp1 > c2 ? kp1 : c2) : (c > c2 ? c : c2);
  l.tm = kRows / k;
  l.stage_bytes = kSlice * 2 * (c > c2 ? c : c2);
  l.q = static_cast<size_t>(wp / 8) * kGroupBytes;
  const size_t q_bytes = static_cast<size_t>(c / 8) * kGroupBytes;
  const size_t st_bytes = static_cast<size_t>(l.tm) * c2 * 4;
  const bool in_q = st_bytes <= q_bytes;
  l.staging = in_q ? l.q : l.q + q_bytes;
  l.ring = l.q + q_bytes + (in_q ? 0 : st_bytes);
  for (l.stages = kMaxStages; l.stages > 3; --l.stages) {
    if (l.ring + static_cast<size_t>(l.stages) * (l.stage_bytes + 16) <=
        kMaxSmem) {
      break;
    }
  }
  l.bars = l.ring + static_cast<size_t>(l.stages) * l.stage_bytes;
  l.total = l.bars + 16 * l.stages;
  return l;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
fusion_chain_kernel(const float* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ b1, const float* __restrict__ b2,
                    const float* __restrict__ b3, const float* __restrict__ b4,
                    const float* __restrict__ b5, float* __restrict__ out,
                    int bm, int k, int cin, int kp1, int c, int c2,
                    int npairs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout_of(k, kp1, c, c2);
  unsigned char* buf_p = smem;
  unsigned char* buf_q = smem + lay.q;
  unsigned char* ring_mem = smem + lay.ring;
  int* staging = reinterpret_cast<int*>(smem + lay.staging);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const int stages = lay.stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const int cid = blockIdx.x / kCluster;
  const int nclusters = gridDim.x / kCluster;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(bars + s), 1);
      mbar_init(smem_addr(bars + stages + s), kCluster * kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // both blocks' barriers exist before any multicast

  const uint32_t ring_base = smem_addr(ring_mem);
  const uint32_t full0 = smem_addr(bars);
  // the five layers' contraction and output widths, in streaming order
  const int layer_kp[5] = {kp1, c, c, 2 * c, c2};
  const int layer_n[5] = {c, c, c, c2, c2};

  if (warp == kConsumers / 32) {
    // ---- producer: one thread streams every slice of every tile's layers
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      const uint32_t empty0 = full0 + 8 * stages;
      for (int pair = cid; pair < npairs; pair += nclusters) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(w);
        for (int l = 0; l < 5; ++l) {
          const uint32_t bytes = kSlice * 2 * layer_n[l];
          const uint32_t half = bytes / kCluster;
          for (int k0 = 0; k0 < layer_kp[l]; k0 += kSlice) {
            mbar_wait(empty0 + 8 * stage, phase ^ 1u);
            mbar_expect_tx(full0 + 8 * stage, bytes);
            bulk_multicast(ring_base + stage * lay.stage_bytes + rank * half,
                           src + rank * half, half, full0 + 8 * stage);
            src += bytes;
            if (++stage == stages) {
              stage = 0;
              phase ^= 1u;
            }
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: two warpgroups, each half of every layer's columns
    const int wg = warp >> 2;
    const int wi = warp & 3;
    Ring ring{ring_base, full0, full0 + 8 * stages, lay.stage_bytes, stages,
              0, 0u};
    const uint32_t ap = smem_addr(buf_p), aq = smem_addr(buf_q);
    for (int pair = cid; pair < npairs; pair += nclusters) {
      const int node0 = (pair * kCluster + static_cast<int>(rank)) * lay.tm;
      const int nodes_valid = max(0, min(lay.tm, bm - node0));
      const int rows_valid = nodes_valid * k;
      const float* xb = x + static_cast<size_t>(node0) * k * cin;

      load_input(xb, buf_p, rows_valid, cin, kp1, tid);
      fence_async_smem();
      consumers_sync();

      // before0..2, then after0 on [h_max, h]: A buffers (first `split`
      // columns from a0), bias, output buffer
      const uint32_t l_a0[4] = {ap, aq, ap, ap};
      const uint32_t l_a1[4] = {ap, aq, ap, aq};
      const int l_split[4] = {kp1, c, c, c};
      const float* l_bias[4] = {b1, b2, b3, b4};
      unsigned char* l_out[4] = {buf_q, buf_p, buf_q, buf_p};
      for (int l = 0; l < 4; ++l) {
#define USIP_RELU_LAYER(NW)                                                  \
  relu_layer_n<NW>(ring, l_a0[l], l_a1[l], l_split[l], layer_kp[l],       \
                   layer_n[l], l_bias[l], l_out[l], l == 3, wg, wi, lane)
        USIP_WITH_WIDTH(layer_n[l] / 2, USIP_RELU_LAYER)
#undef USIP_RELU_LAYER
        fence_async_smem();
        consumers_sync();
        if (l != 2) continue;
        // per-node max of h3 (Q), broadcast to the node's K rows of P's
        // first C columns: after0's A operand is [h_max, h]
        for (int e = tid; e < lay.tm * (c / 2); e += kConsumers) {
          const int node = e / (c / 2);
          const int col = 2 * (e - node * (c / 2));
          const int r0 = node * k;
          __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(
              buf_q + act_off(r0, col));
          for (int kk = 1; kk < k; ++kk) {
            m = __hmax2(m, *reinterpret_cast<const __nv_bfloat162*>(
                               buf_q + act_off(r0 + kk, col)));
          }
          for (int kk = 0; kk < k; ++kk) {
            *reinterpret_cast<__nv_bfloat162*>(buf_p + act_off(r0 + kk,
                                                               col)) = m;
          }
        }
        fence_async_smem();
        consumers_sync();
      }
      // after1, ReLU and the max over each node's K rows into the zeroed
      // staging (which may lie in Q: h3 is dead now)
      for (int e = tid; e < lay.tm * c2 / 4; e += kConsumers) {
        reinterpret_cast<int4*>(staging)[e] = make_int4(0, 0, 0, 0);
      }
      consumers_sync();
#define USIP_MAX_LAYER(NW)                                                 \
  max_layer_n<NW>(ring, ap, c2, c2, b5, staging, k, nodes_valid, wg, wi,   \
                  lane)
      USIP_WITH_WIDTH(c2 / 2, USIP_MAX_LAYER)
#undef USIP_MAX_LAYER
      consumers_sync();

      // the tile's (nodes, C2) output
      const int4* st4 = reinterpret_cast<const int4*>(staging);
      int4* out4 =
          reinterpret_cast<int4*>(out + static_cast<size_t>(node0) * c2);
      for (int e = tid; e < nodes_valid * c2 / 4; e += kConsumers) {
        out4[e] = st4[e];
      }
    }
  }
  __syncwarp();
  cluster_sync();  // no block leaves while its peer may still signal it
}

#undef USIP_WITH_WIDTH

bool width_ok(int c) {
  return c == 32 || c == 64 || c == 128 || c == 256 || c == 512;
}

}  // namespace

// w: the weights packed by kernels.prepare_chain (bf16, every layer's
// slices in the B descriptor's layout); b1..b5 fp32; out (bm, c2) fp32
extern "C" int usip_fusion_chain(const void* x, const void* w, const void* b1,
                                 const void* b2, const void* b3,
                                 const void* b4, const void* b5, void* out,
                                 int bm, int k, int cin, int c, int c2,
                                 void* stream) {
  if (k < 1 || k > kRows || cin < 1 || !width_ok(c) || !width_ok(c2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kp1 = round_up(cin, kPack);
  const size_t smem = layout_of(k, kp1, c, c2).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fusion_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tm = kRows / k;
  const int tiles = (bm + tm - 1) / tm;
  const int npairs = (tiles + kCluster - 1) / kCluster;
  // persistent: as many clusters as the card holds at once (asked once per
  // shared-memory size; clusters need SM pairs within one GPC)
  static size_t asked_smem = 0;
  static int max_clusters = 0;
  if (asked_smem != smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * npairs, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    err = cudaOccupancyMaxActiveClusters(&max_clusters, fusion_chain_kernel,
                                         &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
    asked_smem = smem;
  }
  const int clusters = npairs < max_clusters ? npairs : max_clusters;
  fusion_chain_kernel<<<kCluster * clusters, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const float*>(b3), static_cast<const float*>(b4),
      static_cast<const float*>(b5), static_cast<float*>(out), bm, k, cin,
      kp1, c, c2, npairs);
  return static_cast<int>(cudaGetLastError());
}
