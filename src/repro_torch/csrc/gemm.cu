// The fp32 products of the served models on the tensor cores in
// split-TF32: y (M, N) = x (M, K) @ w (K, N), all row-major fp32.
//
// Replaces no TPU kernel: the JAX package leaves its products to XLA.
// Added because cuBLAS runs an fp32 product on the CUDA cores (67
// TFLOP/s on an H100 SXM, TF32 off), and the benchmark's limits allow no
// plain TF32 product (~3e-4 rel-L2 against limits of 2e-5 to 6e-5).
// Each operand x splits into hi = tf32(x), rounded to nearest, and lo =
// tf32(x - hi) (mma.cuh: split_tf32), and each product is three TF32
// ones, w_lo x_hi + w_hi x_lo + w_hi x_hi, the small terms first, as
// K2's and K4's fp32 kernels compute theirs (495 TFLOP/s dense TF32, so
// 165 TFLOP/s of fp32 work).  Bound: operations, 2 M N K of them, at
// every shape the served DiTs run (18,480 x 3072 x 3072: 2,900 fp32
// operations a byte).
//
// Design (an H100: wgmma, TMA, mbarriers; one persistent block an SM):
//   * The product is computed transposed, y^T = w^T x^T, so that neither
//     operand needs a transpose in shared memory: wgmma's TF32 operands
//     must be K-major in shared memory (the transpose flags are for
//     16-bit types only), and of the two only x is (its rows run along
//     k).  x is wgmma's B, in shared memory in the 128-byte swizzle as
//     hi and lo, two buffers of one layout; w^T is wgmma's A, from
//     registers: each consumer thread loads its fragment of the w tile
//     (32 k x 128 output columns, as TMA brings it: four boxes of 32
//     columns in the 128-byte swizzle) and splits it there.  No second
//     copy of the weights exists anywhere.
//   * A tile is BT rows (96 or 128: ops.gemm_tile_rows picks the one
//     whose waves over the SMs cost least) x 128 output columns, and a
//     k step (a stage) is 32.  Warp roles: two consumer warpgroups, each
//     64 output columns (one m64nBTk8 accumulator), and a producer
//     warpgroup that reads x's tile from global memory (each warp 4 rows
//     of 128 contiguous bytes, started before it waits for the stage to
//     be free), splits it in registers and stores hi and lo, and whose
//     first thread starts w's four TMA loads.  x never lands in shared
//     memory unsplit: that round trip cost ~5% at video's shapes (an
//     H100 SXM, PERF.md §6).  Four stages in a ring, mbarriers full
//     (w landed), ready (x split) and empty (consumed).
//   * Each stage a consumer warpgroup runs twelve wgmma (three a k8
//     step) into a fresh accumulator and adds it to its running sum on
//     the CUDA cores, rounding to nearest: the tensor cores truncate their
//     fp32 sums, which summed straight over K = 14,336 (5,376 products an
//     output) drift to 1e-4 rel-L2 (mma.cuh: kSumSteps).
//   * The rows of A (output columns) are permuted so that a thread's two
//     rows (g and g + 8 of its warp's 16) are adjacent columns: its
//     fragment loads are 8-byte loads free of bank conflicts in the
//     swizzled w tile, and its stores are 8-byte stores.
//   * The grid is min(tiles, SMs) blocks walking the tiles in bands of
//     kGroup output-column tiles, so that the blocks in flight share
//     their w tiles and x rows in L2; the producer runs ahead into a
//     block's next tile while its consumers store the last one.
//   * Ragged edges: reads past M and K, and TMA's past N and K, give
//     zeros; the stores are masked.  x and w 16-byte aligned, N and K
//     multiples of 4: x's rows are read in 16-byte pieces, and TMA
//     takes w's row stride in 16-byte units.
#include "common.cuh"
#include "mma.cuh"

#include <cuda.h>

#include <cstdint>

namespace gfdit {
namespace gemm {

constexpr int kBF = 128;          // output columns a tile (2 x 64)
constexpr int kBK = 32;           // k a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;     // 2 consumer warpgroups + the producer's
constexpr int kProducerThreads = 128;
constexpr int kConsumerWarps = 8;
constexpr int kGroup = 8;         // output-column tiles a band
constexpr int kBox = kBK * 32 * 4;  // one w box: 32 k x 32 columns

template <int BT>
struct Layout {
  static constexpr int kX = BT * kBK * 4;  // x's hi, and its lo
  static constexpr int kW = kBK * kBF * 4;
  static constexpr int kStage = 2 * kX + kW;
  static constexpr int kBars = kStages * kStage;
  // + the barriers, + slack to align the base to the swizzle's 1024 bytes
  static constexpr int kBytes = kBars + 3 * kStages * 8 + 1024;
  static_assert(kX % 1024 == 0, "x tiles on swizzle-atom boundaries");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Waits until the phase of parity `parity` has completed.  A wait of
// over 4 s (no stage takes a millisecond) means an arrival was lost: it
// traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned long long start = 0;
  while (true) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > 4000000000ull)
      __trap();
  }
}

// A 2-d TMA load of the box at (c0 inner, c1 outer) into `dst`, counted
// on `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart.  A k8 step further along the
// row is +32 bytes: +2 in the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of `d` across a wgmma
// launch or wait.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32, the accumulator layout) (+)= a (64 x 8, TF32, from
// registers: warp w's rows 16w + {g, g + 8}, columns {t, t + 4}) times the
// N x 8 K-major TF32 tile at `desc`; scale_d = 0 ignores d's old value.
template <int N>
struct Wgmma;

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48],
                                             const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};


// Tile t of the walk: bands of kGroup output-column tiles, each band's
// tiles row tile by row tile.
__device__ __forceinline__ void tile_of(int t, int row_tiles, int col_tiles,
                                        int& rt, int& ct) {
  const int band = t / (kGroup * row_tiles);
  const int c0 = band * kGroup;
  const int width = min(kGroup, col_tiles - c0);
  const int r = t - band * kGroup * row_tiles;
  rt = r / width;
  ct = c0 + r % width;
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap map_w,
                       const float* __restrict__ x, float* __restrict__ y,
                       int M, int N, int K) {
  using L = Layout<BT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kProducerThreads);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int row_tiles = (M + BT - 1) / BT, col_tiles = (N + kBF - 1) / kBF;
  const int tiles = row_tiles * col_tiles, nk = (K + kBK - 1) / kBK;

  if (warp >= kConsumerWarps) {
    // ---- the producer warpgroup: x's tile from global memory, split
    // into hi and lo in the swizzle; thread 0 also starts w's TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n");
    const int pid = threadIdx.x - kConsumerWarps * 32;
    constexpr int kUnits = BT * kBK / 4 / kProducerThreads;  // float4s
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int rt, ct;
      tile_of(t, row_tiles, col_tiles, rt, ct);
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % kStages;
        // a warp reads 4 rows of 128 contiguous bytes; rows past M and
        // columns past K read as zeros (K % 4 == 0: a float4 is whole)
        float4 v[kUnits];
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const int q = pid + u * kProducerThreads;
          const int r = rt * BT + (q >> 3), k = kb * kBK + 4 * (q & 7);
          v[u] = r < M && k < K
                     ? __ldg(reinterpret_cast<const float4*>(
                           x + static_cast<long long>(r) * K + k))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * L::kStage;
        if (pid == 0) {
          mbar_expect_tx(&full[s], L::kW);
#pragma unroll
          for (int b = 0; b < kBF / 32; ++b)
            tma_load(st + 2 * L::kX + b * kBox, &map_w, &full[s],
                     ct * kBF + 32 * b, kb * kBK);
        }
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const int q = pid + u * kProducerThreads;
          const int row = q >> 3;
          // 16-byte unit q & 7 of the row, where the 128-byte swizzle
          // puts it
          const int off = row * 128 + (((q & 7) ^ (row & 7)) << 4);
          const Tf32Split a = split_tf32(v[u].x), b = split_tf32(v[u].y),
                          c = split_tf32(v[u].z), d = split_tf32(v[u].w);
          *reinterpret_cast<uint4*>(st + off) = make_uint4(a.hi, b.hi, c.hi,
                                                           d.hi);
          *reinterpret_cast<uint4*>(st + L::kX + off) =
              make_uint4(a.lo, b.lo, c.lo, d.lo);
        }
        // the generic stores, before wgmma reads them through the async
        // proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[s]);
      }
    }
  } else {
    // ---- the consumer warpgroups: 64 output columns each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int wg = warp >> 2, cw = warp & 3;
    const int g = lane >> 2, tq = lane & 3;
    // the thread's output columns c and c + 1 (its A rows g and g + 8) in
    // w box `box`: every (g, tq) of a half-warp on its own 8 bytes of the
    // swizzled rows tq (+ 4), so the fragment loads are conflict-free
    const int c = 8 * (cw & 1) + 16 * ((g & 3) >> 1) + 4 * (g >> 2) +
                  2 * (g & 1);
    const int box = 2 * wg + (cw >> 1);
    const int off_lo = tq * 128 + (((c >> 2) ^ tq) << 4) + ((c & 3) << 2);
    const int off_hi =
        (tq + 4) * 128 + (((c >> 2) ^ (tq + 4)) << 4) + ((c & 3) << 2);
    constexpr int R = BT / 2;
    float total[R], part[R] = {};
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int rt, ct;
      tile_of(t, row_tiles, col_tiles, rt, ct);
#pragma unroll
      for (int i = 0; i < R; ++i) total[i] = 0.f;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % kStages;
        const unsigned ph = (it / kStages) & 1;
        mbar_wait(&full[s], ph);    // w, as TMA wrote it
        mbar_wait(&ready[s], ph);   // x split
        __syncwarp();               // wgmma runs on converged warps
        const unsigned char* st = smem + s * L::kStage;
        const unsigned char* wb = st + 2 * L::kX + box * kBox;
        unsigned ahi[4][4], alo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 u =
              *reinterpret_cast<const float2*>(wb + j * 8 * 128 + off_lo);
          const float2 v =
              *reinterpret_cast<const float2*>(wb + j * 8 * 128 + off_hi);
          // rows g, g + 8 at k tq (u) and k tq + 4 (v)
          split_a(ahi[j], alo[j], u.x, u.y, v.x, v.y);
        }
        const uint64_t dhi = sw128_desc(st), dlo = sw128_desc(st + L::kX);
        pin(part);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Wgmma<BT>::mma(part, alo[j], dhi + 2 * j, j);
          Wgmma<BT>::mma(part, ahi[j], dlo + 2 * j, 1);
          Wgmma<BT>::mma(part, ahi[j], dhi + 2 * j, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(part);
#pragma unroll
        for (int i = 0; i < R; ++i) total[i] += part[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      // rows m0 + 8j + 2tq (+1), columns col and col + 1
      const int col = ct * kBF + 32 * box + c;
      if (col < N) {
        const int r0 = rt * BT + 2 * tq;
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
          const int r = r0 + 8 * j;
          if (r < M)
            *reinterpret_cast<float2*>(y + static_cast<long long>(r) * N +
                                       col) =
                make_float2(total[4 * j], total[4 * j + 2]);
          if (r + 1 < M)
            *reinterpret_cast<float2*>(y + static_cast<long long>(r + 1) * N +
                                       col) =
                make_float2(total[4 * j + 1], total[4 * j + 3]);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links no libcuda); null where it is missing.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// w (K x N, row-major fp32) cut into boxes of 32 k x 32 columns, in the
// 128-byte swizzle; reads past its edges give zeros.
inline cudaError_t w_map(CUtensorMap* map, const float* w, int K, int N) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t box[2] = {32, kBK};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BT>
cudaError_t launch(const float* x, const float* w, float* y, int M, int N,
                   int K, int device, cudaStream_t stream) {
  cudaError_t err =
      allow_smem_once<gemm_3xtf32_kernel<BT>>(Layout<BT>::kBytes, device);
  if (err != cudaSuccess) return err;
  CUtensorMap mw;
  if ((err = w_map(&mw, w, K, N)) != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((M + BT - 1) / BT) * ((N + kBF - 1) / kBF);
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gemm_3xtf32_kernel<BT>
      <<<grid, kThreads, Layout<BT>::kBytes, stream>>>(mw, x, y, M, N, K);
  return cudaGetLastError();
}

template <int BT>
cudaError_t occupancy(int device, int* blocks, int* smem) {
  return occupancy_of<gemm_3xtf32_kernel<BT>>(Layout<BT>::kBytes, kThreads,
                                              device, blocks, smem);
}

}  // namespace gemm
}  // namespace gfdit

// y (M, N) = x (M, K) @ w (K, N), row-major fp32, in split-TF32 on the
// tensor cores, in tiles of `rows` (96 or 128) x 128; x and w 16-byte
// aligned, N and K multiples of 4.
extern "C" int gfdit_gemm(const float* x, const float* w, float* y, int M,
                          int N, int K, int rows, int device, void* stream) {
  using namespace gfdit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || K % 4 ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15) ||
      (reinterpret_cast<uintptr_t>(y) & 7) || device < 0 ||
      device >= kMaxDevices)
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 96: return gemm::launch<96>(x, w, y, M, N, K, device, s);
    case 128: return gemm::launch<128>(x, w, y, M, N, K, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM and dynamic shared bytes of the kernel with
// tiles of `rows` rows, from the CUDA occupancy calculator.
extern "C" int gfdit_gemm_occupancy(int rows, int device, int* blocks,
                                    int* smem) {
  using namespace gfdit;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  switch (rows) {
    case 96: return gemm::occupancy<96>(device, blocks, smem);
    case 128: return gemm::occupancy<128>(device, blocks, smem);
    default: return cudaErrorInvalidValue;
  }
}
