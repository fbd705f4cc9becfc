// Backward of flash attention (K2), FlashAttention-2's shape.
//
// The TPU kernel src/repro/kernels/flash_attention.py::flash_attention has
// no backward: the JAX package trains through its jnp attention.  The port
// has one path, always the kernel, so its training caller needs these.
// They compute the gradient of the same function, held to the closed form
// of repro_torch/kernels/ref.py::attention_bwd_ref (jax.vjp of the JAX
// oracle computes the same), for every case the forward takes: the head
// dims of ops.HEAD_DIMS, fp32 and bf16, GQA, causal (Sq = Sk), non-causal
// with Sq != Sk (cross-attention), ragged Sq and Sk.
//
// With S the scaled scores, lse each query row's log-sum-exp (written by
// the forward), P = exp(S - lse), D = rowsum(dO * O) and
// dS = P * (dP - D), dP = dO V^T:  dV = P^T dO,  dK = scale dS^T Q,
// dQ = scale dS K.  Three launches:
//   1. attn_bwd_delta_kernel: D, one warp a (batch, query, head) row.
//   2. a dK/dV kernel: one block a (batch, KV head, key tile).  It holds
//      its K and V tile in shared memory and dK, dV in registers, and
//      walks the H/KV query heads of its GQA group and their query tiles
//      (from the diagonal on when causal), recomputing P and dS per tile.
//   3. a dQ kernel: one block a (batch, head, query tile), walking the
//      key tiles (up to the diagonal when causal).
// No atomics: each output element is summed by one thread in a fixed
// order, so the result is deterministic.  Masked entries (a ragged edge,
// above the causal diagonal) get P = 0 in fp32 score space, as the plain
// version's -1e30 fill gives.  Everything accumulates in fp32, and the
// outputs are written in the inputs' dtype.  Bound on the card:
// operations, five products of 2 d flops per (query, key) pair (S, dP,
// dV, dK, dQ); the kernels do seven (the dQ kernel recomputes S and dP).
//
// bf16 (the training callers' dtype): the tensor cores.  The bound is the
// 10 d flops a pair at 989 TFLOP/s (0.0326 ms for DIT_IMAGE's self
// attention at batch 2; the kernels do 14 d).  Every product is mma.sync
// m16n8k16 (bf16 operands, fp32 accumulators); no wgmma, TMA or
// multi-stage ring yet.
//   * Tiles stay bf16 in shared memory: rows of d + 8 elements (an odd
//     number of 16-byte units, so the 8 rows one ldmatrix phase reads
//     fall in distinct banks), staged by 16-byte cp.async (one stage)
//     with the ragged rows zero-filled.  Operands go to registers by
//     ldmatrix; one read along the other axis (dO and Q for dV and dK, K
//     for dQ) by ldmatrix.trans.
//   * dK/dV: 4 warps; a warp owns 16 keys and computes S^T = K Q^T and
//     dP^T = V dO^T for them directly, so P^T and dS^T come out in the
//     accumulator layout, which is the A-fragment layout of the next
//     product: they are rounded to bf16x2 in registers and feed dV += P^T
//     dO and dK += dS^T Q without a trip through shared memory.  dK and
//     dV of 16 keys x d columns are d fp32 registers a thread; at d = 256
//     two warps share 16 keys (each computes S^T and dP^T) and split the
//     columns.  Keys a block BK = 64 (32 at d = 256); queries a step
//     BQ = 64 at d <= 64, else 32 (registers: 16 at d = 128 fits 3 blocks
//     an SM but was slower, the per-step barriers and staging doubled).
//     The mask is applied only on a step that crosses a ragged edge or
//     the causal diagonal.
//   * dQ: 4 warps of 16 queries, 64 queries a block; S = Q K^T and
//     dP = dO V^T, then dS as the A fragment of dQ += dS K.  Each row's
//     lse and D stay in registers.  Keys a step 64 (32 at d = 256).
//   * Rounding: P and dS are rounded to bf16 before the dV, dK and dQ
//     products, as FlashAttention-2 does; dS is formed from the fp32 P.
//     S and dP are exact products of the bf16 operands summed in fp32.
//   * Occupancy (128 threads a block): dK/dV (2 BK + 2 BQ) (d + 8) bf16
//     + 2 BQ fp32 of shared memory, 36.5 KiB at d = 64 and 51.25 KiB at
//     d = 128; dQ (128 + 2 BK2) (d + 8) bf16, 36 and 68 KiB.  Registers
//     bound it: the launch bounds hold dK/dV at d <= 64 and dQ at
//     d <= 128 to 168 a thread, 3 blocks an SM (spilling 96 bytes at
//     dK/dV d = 64, 48 and 12 at dQ d = 112 and 128); dK/dV at d = 128
//     takes 240, 2 blocks.
//   * Order: a causal dK/dV grid already starts with its heaviest key
//     tiles (blockIdx.x = 0 walks every query tile); reversing the dQ
//     grid's order for causal did not change its time.
//   * A warp whose keys all lie above the causal diagonal of a query step
//     (dK/dV), or whose queries all lie below it (dQ), skips the step's
//     products.
//
// fp32: the CUDA-core kernels, unchanged (their 1e-5 budget would
// need split-TF32 on the tensor cores).  256 threads as a 16 x 16 grid; a
// BT x BT score tile (BT = 64, 32 at d = 256) gives each thread RT x RT
// entries (rows ty + 16a, columns tx + 16t) and a BT x d output tile
// RT x d/16 entries (columns tx + 16u).  Shared rows are fp32 with an odd
// pitch (d + 1, BT + 1), so the 16 rows one load instruction reads fall
// in 16 distinct banks and the other operand is a broadcast.  Shared
// memory: 4 BT x (d + 1) tiles and 2 BT x (BT + 1) tiles, 100 KB at
// d = 64 (2 blocks an SM), 166 KB at d = 128 (one).
#include "common.cuh"

namespace gfdit {

constexpr int kBwdThreads = 256;
constexpr float kBwdLog2e = 1.4426950408889634f;

template <int D>
struct BwdShape {
  static constexpr int BT = D <= 128 ? 64 : 32;  // queries (= keys) a tile
  static constexpr int RT = BT / 16;             // tile rows a thread
  static constexpr int CT = D / 16;              // head-dim columns a thread
  static constexpr int PD = D + 1;               // shared pitch of a d row
  static constexpr int PT = BT + 1;              // shared pitch of a BT row
  static_assert(D % 16 == 0, "attention_bwd: head dim a multiple of 16");
  // K, V, Q and dO tiles; P and dS; lse and D of the query tile
  static constexpr size_t kSmem =
      sizeof(float) * (4 * BT * PD + 2 * BT * PT + 2 * BT);
};

// D[b, h, i] = sum_c dO[b, i, h, c] * O[b, i, h, c]: one warp a row of
// the (B, Sq, H, d) layout, row r = (b * Sq + i) * H + h.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, int rows, int Sq, int H,
                          int D) {
  const int row = (blockIdx.x * kBwdThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                 // whole warps leave together
  const long long base = static_cast<long long>(row) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(to_float(o[base + c]), to_float(dout[base + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % H, bi = row / H;
    delta[(static_cast<long long>(bi / Sq) * H + h) * Sq + bi % Sq] = s;
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernels
// ---------------------------------------------------------------------------

// Rows [r0, r0 + BT) of head `head` of a (B, S, NH, D) tensor into a
// BT x (D + 1) fp32 shared tile; rows past S are zero.
template <int D, int BT>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int r0, int S, int NH,
                                          int head) {
  constexpr int PD = D + 1;
  for (int idx = threadIdx.x; idx < BT * D; idx += kBwdThreads) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    dst[r * PD + c] =
        row < S ? src[((static_cast<long long>(b) * S + row) * NH + head) *
                          D + c]
                : 0.f;
  }
}

// lse and D of the query tile at q0 (0 past Sq; those rows are masked).
template <int BT>
__device__ __forceinline__ void load_row_stats(float* Ls, float* Ds,
                                               const float* lse_h,
                                               const float* delta_h, int q0,
                                               int Sq) {
  for (int r = threadIdx.x; r < BT; r += kBwdThreads) {
    const bool ok = q0 + r < Sq;
    Ls[r] = ok ? lse_h[q0 + r] : 0.f;
    Ds[r] = ok ? delta_h[q0 + r] : 0.f;
  }
}

// For the thread's RT x RT entries of the (q0, k0) tile pair: S = Q K^T
// and dP = dO V^T over the head dim, then P = exp(S scale - lse) (0 where
// masked) and dS = P (dP - D), stored to shared Ps (when WRITE_P) and dSs.
template <int D, int BT, bool WRITE_P>
__device__ __forceinline__ void probs_and_dscores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ls, const float* Ds, float* Ps, float* dSs, int q0, int k0,
    int Sq, int Sk, float scale_log2, int causal) {
  constexpr int RT = BT / 16, PD = D + 1, PT = BT + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RT][RT], dp[RT][RT];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int t = 0; t < RT; ++t) s[a][t] = dp[a][t] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float qa[RT], oa[RT], kb[RT], vb[RT];
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      qa[a] = Qs[(ty + 16 * a) * PD + kk];
      oa[a] = dOs[(ty + 16 * a) * PD + kk];
      kb[a] = Ks[(tx + 16 * a) * PD + kk];
      vb[a] = Vs[(tx + 16 * a) * PD + kk];
    }
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        s[a][t] = fmaf(qa[a], kb[t], s[a][t]);
        dp[a][t] = fmaf(oa[a], vb[t], dp[a][t]);
      }
  }
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const int r = ty + 16 * a, i = q0 + r;
    const float lse2 = Ls[r] * kBwdLog2e, dd = Ds[r];
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int c = tx + 16 * t, j = k0 + c;
      const bool ok = i < Sq && j < Sk && !(causal && j > i);
      const float p = ok ? exp2f(fmaf(s[a][t], scale_log2, -lse2)) : 0.f;
      if (WRITE_P) Ps[r * PT + c] = p;
      dSs[r * PT + c] = p * (dp[a][t] - dd);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_dkdv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Sq, int Sk, int H, int KV, float scale,
                         int causal) {
  using S = BwdShape<D>;
  constexpr int BT = S::BT, RT = S::RT, CT = S::CT, PD = S::PD, PT = S::PT;
  extern __shared__ __align__(16) float bwd_smem[];
  float* Ks = bwd_smem;
  float* Vs = Ks + BT * PD;
  float* Qs = Vs + BT * PD;
  float* dOs = Qs + BT * PD;
  float* Ps = dOs + BT * PD;
  float* dSs = Ps + BT * PT;
  float* Ls = dSs + BT * PT;
  float* Ds = Ls + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BT;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV, group = H / KV;
  const float scale_log2 = scale * kBwdLog2e;
  load_rows<D, BT>(Ks, k, b, k0, Sk, KV, kvh);
  load_rows<D, BT>(Vs, v, b, k0, Sk, KV, kvh);

  float dka[RT][CT], dva[RT][CT];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int u = 0; u < CT; ++u) dka[a][u] = dva[a][u] = 0.f;

  // causal (Sq = Sk): query tiles before this key tile see none of its keys
  const int qstart = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
    for (int q0 = qstart; q0 < Sq; q0 += BT) {
      __syncthreads();       // the last tile's readers are done
      load_rows<D, BT>(Qs, q, b, q0, Sq, H, h);
      load_rows<D, BT>(dOs, dout, b, q0, Sq, H, h);
      load_row_stats<BT>(Ls, Ds, lse + row0, delta + row0, q0, Sq);
      __syncthreads();
      probs_and_dscores<D, BT, true>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0,
                                     k0, Sq, Sk, scale_log2, causal);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        float pj[RT], dsj[RT], oc[CT], qc[CT];
#pragma unroll
        for (int a = 0; a < RT; ++a) {
          pj[a] = Ps[i * PT + ty + 16 * a];
          dsj[a] = dSs[i * PT + ty + 16 * a];
        }
#pragma unroll
        for (int u = 0; u < CT; ++u) {
          oc[u] = dOs[i * PD + tx + 16 * u];
          qc[u] = Qs[i * PD + tx + 16 * u];
        }
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int u = 0; u < CT; ++u) {
            dva[a][u] = fmaf(pj[a], oc[u], dva[a][u]);
            dka[a][u] = fmaf(dsj[a], qc[u], dka[a][u]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= Sk) continue;
    const long long base =
        ((static_cast<long long>(b) * Sk + j) * KV + kvh) * D;
#pragma unroll
    for (int u = 0; u < CT; ++u) {
      dk[base + tx + 16 * u] = dka[a][u] * scale;
      dv[base + tx + 16 * u] = dva[a][u];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_dq_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq, int Sq, int Sk, int H, int KV,
                       float scale, int causal) {
  using S = BwdShape<D>;
  constexpr int BT = S::BT, RT = S::RT, CT = S::CT, PD = S::PD, PT = S::PT;
  extern __shared__ __align__(16) float bwd_smem[];
  float* Ks = bwd_smem;
  float* Vs = Ks + BT * PD;
  float* Qs = Vs + BT * PD;
  float* dOs = Qs + BT * PD;
  float* dSs = dOs + BT * PD + BT * PT;   // the dK/dV kernel's layout
  float* Ls = dSs + BT * PT;
  float* Ds = Ls + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BT;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const float scale_log2 = scale * kBwdLog2e;
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
  load_rows<D, BT>(Qs, q, b, q0, Sq, H, h);
  load_rows<D, BT>(dOs, dout, b, q0, Sq, H, h);
  load_row_stats<BT>(Ls, Ds, lse + row0, delta + row0, q0, Sq);

  float dqa[RT][CT];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int u = 0; u < CT; ++u) dqa[a][u] = 0.f;

  // causal (Sq = Sk): keys past this tile's last query are never seen
  const int kend = causal ? min(Sk, q0 + BT) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();         // the last tile's readers are done
    load_rows<D, BT>(Ks, k, b, k0, Sk, KV, kvh);
    load_rows<D, BT>(Vs, v, b, k0, Sk, KV, kvh);
    __syncthreads();
    probs_and_dscores<D, BT, false>(Qs, dOs, Ks, Vs, Ls, Ds, nullptr, dSs,
                                    q0, k0, Sq, Sk, scale_log2, causal);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float dsa[RT], kc[CT];
#pragma unroll
      for (int a = 0; a < RT; ++a) dsa[a] = dSs[(ty + 16 * a) * PT + j];
#pragma unroll
      for (int u = 0; u < CT; ++u) kc[u] = Ks[j * PD + tx + 16 * u];
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int u = 0; u < CT; ++u)
          dqa[a][u] = fmaf(dsa[a], kc[u], dqa[a][u]);
    }
  }
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
    const long long base = ((static_cast<long long>(b) * Sq + i) * H + h) * D;
#pragma unroll
    for (int u = 0; u < CT; ++u)
      dq[base + tx + 16 * u] = dqa[a][u] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
struct BwdMmaShape {
  static constexpr int CS = D > 128 ? 2 : 1;       // warps sharing 16 keys
  static constexpr int BK = 16 * kMmaWarps / CS;   // keys a dK/dV block
  static constexpr int BQ = D <= 64 ? 64 : 32;     // queries a dK/dV step
  static constexpr int BQ2 = 16 * kMmaWarps;       // queries a dQ block
  static constexpr int BK2 = D <= 128 ? 64 : 32;   // keys a dQ step
  static constexpr int P = D + 8;                  // shared pitch, bf16
  // resident blocks an SM the launch bounds hold the registers to
  static constexpr int kDkdvBlocks = D <= 64 ? 3 : 1;
  static constexpr int kDqBlocks = D <= 128 ? 3 : 1;
  static_assert(D % 16 == 0 && (D / CS) % 16 == 0,
                "attention_bwd: head dim a multiple of 16");
  // K, V tiles, Q and dO tiles, lse * log2(e) and D of the query step
  static constexpr size_t kSmemDkdv =
      sizeof(bf16) * (2 * BK + 2 * BQ) * P + sizeof(float) * 2 * BQ;
  // Q and dO tiles, K and V tiles
  static constexpr size_t kSmemDq = sizeof(bf16) * (2 * BQ2 + 2 * BK2) * P;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices, thread i giving the address of row i % 8 of
// matrix i / 8; register j gets matrix j's (row lane/4, columns
// 2 (lane%4), +1), or with .trans its (rows 2 (lane%4), +1, column lane/4).
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
// Fragments, g = lane / 4, t = lane % 4: a {(g, 2t..), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..)}; b {(k 2t.., n g), (k 2t+8.., n g)};
// c {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8 NT) += A B^T over K = 16 KS: A's 16 rows at `a` and B's
// 8 NT rows at `b`, both row-major bf16 in shared memory at pitch P
// (B read as the col operand, untransposed).
template <int NT, int KS, int P>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a,
                                        const bf16* b, int lane) {
  static_assert(NT % 2 == 0, "mma_abt: n tiles in pairs");
  const bf16* pa = a + (lane & 15) * P + (lane >> 4) * 8;
  const bf16* pb = b + ((lane & 7) + ((lane >> 4) << 3)) * P +
                   ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    unsigned af[4];
    ldsm4(af, pa + ks * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned bfr[4];
      ldsm4(bfr, pb + np * 16 * P + ks * 16);
      mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc (16 x 8 NT) += A B over K = 16 KS: A in registers as KS fragments,
// B's 16 KS rows (k) of 8 NT columns (n) at `b`, row-major bf16 in
// shared memory at pitch P (read by ldmatrix.trans).
template <int NT, int KS, int P>
__device__ __forceinline__ void mma_ab(float (&acc)[NT][4],
                                       const unsigned (&a)[KS][4],
                                       const bf16* b, int lane) {
  static_assert(NT % 2 == 0, "mma_ab: n tiles in pairs");
  const bf16* pb = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * P +
                   (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned bfr[4];
      ldsm4_t(bfr, pb + ks * 16 * P + np * 16);
      mma_bf16(acc[2 * np], a[ks], bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], a[ks], bfr[2], bfr[3]);
    }
}

// The accumulators of 16 x 8 NT, rounded to bf16, as the A fragments of
// a product over K = 8 NT: tiles 2m and 2m + 1 make k step m.
template <int NT>
__device__ __forceinline__ void to_a_frags(unsigned (&a)[NT / 2][4],
                                           const float (&c)[NT][4]) {
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
    a[m][0] = bf16x2_bits(c[2 * m][0], c[2 * m][1]);
    a[m][1] = bf16x2_bits(c[2 * m][2], c[2 * m][3]);
    a[m][2] = bf16x2_bits(c[2 * m + 1][0], c[2 * m + 1][1]);
    a[m][3] = bf16x2_bits(c[2 * m + 1][2], c[2 * m + 1][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Rows [r0, r0 + ROWS) of head `head` of a (B, S, NH, D) bf16 tensor
// into a ROWS x P shared tile by 16-byte cp.async; rows past S are
// zero-filled.  The caller commits and waits.
template <int D, int ROWS, int P>
__device__ __forceinline__ void stage_rows(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int b, int r0, int S, int NH,
                                           int head) {
  constexpr int CPR = D / 8;             // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * CPR; c += kMmaThreads) {
    const int r = c / CPR, col = c % CPR, row = r0 + r;
    const bf16* from = src + ((static_cast<long long>(b) * S +
                               min(row, S - 1)) * NH + head) * D + col * 8;
    cp_async16(dst + r * P + col * 8, from, row < S);
  }
}

// Stores a 16 x 8 NT fp32 accumulator (times `mul`) as bf16 rows
// [r0, r0 + 16) of column block c0 of head `head` of a (B, S, NH, D)
// tensor; rows past S are dropped.
template <int D, int NT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&c)[NT][4], float mul,
                                           int b, int r0, int S, int NH,
                                           int head, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= S) continue;
    bf16* out = dst + ((static_cast<long long>(b) * S + row) * NH + head) *
                          D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<unsigned*>(out + 8 * n) =
          bf16x2_bits(c[n][2 * half] * mul, c[n][2 * half + 1] * mul);
  }
}

// In place on the accumulators of S^T and dP^T (the warp's 16 keys from
// jw x 8 NQ queries from q0): P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - D).  Ls (lse * log2(e)) and Ds by query in shared
// memory.  MASK (a step on a ragged edge or across the causal diagonal):
// P = 0 past Sq, past Sk and above the diagonal.
template <int NQ, bool MASK>
__device__ __forceinline__ void dkdv_probs(float (&st)[NQ][4],
                                           float (&dpt)[NQ][4],
                                           const float* Ls, const float* Ds,
                                           int q0, int jw, int Sq, int Sk,
                                           int causal, float scale_log2,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int c = 8 * n + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
    const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(fmaf(st[n][e], scale_log2, (e & 1) ? -l2.y : -l2.x));
      if (MASK) {
        const int i = q0 + c + (e & 1), j = jw + g + 8 * (e >> 1);
        if (!(i < Sq && j < Sk && !(causal && j > i))) p = 0.f;
      }
      st[n][e] = p;
      dpt[n][e] = p * (dpt[n][e] - ((e & 1) ? d2.y : d2.x));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads,
                                  BwdMmaShape<D>::kDkdvBlocks)
    attn_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int Sq, int Sk, int H, int KV, float scale,
                             int causal) {
  using S = BwdMmaShape<D>;
  constexpr int BK = S::BK, BQ = S::BQ, P = S::P, DC = D / S::CS;
  constexpr int NQ = BQ / 8;             // n tiles of S^T: queries
  constexpr int ND = DC / 8;             // n tiles of the warp's dK, dV
  extern __shared__ __align__(16) unsigned char bwd_mma_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_mma_smem);
  bf16* Vs = Ks + BK * P;
  bf16* Qs = Vs + BK * P;
  bf16* dOs = Qs + BQ * P;
  float* Ls = reinterpret_cast<float*>(dOs + BQ * P);   // lse * log2(e)
  float* Ds = Ls + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = 16 * (warp / S::CS);    // the warp's keys in the tile
  const int c0 = DC * (warp % S::CS);    // and its dK, dV columns
  const int k0 = blockIdx.x * BK, jw = k0 + kw;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV, group = H / KV;
  const float scale_log2 = scale * kBwdLog2e;
  stage_rows<D, BK, P>(Ks, k, b, k0, Sk, KV, kvh);
  stage_rows<D, BK, P>(Vs, v, b, k0, Sk, KV, kvh);
  cp_async_commit();                     // waited for with the first step

  float dka[ND][4], dva[ND][4];
  zero(dka);
  zero(dva);
  // causal (Sq = Sk): queries before this key tile see none of its keys
  const int qstart = causal ? k0 : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
    for (int q0 = qstart; q0 < Sq; q0 += BQ) {
      __syncthreads();                   // the last step's readers are done
      stage_rows<D, BQ, P>(Qs, q, b, q0, Sq, H, h);
      stage_rows<D, BQ, P>(dOs, dout, b, q0, Sq, H, h);
      cp_async_commit();
      for (int r = threadIdx.x; r < BQ; r += kMmaThreads) {
        const bool ok = q0 + r < Sq;     // rows past Sq are masked
        Ls[r] = ok ? lse[row0 + q0 + r] * kBwdLog2e : 0.f;
        Ds[r] = ok ? delta[row0 + q0 + r] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      // no key of the warp is seen: all above the diagonal, or past Sk
      if ((causal && q0 + BQ <= jw) || jw >= Sk) continue;
      float st[NQ][4], dpt[NQ][4];       // S^T and dP^T: keys x queries
      zero(st);
      zero(dpt);
      mma_abt<NQ, D / 16, P>(st, Ks + kw * P, Qs, lane);
      mma_abt<NQ, D / 16, P>(dpt, Vs + kw * P, dOs, lane);
      // every (query, key) of the step is seen: no ragged edge, and the
      // warp's last key is at or below the step's first query
      if (q0 + BQ <= Sq && jw + 16 <= Sk && !(causal && jw + 15 > q0))
        dkdv_probs<NQ, false>(st, dpt, Ls, Ds, q0, jw, Sq, Sk, causal,
                              scale_log2, lane);
      else
        dkdv_probs<NQ, true>(st, dpt, Ls, Ds, q0, jw, Sq, Sk, causal,
                             scale_log2, lane);
      unsigned pa[NQ / 2][4], dsa[NQ / 2][4];
      to_a_frags<NQ>(pa, st);
      to_a_frags<NQ>(dsa, dpt);
      mma_ab<ND, NQ / 2, P>(dva, pa, dOs + c0, lane);    // dV += P^T dO
      mma_ab<ND, NQ / 2, P>(dka, dsa, Qs + c0, lane);    // dK += dS^T Q
    }
  }
  store_rows<D, ND>(dk, dka, scale, b, jw, Sk, KV, kvh, c0, lane);
  store_rows<D, ND>(dv, dva, 1.f, b, jw, Sk, KV, kvh, c0, lane);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, BwdMmaShape<D>::kDqBlocks)
    attn_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int Sq, int Sk, int H,
                           int KV, float scale, int causal) {
  using S = BwdMmaShape<D>;
  constexpr int BQ = S::BQ2, BK = S::BK2, P = S::P;
  constexpr int NK = BK / 8;             // n tiles of S: keys
  constexpr int ND = D / 8;              // n tiles of dQ
  extern __shared__ __align__(16) unsigned char bwd_mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bwd_mma_smem);
  bf16* dOs = Qs + BQ * P;
  bf16* Ks = dOs + BQ * P;
  bf16* Vs = Ks + BK * P;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, iw = q0 + 16 * warp;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const float scale_log2 = scale * kBwdLog2e;
  stage_rows<D, BQ, P>(Qs, q, b, q0, Sq, H, h);
  stage_rows<D, BQ, P>(dOs, dout, b, q0, Sq, H, h);
  cp_async_commit();                     // waited for with the first step
  // the thread's rows iw + g and iw + g + 8: lse * log2(e) and D
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
  float lse2[2], dd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = iw + g + 8 * half;
    lse2[half] = i < Sq ? lse[row0 + i] * kBwdLog2e : 0.f;
    dd[half] = i < Sq ? delta[row0 + i] : 0.f;
  }

  float dqa[ND][4];
  zero(dqa);
  // causal (Sq = Sk): keys past this tile's last query are never seen
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                     // the last step's readers are done
    stage_rows<D, BK, P>(Ks, k, b, k0, Sk, KV, kvh);
    stage_rows<D, BK, P>(Vs, v, b, k0, Sk, KV, kvh);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // no query of the warp sees a key: all below the diagonal, or past Sq
    if ((causal && k0 > iw + 15) || iw >= Sq) continue;
    float s[NK][4], dp[NK][4];           // S and dP: queries x keys
    zero(s);
    zero(dp);
    mma_abt<NK, D / 16, P>(s, Qs + 16 * warp * P, Ks, lane);
    mma_abt<NK, D / 16, P>(dp, dOs + 16 * warp * P, Vs, lane);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, i = iw + g + 8 * half;
        const int j = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok = i < Sq && j < Sk && !(causal && j > i);
        const float p =
            ok ? exp2f(fmaf(s[n][e], scale_log2, -lse2[half])) : 0.f;
        dp[n][e] = p * (dp[n][e] - dd[half]);
      }
    unsigned dsa[NK / 2][4];
    to_a_frags<NK>(dsa, dp);
    mma_ab<ND, NK / 2, P>(dqa, dsa, Ks, lane);           // dQ += dS K
  }
  store_rows<D, ND>(dq, dqa, scale, b, iw, Sq, H, h, 0, lane);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int rows, int Sq, int H, int D,
                         cudaStream_t stream) {
  attn_bwd_delta_kernel<T><<<(rows + kBwdThreads / 32 - 1) /
                                 (kBwdThreads / 32),
                             kBwdThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, Sq,
      H, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_attn_bwd_fp32(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const float* lse, void* dq, void* dk,
                                 void* dv, float* delta, int B, int Sq,
                                 int Sk, int H, int KV, float sm_scale,
                                 int causal, int device,
                                 cudaStream_t stream) {
  using S = BwdShape<D>;
  cudaError_t err = allow_smem_once<attn_bwd_dkdv_kernel<D>>(S::kSmem, device);
  if (err != cudaSuccess) return err;
  err = allow_smem_once<attn_bwd_dq_kernel<D>>(S::kSmem, device);
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  if ((err = launch_delta<float>(o, dout, delta, B * Sq * H, Sq, H, D,
                                 stream)) != cudaSuccess)
    return err;
  attn_bwd_dkdv_kernel<D>
      <<<dim3((Sk + S::BT - 1) / S::BT, B * KV), kBwdThreads, S::kSmem,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
                   static_cast<float*>(dv), Sq, Sk, H, KV, sm_scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dq_kernel<D>
      <<<dim3((Sq + S::BT - 1) / S::BT, B * H), kBwdThreads, S::kSmem,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), Sq,
                   Sk, H, KV, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const float* lse, void* dq, void* dk,
                                 void* dv, float* delta, int B, int Sq,
                                 int Sk, int H, int KV, float sm_scale,
                                 int causal, int device,
                                 cudaStream_t stream) {
  using S = BwdMmaShape<D>;
  cudaError_t err =
      allow_smem_once<attn_bwd_dkdv_mma_kernel<D>>(S::kSmemDkdv, device);
  if (err != cudaSuccess) return err;
  err = allow_smem_once<attn_bwd_dq_mma_kernel<D>>(S::kSmemDq, device);
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  if ((err = launch_delta<bf16>(o, dout, delta, B * Sq * H, Sq, H, D,
                                stream)) != cudaSuccess)
    return err;
  attn_bwd_dkdv_mma_kernel<D>
      <<<dim3((Sk + S::BK - 1) / S::BK, B * KV), kMmaThreads, S::kSmemDkdv,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), Sq, Sk, H, KV, sm_scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dq_mma_kernel<D>
      <<<dim3((Sq + S::BQ2 - 1) / S::BQ2, B * H), kMmaThreads, S::kSmemDq,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), Sq,
                   Sk, H, KV, sm_scale, causal);
  return cudaGetLastError();
}

// Resident blocks an SM and dynamic shared bytes of the bf16 dK/dV
// (which = 0) or dQ (which = 1) kernel at head dim D.
template <int D>
cudaError_t occupancy_attn_bwd(int which, int device, int* blocks,
                               int* smem) {
  using S = BwdMmaShape<D>;
  if (which == 0) {
    *smem = static_cast<int>(S::kSmemDkdv);
    const cudaError_t err =
        allow_smem_once<attn_bwd_dkdv_mma_kernel<D>>(S::kSmemDkdv, device);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, attn_bwd_dkdv_mma_kernel<D>, kMmaThreads, S::kSmemDkdv);
  }
  *smem = static_cast<int>(S::kSmemDq);
  const cudaError_t err =
      allow_smem_once<attn_bwd_dq_mma_kernel<D>>(S::kSmemDq, device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_bwd_dq_mma_kernel<D>, kMmaThreads, S::kSmemDq);
}

}  // namespace gfdit

#define GFDIT_BWD_HEAD_DIMS(X) X(16) X(32) X(64) X(112) X(128) X(256)

// q/o/dout/dq: (B, Sq, H, D); k/v/dk/dv: (B, Sk, KV, D), all contiguous
// and of one dtype (bf16 ones 16-byte aligned); lse and the scratch
// delta: (B, H, Sq) fp32.
extern "C" int gfdit_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   void* dq, void* dk, void* dv, float* delta,
                                   int B, int Sq, int Sk, int H, int KV, int D,
                                   int causal, float sm_scale, int dtype,
                                   int device, void* stream) {
  using namespace gfdit;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (causal && Sq != Sk) || B * H > 65535 || B * KV > 65535)
    return cudaErrorInvalidValue;
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GFDIT_ATTN_BWD(DIM)                                                  \
  case DIM:                                                                  \
    return dtype == kFloat32                                                 \
               ? launch_attn_bwd_fp32<DIM>(q, k, v, o, dout, lse, dq, dk, dv, \
                                           delta, B, Sq, Sk, H, KV, sm_scale, \
                                           causal, device, s)                 \
               : launch_attn_bwd_bf16<DIM>(q, k, v, o, dout, lse, dq, dk, dv, \
                                           delta, B, Sq, Sk, H, KV, sm_scale, \
                                           causal, device, s);
  switch (D) {
    GFDIT_BWD_HEAD_DIMS(GFDIT_ATTN_BWD)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ATTN_BWD
}

// Resident blocks an SM and dynamic shared-memory bytes of the bf16
// (tensor-core) dK/dV (which = 0) or dQ (which = 1) backward kernel at
// head dim D, from the CUDA occupancy calculator.
extern "C" int gfdit_attention_bwd_occupancy(int D, int which, int device,
                                             int* blocks, int* smem) {
  using namespace gfdit;
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
#define GFDIT_BWD_OCC(DIM) \
  case DIM:                \
    return occupancy_attn_bwd<DIM>(which, device, blocks, smem);
  switch (D) {
    GFDIT_BWD_HEAD_DIMS(GFDIT_BWD_OCC)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_BWD_OCC
}
