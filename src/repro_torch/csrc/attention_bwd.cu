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
//   2. attn_bwd_dkdv_mma_kernel: one block a (batch, KV head, key tile).
//      It holds its K and V tile in shared memory and dK, dV in
//      registers, and walks the H/KV query heads of its GQA group and
//      their query tiles (from the diagonal on when causal), recomputing
//      P and dS per tile.
//   3. attn_bwd_dq_mma_kernel: one block a (batch, head, query tile),
//      walking the key tiles (up to the diagonal when causal).
// No atomics: each output element is summed by one thread in a fixed
// order, so the result is deterministic.  Masked entries (a ragged edge,
// above the causal diagonal) get P = 0 in fp32 score space, as the plain
// version's -1e30 fill gives.  Everything accumulates in fp32, and the
// outputs are written in the inputs' dtype.  Bound on the card:
// operations, five products of 2 d flops per (query, key) pair (S, dP,
// dV, dK, dQ); the kernels do seven (the dQ kernel recomputes S and dP).
//
// Both dtypes run the same two kernel templates on the tensor cores:
// mma.sync with fp32 accumulators; no wgmma, TMA or multi-stage ring yet.
//   * bf16 (the training callers' dtype): every product is m16n8k16 on
//     bf16 operands.  Bound: 10 d flops a pair at 989 TFLOP/s (0.0326 ms
//     for DIT_IMAGE's self attention at batch 2; the kernels do 14 d).
//     P and dS are rounded to bf16 before the dV, dK and dQ products, as
//     FlashAttention-2 does; dS is formed from the fp32 P.  S and dP are
//     exact products of the bf16 operands summed in fp32.
//   * fp32 (every gradient check, and any float32 caller; budget 1e-5
//     rel-L2, where one TF32 product keeps ~5e-4): split-TF32.  Each fp32
//     operand x splits in registers, after its fragment load, into
//     hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest, and
//     each product is three m16n8k8 TF32 ones, a_lo b_hi, a_hi b_lo, then
//     a_hi b_hi (the small terms first, as CUTLASS's 3xTF32; a_lo b_lo,
//     ~2^-22 of the product, is dropped).  P and dS stay fp32 and split
//     the same way.  The sums over the sequence (dV, dK, dQ) go from the
//     tensor cores to the CUDA cores every kSumSteps k steps (see
//     mma_ab).  Bound: 3 x 10 d flops a pair at 494.7 TFLOP/s dense TF32
//     (0.195 ms for DIT_IMAGE's self attention; the 10 d on the CUDA
//     cores at 67 TFLOP/s would take 0.481).  A split is four integer or
//     fp32 operations, and each fp32 product (three mma) needs 2.5 to
//     2.75 of them at d = 64 and 128: every warp splits the shared Q/dO
//     (dK/dV) or K/V (dQ) fragments again, so the splits' operations
//     outnumber the mma about 3.5 to 1.
//   * Tiles stay in the inputs' dtype in shared memory, in rows of d plus
//     one 16-byte unit (d + 8 bf16, d + 4 fp32: the 8 rows one ldmatrix
//     phase reads fall in distinct banks), staged by 16-byte cp.async
//     (one stage) with the ragged rows zero-filled.  Operands along d go
//     to registers by ldmatrix, which on fp32 rows gives exactly the TF32
//     fragment (lane: row lane/4, word lane%4).  Reads along the other
//     axis (dO and Q for dV and dK, K for dQ): bf16 by ldmatrix.trans;
//     fp32 by 32-bit loads, since .trans moves 16-bit elements (see
//     mma_ab: with pitch d + 4 = 4 (mod 16) words they are conflict-free
//     too, so one pitch serves both reads).
//   * dK/dV: 4 warps; a warp owns 16 keys and computes S^T = K Q^T and
//     dP^T = V dO^T for them directly, so P^T and dS^T come out in the
//     accumulator layout and feed dV += P^T dO and dK += dS^T Q from
//     registers without a trip through shared memory: in bf16 two
//     accumulator tiles are one A fragment; in TF32 one tile is one,
//     its columns permuted (see mma_ab).  dK and dV of 16 keys x d
//     columns are d fp32 registers a thread; at d = 256 two warps share
//     16 keys (each computes S^T and dP^T) and split the columns (in
//     fp32 at d = 128 too it was slower: 1.5 times the products for 3
//     blocks an SM).  Keys a block BK = 64 (32 at d = 256); queries a
//     step BQ = 64 at d <= 64 (fp32: d <= 32), else 32 (bf16: 16 at
//     d = 128 fits 3 blocks an SM but was slower, the per-step barriers
//     and staging doubled; fp32 at d = 64: 32 holds 3 blocks an SM
//     without the 496-byte spill of 64).  The mask is applied only on a
//     step that crosses a ragged edge or the causal diagonal.
//   * dQ: 4 warps of 16 queries, 64 queries a block; S = Q K^T and
//     dP = dO V^T, then dS as the A fragment of dQ += dS K.  Each row's
//     lse and D stay in registers.  Keys a step 64; 32 at d = 256, and
//     in fp32 at d >= 112 (shared memory: 99 KiB at d = 128 for 2 blocks
//     an SM, where 64 keys would take 132 KiB and allow one).
//   * Occupancy (128 threads a block): dK/dV (2 BK + 2 BQ) P elements +
//     2 BQ fp32 of shared memory: bf16 36.5 KiB at d = 64 and 51.25 KiB
//     at d = 128, fp32 51.25 and 99.25 KiB; dQ (128 + 2 BK2) P: bf16 36
//     and 68 KiB, fp32 68 and 99 KiB.  The launch bounds hold dK/dV at
//     d <= 64 and dQ at d <= 64 (bf16: d <= 128) to 168 registers a
//     thread, 3 blocks an SM; at d = 112 and 128 the rest take up to 240
//     (bf16) or 255 (fp32), 2 blocks.  (ptxas's counts for every
//     instantiation: chip_smoke.py's build phase and PERF.md section 6.)
//   * Order: a causal dK/dV grid already starts with its heaviest key
//     tiles (blockIdx.x = 0 walks every query tile); reversing the dQ
//     grid's order for causal did not change its time.
//   * A warp whose keys all lie above the causal diagonal of a query step
//     (dK/dV), or whose queries all lie below it (dQ), skips the step's
//     products.
#include "mma.cuh"

#include <type_traits>

namespace gfdit {

constexpr int kBwdThreads = 256;   // the D kernel's block
constexpr float kBwdLog2e = 1.4426950408889634f;

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
// the tensor-core kernels: bf16 m16n8k16, fp32 as split-TF32 m16n8k8
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

template <typename T, int D>
struct BwdMmaShape {
  static constexpr bool kTf32 = std::is_same_v<T, float>;
  static constexpr int CS = D > 128 ? 2 : 1;       // warps sharing 16 keys
  static constexpr int BK = 16 * kMmaWarps / CS;   // keys a dK/dV block
  static constexpr int BQ = D <= (kTf32 ? 32 : 64) ? 64 : 32;  // dK/dV step
  static constexpr int BQ2 = 16 * kMmaWarps;       // queries a dQ block
  static constexpr int BK2 = D <= (kTf32 ? 64 : 128) ? 64 : 32;  // dQ step
  static constexpr int P = D + 16 / sizeof(T);     // shared pitch, elements
  // resident blocks an SM the launch bounds hold the registers to
  static constexpr int kDkdvBlocks = D <= 64 ? 3 : 1;
  static constexpr int kDqBlocks =
      D <= (kTf32 ? 64 : 128) ? 3 : (kTf32 && D <= 128 ? 2 : 1);
  static_assert(D % 16 == 0 && (D / CS) % 16 == 0,
                "attention_bwd: head dim a multiple of 16");
  // K, V tiles, Q and dO tiles, lse * log2(e) and D of the query step
  static constexpr size_t kSmemDkdv =
      sizeof(T) * (2 * BK + 2 * BQ) * P + sizeof(float) * 2 * BQ;
  // Q and dO tiles, K and V tiles
  static constexpr size_t kSmemDq = sizeof(T) * (2 * BQ2 + 2 * BK2) * P;
};

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Rows [r0, r0 + ROWS) of head `head` of a (B, S, NH, D) tensor into a
// ROWS x P shared tile by 16-byte cp.async; rows past S are zero-filled.
// The caller commits and waits.
template <int D, int ROWS, int P, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int b, int r0, int S, int NH,
                                           int head) {
  constexpr int E = 16 / sizeof(T), CPR = D / E;   // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * CPR; c += kMmaThreads) {
    const int r = c / CPR, col = c % CPR, row = r0 + r;
    const T* from = src + ((static_cast<long long>(b) * S +
                            min(row, S - 1)) * NH + head) * D + col * E;
    cp_async16(dst + r * P + col * E, from, row < S);
  }
}

// Stores a 16 x 8 NT fp32 accumulator (times `mul`) as rows [r0, r0 + 16)
// of column block c0 of head `head` of a (B, S, NH, D) tensor; rows past
// S are dropped.
template <int D, int NT, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float (&c)[NT][4], float mul,
                                           int b, int r0, int S, int NH,
                                           int head, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= S) continue;
    T* out = dst + ((static_cast<long long>(b) * S + row) * NH + head) * D +
             c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float v[2] = {c[n][2 * half] * mul, c[n][2 * half + 1] * mul};
      store_vec<2>(out + 8 * n, v);
    }
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

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads,
                                  BwdMmaShape<T, D>::kDkdvBlocks)
    attn_bwd_dkdv_mma_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int Sq,
                             int Sk, int H, int KV, float scale, int causal) {
  using S = BwdMmaShape<T, D>;
  constexpr int BK = S::BK, BQ = S::BQ, P = S::P, DC = D / S::CS;
  constexpr int NQ = BQ / 8;             // n tiles of S^T: queries
  constexpr int ND = DC / 8;             // n tiles of the warp's dK, dV
  extern __shared__ __align__(16) unsigned char bwd_mma_smem[];
  T* Ks = reinterpret_cast<T*>(bwd_mma_smem);
  T* Vs = Ks + BK * P;
  T* Qs = Vs + BK * P;
  T* dOs = Qs + BQ * P;
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
      mma_abt<NQ, D, P>(st, Ks + kw * P, Qs, lane);
      mma_abt<NQ, D, P>(dpt, Vs + kw * P, dOs, lane);
      // every (query, key) of the step is seen: no ragged edge, and the
      // warp's last key is at or below the step's first query
      if (q0 + BQ <= Sq && jw + 16 <= Sk && !(causal && jw + 15 > q0))
        dkdv_probs<NQ, false>(st, dpt, Ls, Ds, q0, jw, Sq, Sk, causal,
                              scale_log2, lane);
      else
        dkdv_probs<NQ, true>(st, dpt, Ls, Ds, q0, jw, Sq, Sk, causal,
                             scale_log2, lane);
      if constexpr (S::kTf32) {          // P^T and dS^T stay fp32
        mma_ab<ND, NQ, P>(dva, st, dOs + c0, lane);      // dV += P^T dO
        mma_ab<ND, NQ, P>(dka, dpt, Qs + c0, lane);      // dK += dS^T Q
      } else {
        unsigned pa[NQ / 2][4], dsa[NQ / 2][4];
        to_a_frags<NQ>(pa, st);
        to_a_frags<NQ>(dsa, dpt);
        mma_ab<ND, NQ / 2, P>(dva, pa, dOs + c0, lane);  // dV += P^T dO
        mma_ab<ND, NQ / 2, P>(dka, dsa, Qs + c0, lane);  // dK += dS^T Q
      }
    }
  }
  store_rows<D, ND>(dk, dka, scale, b, jw, Sk, KV, kvh, c0, lane);
  store_rows<D, ND>(dv, dva, 1.f, b, jw, Sk, KV, kvh, c0, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, BwdMmaShape<T, D>::kDqBlocks)
    attn_bwd_dq_mma_kernel(const T* __restrict__ q,
                           const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, int Sq, int Sk, int H, int KV,
                           float scale, int causal) {
  using S = BwdMmaShape<T, D>;
  constexpr int BQ = S::BQ2, BK = S::BK2, P = S::P;
  constexpr int NK = BK / 8;             // n tiles of S: keys
  constexpr int ND = D / 8;              // n tiles of dQ
  extern __shared__ __align__(16) unsigned char bwd_mma_smem[];
  T* Qs = reinterpret_cast<T*>(bwd_mma_smem);
  T* dOs = Qs + BQ * P;
  T* Ks = dOs + BQ * P;
  T* Vs = Ks + BK * P;

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
    mma_abt<NK, D, P>(s, Qs + 16 * warp * P, Ks, lane);
    mma_abt<NK, D, P>(dp, dOs + 16 * warp * P, Vs, lane);
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
    if constexpr (S::kTf32) {            // dS stays fp32
      mma_ab<ND, NK, P>(dqa, dp, Ks, lane);              // dQ += dS K
    } else {
      unsigned dsa[NK / 2][4];
      to_a_frags<NK>(dsa, dp);
      mma_ab<ND, NK / 2, P>(dqa, dsa, Ks, lane);         // dQ += dS K
    }
  }
  store_rows<D, ND>(dq, dqa, scale, b, iw, Sq, H, h, 0, lane);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_attn_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, void* dq, void* dk, void* dv,
                            float* delta, int B, int Sq, int Sk, int H,
                            int KV, float sm_scale, int causal, int device,
                            cudaStream_t stream) {
  using S = BwdMmaShape<T, D>;
  cudaError_t err =
      allow_smem_once<attn_bwd_dkdv_mma_kernel<T, D>>(S::kSmemDkdv, device);
  if (err != cudaSuccess) return err;
  err = allow_smem_once<attn_bwd_dq_mma_kernel<T, D>>(S::kSmemDq, device);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  attn_bwd_delta_kernel<T><<<(B * Sq * H + kBwdThreads / 32 - 1) /
                                 (kBwdThreads / 32),
                             kBwdThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, B * Sq * H, Sq, H, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkdv_mma_kernel<T, D>
      <<<dim3((Sk + S::BK - 1) / S::BK, B * KV), kMmaThreads, S::kSmemDkdv,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                   static_cast<T*>(dv), Sq, Sk, H, KV, sm_scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dq_mma_kernel<T, D>
      <<<dim3((Sq + S::BQ2 - 1) / S::BQ2, B * H), kMmaThreads, S::kSmemDq,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk,
                   H, KV, sm_scale, causal);
  return cudaGetLastError();
}

// Resident blocks an SM and dynamic shared bytes of the dK/dV (which = 0)
// or dQ (which = 1) kernel of element type T at head dim D.
template <typename T, int D>
cudaError_t occupancy_attn_bwd(int which, int device, int* blocks,
                               int* smem) {
  using S = BwdMmaShape<T, D>;
  if (which == 0) {
    *smem = static_cast<int>(S::kSmemDkdv);
    const cudaError_t err =
        allow_smem_once<attn_bwd_dkdv_mma_kernel<T, D>>(S::kSmemDkdv, device);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, attn_bwd_dkdv_mma_kernel<T, D>, kMmaThreads, S::kSmemDkdv);
  }
  *smem = static_cast<int>(S::kSmemDq);
  const cudaError_t err =
      allow_smem_once<attn_bwd_dq_mma_kernel<T, D>>(S::kSmemDq, device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_bwd_dq_mma_kernel<T, D>, kMmaThreads, S::kSmemDq);
}

}  // namespace gfdit

#define GFDIT_BWD_HEAD_DIMS(X) X(16) X(32) X(64) X(112) X(128) X(256)

// q/o/dout/dq: (B, Sq, H, D); k/v/dk/dv: (B, Sk, KV, D), all contiguous
// and of one dtype, q, k, v and dout 16-byte aligned; lse and the
// scratch delta: (B, H, Sq) fp32.
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
               ? launch_attn_bwd<float, DIM>(q, k, v, o, dout, lse, dq, dk,  \
                                             dv, delta, B, Sq, Sk, H, KV,    \
                                             sm_scale, causal, device, s)    \
               : launch_attn_bwd<bf16, DIM>(q, k, v, o, dout, lse, dq, dk,   \
                                            dv, delta, B, Sq, Sk, H, KV,     \
                                            sm_scale, causal, device, s);
  switch (D) {
    GFDIT_BWD_HEAD_DIMS(GFDIT_ATTN_BWD)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ATTN_BWD
}

// Resident blocks an SM and dynamic shared-memory bytes of the dK/dV
// (which = 0) or dQ (which = 1) backward kernel of `dtype` at head dim D,
// from the CUDA occupancy calculator.
extern "C" int gfdit_attention_bwd_occupancy(int D, int dtype, int which,
                                             int device, int* blocks,
                                             int* smem) {
  using namespace gfdit;
  if ((which != 0 && which != 1) || (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
#define GFDIT_BWD_OCC(DIM)                                                 \
  case DIM:                                                                \
    return dtype == kFloat32                                               \
               ? occupancy_attn_bwd<float, DIM>(which, device, blocks, smem) \
               : occupancy_attn_bwd<bf16, DIM>(which, device, blocks, smem);
  switch (D) {
    GFDIT_BWD_HEAD_DIMS(GFDIT_BWD_OCC)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_BWD_OCC
}
