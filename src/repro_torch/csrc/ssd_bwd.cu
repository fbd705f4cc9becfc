// K4's backward: the gradient of the Mamba2 SSD chunked scan (csrc/ssd.cu).
//
// The TPU kernel it differentiates, src/repro/kernels/ssd.py::ssd_scan,
// has no backward: the JAX package trains through its jnp ssd_chunked.
// Per (batch, chunk, head), with xb = x dt, cum the in-chunk cumulative
// sum of dt A, L_ij = exp(cum_i - cum_j) (i >= j), S_in the state entering
// the chunk and G the gradient of the state leaving it (G of the last
// chunk: dstate, or zero), for the output gradient dy:
//   dxb_j = sum_{i>=j} (C_i . B_j) L_ij dy_i + exp(cum_last - cum_j) G B_j
//   dC_i  = sum_h [sum_{j<=i} P_ij B_j + exp(cum_i) S_in^T dy_i]
//   dB_j  = sum_h [sum_{i>=j} P_ij C_i + exp(cum_last - cum_j) G^T xb_j]
// with P_ij = L_ij (dy_i . xb_j); dcum collects every exp's derivative,
// and da, its reverse cumulative sum within the chunk, gives ddt = x . dxb
// + A da and dA = sum_{b, l} dt da (ref.ssd_bwd_ref writes each term
// out).  The G of each chunk needs the chunks after it, so one call runs
// four stage kernels in turn on the caller's stream, as the forward does:
//   1. ssd_bwd_dstate_mma, a block per (batch, chunk > 0, head):
//      Q_c = sum_i exp(cum_i) C_i (x) dy_i, (n x p), into scratch;
//   2. ssd_bwd_state_pass, a block per (batch, head, n-row tile): walks
//      the chunks backwards, G_{nc-1} = dstate^T (or 0), G_{c-1} =
//      exp(cum_last_c) G_c + Q_c, overwriting Q_c with G_c; and the
//      partial dot <S_in, G_c> of its rows for the dcum of cum_last;
//   3. ssd_bwd_chunk_mma, a block per (batch, chunk, head): every product
//      of the chunk (below), dx, ddt (both paths), the head's own dB and
//      dC rows into scratch, and its dA partial;
//   4. ssd_bwd_sum: dB and dC summed over the heads, dA over (batch,
//      chunk), each in a fixed order.
// Deterministic: no atomics anywhere, every sum in a fixed order (the
// remat check holds remat="full" gradients equal to "none"'s bit for bit).
//
// S_in and cum: the forward's scratch is kept when autograd runs (as K2
// keeps its log-sum-exp then; ops._SSD saves it): cum, the chunk states
// that stage 2 overwrote with S_in (chunk 0's slot is not S_in and is
// never read) and C B^T, (j, i) layout, of which only the written tiles
// (j <= i) are read.  That holds b*nc*h*n*p*4 bytes a layer, 67 MB at the
// mamba2-1.3b training shape (b=2, l=2048, h=64, p=64, n=128), 3.2 GB over
// its 48 layers, against ~0.6 GB of other activations a layer; the other
// choice, re-running the forward's stages 1-3 here, costs ~4.5 GFLOP a
// call and would put the forward's kernels in this file too.
//
// Bound on the card.  The function needs, per (batch, chunk) of c rows,
// the causal triangles of the dB and dC products once, c(c+1)/2 n
// multiply-adds each (B and C have one group, so each head's P can be
// summed over the heads first), and per head the triangles of dy . xb and
// of the dxb product, c(c+1)/2 p each, and four c p n products (Q, S_in^T
// dy: none in the first chunk; G B, G^T xb: none in the last without
// dstate): 20.6 GFLOP at the mamba2-1.3b training shape (b=2, l=2048,
// h=64, p=64, n=128, c=128; kernels/cost.py ssd_bwd_flops).  On an H100
// SXM that is 0.125 ms for fp32 operands (three TF32 products for each
// fp32 one at 495 TFLOP/s; 0.307 ms at the 67 TFLOP/s CUDA-core rate),
// against 0.21 GB of operands and gradients (0.063 ms at 3.35 TB/s);
// bf16 operands are bound by their 0.107 GB (0.032 ms), the 989 TFLOP/s
// bf16 rate taking 0.021 ms.
//
// Design.  One kernel set for both dtypes: stages 2 and 4 run on the CUDA
// cores; stages 1 and 3 (ssd_bwd_dstate_mma, ssd_bwd_chunk_mma) are
// templates over the operand type that run every product on the tensor
// cores with one pass structure.  Their products go through mma.cuh's
// helpers (shared with K2's backward, csrc/attention_bwd.cu, and K4's
// forward), each of which takes either dtype:
//   * fp32 (the default intra_dtype of the ssm and hybrid families):
//     split-TF32 mma.sync m16n8k8: each fp32 operand splits in registers
//     into hi = tf32(x) and lo = tf32(x - hi), and each product is three
//     TF32 ones, a_lo b_hi + a_hi b_lo + a_hi b_hi.  One TF32 product
//     keeps ~5e-4 of an operand; the budget is 2e-5 rel-L2 per output
//     (chip_smoke.py), which one TF32 product fails by 5x on dA and 15x
//     on the rest (tests/test_torch_ssd_grads.py, in closed form).
//     Operands go to shared memory as fp32 rows by 16-byte cp.async (rows
//     past l zero-filled); whatever is read as rows of the k axis uses
//     ldmatrix (a row-major fp32 tile is the TF32 fragment: row lane/4,
//     word lane%4) at a pitch of an odd number of 16-byte units; whatever
//     is read along the other axis uses 32-bit loads at a pitch that puts
//     the lanes' rows in distinct banks: P + 8 = 8 (mod 32) words for rows
//     t and t + 4, N + 4 or P + 4 = 4 (mod 16) for rows 2t and 2t + 1.
//   * bf16 (intra_dtype="bfloat16", the JAX package's ssd_bf16 variant):
//     one mma.sync m16n8k16 on bf16 operands where fp32 takes three TF32
//     ones, fp32 accumulators.  Every operand is read by ldmatrix (rows
//     along k) or ldmatrix.trans (the other axis) at a pitch of 8 more
//     elements.  dy and xb = x dt are staged as bf16 (xb rounded once,
//     in place); G and S_in are rounded to bf16 as they are staged (plain
//     loads; the fp32 scratch stays as it is); Q's A operand is C's rows
//     scaled by exp(cum_i) in registers and rounded once; Z, P = L Z and
//     M = (C B^T) L are rounded to bf16 A fragments (to_a_frags) where
//     they enter a product, as K2's bf16 backward rounds P and dS.
// The passes:
//   * Stage 1, a block per (batch, chunk > 0, head), a warp per 16 rows
//     of n (N / 16 warps): Q = (exp(cum) C)^T dy, B = dy; the chunk in
//     strips of 32 rows, double-buffered (the next strip's cp.async in
//     flight during this one's products); fp32 sums each strip's 4 k
//     steps into a fresh accumulator that the CUDA cores add to the sum
//     (kSumSteps, mma.cuh).
//   * Stage 3, a block per (batch, chunk, head) of CH / 16 warps (256
//     threads at chunk 128); warp w owns rows [16w, 16w + 16).  dy and xb
//     stay in shared memory for the whole block.  Three passes, each a
//     product family with its accumulators in registers:
//     1. rows j: Z_ji = xb_j . dy_i (mma_abt) for the tiles i >= j only;
//        M_ij = (C B^T)_ij L_ij is built in the accumulator layout from
//        the forward's C B^T (read only where j <= i: the forward never
//        writes the rest) and the masked decay; T = M Z gives dcum's row
//        sums (quad shuffles) and column sums (shuffles over the 8 row
//        groups, then the warps' partials through shared memory, in warp
//        order); dxb += M^T dy (mma_acc_a: fp32 as two k steps whose
//        accumulator columns 2t, 2t + 1 serve as k slots t, t + 4, dy read
//        as row pairs; bf16 as one A fragment); with G, first dxb =
//        exp(cum_last - cum) (B G), A = B from column tiles of 32.
//     2. rows j: the head's dB = exp(cum_last - cum) (xb G^T) + P^T C, Z
//        recomputed a tile at a time and P^T = L Z built as A; C streamed
//        in strips of 64 rows.
//     3. rows i: the head's dC = exp(cum) (dy S_in^T) + P B, Z^T = dy
//        xb^T recomputed for this orientation; B streamed in strips.
//        dcum's S_in term from C's rows in global memory.
//     The decay is masked to -1e30 BEFORE the exp in every orientation
//     (the upper triangle's cum_i - cum_j reaches ~200 at Mamba2's
//     published dt and A: inf * 0 = NaN).  A 16 x 16 tile wholly above
//     the diagonal is never computed; only the diagonal tiles are masked.
//     The chunk's sums (K at most 128: 16 k steps) stay on the tensor
//     cores.  Then the one-thread reverse cumulative sum.
//   * Executed: 35.4 GFLOP of products at mamba2-1.3b's training shape
//     (106 of TF32 in fp32), 1.72x the 20.6 needed (Z three times, dB and
//     dC a head, the diagonal tiles whole); zamba2-7b's (h = 112, n = 64)
//     39.5 against 21.7 (1.82x).  The same in both dtypes: bf16 runs the
//     fp32 kernels' tiles, a third of their tensor-core instructions.
//   * Shared memory a block, at (64, 128, 128): fp32 110 KiB (dy and xb
//     68 KiB, a 34 KiB tile buffer, 8 KiB of row vectors and column
//     partials), bf16 62 KiB (dy and xb 36 KiB); 103 KiB and 58.5 KiB at
//     (64, 64, 128); the launch bounds hold the registers to 128 a
//     thread, so 2 blocks (16 warps) fit an SM.  ptxas's registers and
//     spills for every instantiation: chip_smoke.py's build phase.
//
// dB and dC are written per head (b*nc*h*c*n floats each, 134 MB at the
// training shape) and summed by stage 4 in head order.  A ragged last
// chunk is masked as in the forward: rows past l load dt = x = B = C = dy
// = 0 and are not written; the padded rows' dcum (cum_last's terms among
// them) reaches the real rows through the reverse cumulative sum over the
// whole chunk.
#include "mma.cuh"

#include <type_traits>

namespace gfdit {

constexpr int kBwdThreads = 256;  // stages 2 and 4
constexpr float kBwdMask = -1e30f;

template <int P, int N, int CH>
struct SsdBwdShape {
  static_assert(P % 16 == 0 && N % 16 == 0 && CH % 16 == 0 && P <= 64 &&
                    N <= 128 && CH <= 128,
                "ssd_bwd: p, n and chunk must be multiples of 16, p at most "
                "64, n and chunk at most 128");
  // stage 2: n-rows of the state a block walks (4 floats a thread), and
  // the blocks (n-tiles) of one (batch, head)
  static constexpr int R2 = N < 4 * kBwdThreads / P ? N : 4 * kBwdThreads / P;
  static constexpr int NT2 = N / R2;
};

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < TN; ++e) acc[i][e] = 0.f;
}

// Stage 2: the reverse pass of state gradients across chunks, in place
// (slot c of g: Q_c in, G_c out); and per chunk c > 0 the partial
// <S_in[c], G_c> over this block's n-rows.
template <int P, int N, int CH>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_state_pass(const float* __restrict__ cum,
                       const float* __restrict__ s_in,
                       const float* __restrict__ dstate,
                       float* __restrict__ g, float* __restrict__ sg, int H,
                       int nc) {
  using S = SsdBwdShape<P, N, CH>;
  constexpr int R2 = S::R2, NT2 = S::NT2;
  __shared__ float wsum[kBwdThreads / 32];
  const int tid = threadIdx.x, bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * R2, e = 4 * tid;
  const bool active = e < R2 * P;
  const int kr = k0 + e / P, col = e % P;
  const long long stride = (long long)H * N * P;  // one chunk
  const long long at = ((long long)b * nc * H + h) * N * P + kr * P + col;
  const float* last = cum + ((long long)b * nc * H + h) * CH + CH - 1;
  float gv[4] = {0.f, 0.f, 0.f, 0.f};
  if (active && dstate != nullptr)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gv[q] = dstate[((long long)bh * P + col + q) * N + kr];
  for (int c = nc - 1; c >= 0; --c) {
    float qv[4] = {0.f, 0.f, 0.f, 0.f}, dot = 0.f;
    if (active) {
      float* slot = g + at + c * stride;
      if (c > 0) {
        const float4 qq = *reinterpret_cast<const float4*>(slot);
        const float4 ss =
            *reinterpret_cast<const float4*>(s_in + at + c * stride);
        qv[0] = qq.x; qv[1] = qq.y; qv[2] = qq.z; qv[3] = qq.w;
        dot = ss.x * gv[0] + ss.y * gv[1] + ss.z * gv[2] + ss.w * gv[3];
      }
      *reinterpret_cast<float4*>(slot) =
          make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
    if (c == 0) break;
    const float dec = expf(last[(long long)c * H * CH]);
#pragma unroll
    for (int q = 0; q < 4; ++q) gv[q] = fmaf(dec, gv[q], qv[q]);
    // the block's partial dot, in a fixed order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if ((tid & 31) == 0) wsum[tid >> 5] = dot;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kBwdThreads / 32; ++w) s += wsum[w];
      sg[((long long)bh * nc + c) * NT2 + blockIdx.y] = s;
    }
    __syncthreads();  // wsum is rewritten by the next chunk
  }
}

// ---------------------------------------------------------------------------
// Stages 1 and 3 on the tensor cores, one template for both dtypes
// ---------------------------------------------------------------------------

// Tiles, warps and shared memory of stages 1 and 3; pitches in elements
// of T.  fp32 (split-TF32): rows read by ldmatrix at an odd number of
// 16-byte units, rows read as row pairs 2t, 2t + 1 at 4 (mod 16) words,
// rows t, t + 4 at 8 (mod 32).  bf16 (m16n8k16): every row is read by
// ldmatrix (or .trans), a whole number of 16-byte units at a pitch of 8
// more elements, so the 8 rows of one matrix lie on distinct banks.
template <typename T, int P, int N, int CH>
struct SsdBwdMma {
  static_assert(P % 16 == 0 && N % 16 == 0 && CH % 16 == 0 && P <= 64 &&
                    N <= 128 && CH <= 128,
                "ssd_bwd: p, n and chunk must be multiples of 16, p at most "
                "64, n and chunk at most 128");
  static constexpr bool kFp32 = std::is_same_v<T, float>;
  static constexpr int W = CH / 16;              // stage 3: 16 rows a warp
  static constexpr int kThreads = 32 * W;
  static constexpr int WD = N / 16;              // stage 1: 16 n-rows a warp
  static constexpr int kDstateThreads = 32 * WD;
  static constexpr int YP = kFp32 ? P + 4 : P + 8;  // dy, xb, G, S_in rows:
                                     // ldmatrix, and fp32 dy's row pairs
  static constexpr int KT = CH < 64 ? CH : 64;   // rows of a B or C strip
  static constexpr int KN = N < 32 ? N : 32;     // B G: n columns a tile
  static constexpr int SP = kFp32 ? N + 4 : N + 8;  // B, C strip rows
  static constexpr int GP = P + 8;   // G rows (fp32: rows t, t + 4)
  static constexpr int BP = kFp32 ? KN + 4 : KN + 8;  // B column tile rows
  static constexpr int BUF = cmax(CH * BP + KN * GP, cmax(N * YP, KT * SP));
  // dy, xb and the tile buffer (T), eight row vectors and T's column sums
  // a warp (fp32)
  static constexpr size_t kChunkSmem =
      sizeof(T) * (2 * CH * YP + BUF) + sizeof(float) * (8 * CH + W * CH);
  // stage 1: C and dy strips of KD rows, two of each (double-buffered),
  // and exp(cum)
  static constexpr int KD = CH < 32 ? CH : 32;
  static constexpr int DCP = N + 8, DYP = P + 8;
  static constexpr size_t kDstateSmem =
      sizeof(T) * 2 * KD * (DCP + DYP) + sizeof(float) * CH;
  // two blocks an SM at (64, 128, 128): 128 registers a thread
  static constexpr int kMinBlocks = 2;
};

// The sum over the four lanes of a quad (one accumulator row), in a
// fixed order; every lane gets it
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage 1: Q_c = sum_i exp(cum_i) C_i (x) dy_i, (n x p), chunks c > 0; a
// warp a 16-row tile of n, every column.  The chunk in strips of KD rows,
// double-buffered: the next strip's copy is in flight while this one's
// products run.  A = exp(cum) C^T by mma_atb_scaled (mma.cuh), which K4's
// forward shares: fp32 from C's rows t, t + 4, split in TF32, each strip's
// k steps into a fresh accumulator that the CUDA cores add to acc; bf16
// C's rows by ldmatrix.trans, each scaled by exp(cum_i) in registers
// before it is rounded to bf16.
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(SsdBwdMma<T, P, N, CH>::kDstateThreads)
    ssd_bwd_dstate_mma(const T* __restrict__ dy, const T* __restrict__ Cm,
                       const float* __restrict__ cum_in,
                       float* __restrict__ g, int L, int H, int nc) {
  using S = SsdBwdMma<T, P, N, CH>;
  constexpr int NTH = S::kDstateThreads, KD = S::KD;
  constexpr int DCP = S::DCP, DYP = S::DYP, NTP = P / 8;
  constexpr int STRIP = KD * (DCP + DYP);  // C rows, then dy rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* strips = reinterpret_cast<T*>(smem_raw);                // 2 x STRIP
  float* ec = reinterpret_cast<float*>(strips + 2 * STRIP);  // exp(cum_i)

  const int tid = threadIdx.x, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (tid >> 5);
  const int bch = blockIdx.x, h = bch % H, bc = bch / H;
  const int c = bc % nc, b = bc / nc, l0 = c * CH;
  if (c == 0) return;  // the gradient entering chunk 0 is not needed
  const T* cb = Cm + (long long)b * L * N;
  const T* dyh = dy + ((long long)b * L * H + h) * P;
  auto stage = [&](T* at, int i0) {
    stage_tile<KD, N, DCP, NTH>(at, cb, N, l0 + i0, L);
    stage_tile<KD, P, DYP, NTH>(at + KD * DCP, dyh, (long long)H * P,
                                l0 + i0, L);
    cp_async_commit();
  };
  stage(strips, 0);
  for (int i = tid; i < CH; i += NTH)
    ec[i] = expf(cum_in[(long long)bch * CH + i]);
  float acc[NTP][4];
  zero(acc);
  for (int i0 = 0, q = 0; i0 < CH; i0 += KD, q ^= 1) {
    if (i0 + KD < CH) {
      stage(strips + (q ^ 1) * STRIP, i0 + KD);
      cp_async_wait_one();            // this strip's group landed
    } else {
      cp_async_wait_all();
    }
    __syncthreads();                  // ... for every thread; ec written
    const T* cs = strips + q * STRIP;
    // A = exp(cum) C^T (n rows, k = i) from C's rows, B = dy (k = i rows)
    mma_atb_scaled<NTP, KD, DCP, DYP>(acc, cs + m0, ec + i0, cs + KD * DCP,
                                      lane);
    __syncthreads();                  // the strip consumed: its buffer is
  }                                   // the one after next's
  float* out = g + (long long)bch * N * P + (m0 + gq) * P + 2 * tq;
#pragma unroll
  for (int n = 0; n < NTP; ++n) {
    store_vec<2>(out + 8 * n, acc[n]);
    store_vec<2>(out + 8 * P + 8 * n, acc[n] + 2);
  }
}

// Stage 3: one (batch, chunk, head): dx, ddt, the head's dB and dC rows
// (into scratch) and its dA partial.  Warp w owns rows [16w, 16w + 16) of
// the chunk: as j in the dxb and dB products, as i in dC's.  Every
// product goes through mma_abt (T's products of two row-major tiles),
// mma_acc_a (an accumulator tile as A) or, for B G, the dtype's own
// fragments; the pass structure is the same for both dtypes.
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(SsdBwdMma<T, P, N, CH>::kThreads,
                                  SsdBwdMma<T, P, N, CH>::kMinBlocks)
    ssd_bwd_chunk_mma(const T* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const T* __restrict__ Bm,
                      const T* __restrict__ Cm,
                      const T* __restrict__ dy,
                      const float* __restrict__ cum_in,
                      const float* __restrict__ s_in,
                      const float* __restrict__ cbt,
                      const float* __restrict__ g,
                      const float* __restrict__ sg, T* __restrict__ dx,
                      float* __restrict__ ddt, float* __restrict__ dbh,
                      float* __restrict__ dch, float* __restrict__ dap, int L,
                      int H, int nc, int has_dstate) {
  using S = SsdBwdMma<T, P, N, CH>;
  constexpr int NTH = S::kThreads, YP = S::YP, KT = S::KT, KN = S::KN;
  constexpr int SP = S::SP, GP = S::GP, BP = S::BP;
  constexpr int NTP = P / 8, NTN = N / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);  // CH x YP: dy
  T* xs = ys + CH * YP;                    // CH x YP: xb = x dt
  T* buf = xs + CH * YP;                   // streamed tiles
  float* cum = reinterpret_cast<float*>(buf + S::BUF);
  float* ec = cum + CH;     // exp(cum_i)
  float* ed = ec + CH;      // exp(cum_last - cum_j)
  float* dts = ed + CH;
  float* dcum = dts + CH;   // -(T's row sums), then dcum, then da
  float* ddts = dcum + CH;  // ddt through xb
  float* wrow = ddts + CH;  // W_j
  float* dcs = wrow + CH;   // exp(cum_i) dy_i . (S_in C_i)
  float* colp = dcs + CH;   // W x CH: T's column sums over a warp's rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp, ra = r0 + gq, rb = ra + 8;  // the thread's rows
  const int bch = blockIdx.x, h = bch % H, bc = bch / H;
  const int c = bc % nc, b = bc / nc, l0 = c * CH;
  const int la = l0 + ra, lb = l0 + rb;
  const bool has_g = c < nc - 1 || has_dstate;  // G of this chunk nonzero
  const bool has_s = c > 0;                     // S_in nonzero
  const float* gc = g + (long long)bch * N * P;
  const float* sc = s_in + (long long)bch * N * P;
  const float* cbc = cbt + (long long)bc * CH * CH;
  const long long xstride = (long long)H * P;   // x, dy: row l
  const long long xoff = ((long long)b * L * H + h) * P;
  const T* Bb = Bm + (long long)b * L * N;
  const T* Cb = Cm + (long long)b * L * N;

  stage_tile<CH, P, YP, NTH>(ys, dy + xoff, xstride, l0, L);
  stage_tile<CH, P, YP, NTH>(xs, x + xoff, xstride, l0, L);
  cp_async_commit();
  for (int j = tid; j < CH; j += NTH) {
    const int l = l0 + j;
    cum[j] = cum_in[(long long)bch * CH + j];
    dts[j] = l < L ? dt[((long long)b * L + l) * H + h] : 0.f;
    wrow[j] = dcs[j] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int j = tid; j < CH; j += NTH) {
    ec[j] = expf(cum[j]);
    ed[j] = expf(cum[CH - 1] - cum[j]);
  }
  // xb = x dt in place (bf16: rounded once, as it is staged)
  for (int q = tid; q < CH * P; q += NTH) {
    T* v = xs + (q / P) * YP + q % P;
    *v = from_float<T>(to_float(*v) * dts[q / P]);
  }
  __syncthreads();

  // 1. dxb_j = exp(cum_last - cum_j) (B G)_j + sum_{i>=j} M_ij dy_i with
  //    M_ij = (C_i . B_j) L_ij; W_j = xb_j . (its first term); dx, ddt;
  //    Z_ji = xb_j . dy_i for T_ij = M_ij Z_ji: -T on cum_j (row sums),
  //    +T on cum_i (column sums)
  {
    float d[NTP][4];
    zero(d);
    if (has_g) {
      T* bt = buf;                   // CH x BP: B's columns k0.. a row
      T* gt = buf + CH * BP;         // KN x GP: G's rows k0..
      for (int k0 = 0; k0 < N; k0 += KN) {
        __syncthreads();             // the previous tile consumed
        stage_tile<CH, KN, BP, NTH>(bt, Bb + k0, N, l0, L);
        stage_state<KN, P, GP, NTH>(gt, gc + (long long)k0 * P);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        if constexpr (S::kFp32) {
#pragma unroll
          for (int ks = 0; ks < KN; ks += 8) {
            unsigned ahi[4], alo[4];
            frag_a<BP>(ahi, alo, bt + r0 * BP, ks, lane);
            const float* gr = gt + (ks + tq) * GP + gq;
#pragma unroll
            for (int n = 0; n < NTP; ++n)
              mma_3xtf32(d[n], ahi, alo, split_tf32(gr[8 * n]),
                         split_tf32(gr[4 * GP + 8 * n]));
          }
        } else {
          const T* ba = bt + (r0 + (lane & 15)) * BP + (lane >> 4) * 8;
#pragma unroll
          for (int ks = 0; ks < KN; ks += 16) {
            unsigned af[1][4];
            ldsm4(af[0], ba + ks);
            mma_ab<NTP, 1, GP>(d, af, gt + ks * GP, lane);
          }
        }
      }
      const float ea = ed[ra], eb = ed[rb];
      float wa = 0.f, wb = 0.f;
#pragma unroll
      for (int n = 0; n < NTP; ++n) {
        const int col = 8 * n + 2 * tq;
        d[n][0] *= ea;
        d[n][1] *= ea;
        d[n][2] *= eb;
        d[n][3] *= eb;
        wa = fmaf(to_float(xs[ra * YP + col]), d[n][0], wa);
        wa = fmaf(to_float(xs[ra * YP + col + 1]), d[n][1], wa);
        wb = fmaf(to_float(xs[rb * YP + col]), d[n][2], wb);
        wb = fmaf(to_float(xs[rb * YP + col + 1]), d[n][3], wb);
      }
      wa = quad_sum(wa);
      wb = quad_sum(wb);
      if (tq == 0) {
        wrow[ra] = wa;
        wrow[rb] = wb;
      }
    }
    float ta = 0.f, tb = 0.f;        // T's row sums of rows ra, rb
    for (int i0 = r0; i0 < CH; i0 += 16) {  // the tiles on or below
      float z[2][4];                         // the diagonal
      zero(z);
      mma_abt<2, P, YP>(z, xs + r0 * YP, ys + i0 * YP, lane);
      const bool diag = i0 == r0;
      float m[2][4];                         // M_ji in z's layout
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + 8 * half + 2 * tq;  // columns i, i + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {        // (ra, i), (ra, i+1), (rb, ..)
          const int j = e < 2 ? ra : rb, ii = i + (e & 1);
          const bool low = !diag || ii >= j;   // C B^T written only there
          const float dec = expf(low ? cum[ii] - cum[j] : kBwdMask);
          m[half][e] = low ? cbc[j * CH + ii] * dec : 0.f;
        }
        const float t0 = m[half][0] * z[half][0];
        const float t1 = m[half][1] * z[half][1];
        const float t2 = m[half][2] * z[half][2];
        const float t3 = m[half][3] * z[half][3];
        ta += t0 + t1;
        tb += t2 + t3;
        float c0 = t0 + t2, c1 = t1 + t3;      // over the 8 row groups
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, o);
          c1 += __shfl_xor_sync(0xffffffffu, c1, o);
        }
        if (gq == 0) {
          colp[warp * CH + i] = c0;
          colp[warp * CH + i + 1] = c1;
        }
        mma_acc_a<NTP, YP>(d, m, half, ys + i0 * YP, lane);
      }
    }
    ta = quad_sum(ta);
    tb = quad_sum(tb);
    float sa = 0.f, sb = 0.f;        // x . dxb
    const T* xa = x + xoff + la * xstride;
    const T* xb_ = x + xoff + lb * xstride;
    T* dxa = dx + xoff + la * xstride;
    T* dxb_ = dx + xoff + lb * xstride;
#pragma unroll
    for (int n = 0; n < NTP; ++n) {
      const int col = 8 * n + 2 * tq;
      if (la < L) {
        const float2 xv = ld2(xa + col);
        sa = fmaf(xv.x, d[n][0], sa);
        sa = fmaf(xv.y, d[n][1], sa);
        const float v[2] = {d[n][0] * dts[ra], d[n][1] * dts[ra]};
        store_vec<2>(dxa + col, v);
      }
      if (lb < L) {
        const float2 xv = ld2(xb_ + col);
        sb = fmaf(xv.x, d[n][2], sb);
        sb = fmaf(xv.y, d[n][3], sb);
        const float v[2] = {d[n][2] * dts[rb], d[n][3] * dts[rb]};
        store_vec<2>(dxb_ + col, v);
      }
    }
    sa = quad_sum(sa);
    sb = quad_sum(sb);
    if (tq == 0) {
      dcum[ra] = -ta;
      dcum[rb] = -tb;
      ddts[ra] = sa;
      ddts[rb] = sb;
    }
  }

  // 2. the head's dB_j = exp(cum_last - cum_j) (xb G^T)_j + sum_{i>=j}
  //    P_ij C_i, P^T recomputed from Z, C streamed in strips of KT rows
  {
    float e[NTN][4];
    zero(e);
    if (has_g) {
      __syncthreads();               // phase 1's tiles consumed
      stage_state<N, P, YP, NTH>(buf, gc);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      mma_abt<NTN, P, YP>(e, xs + r0 * YP, buf, lane);
      const float ea = ed[ra], eb = ed[rb];
#pragma unroll
      for (int n = 0; n < NTN; ++n) {
        e[n][0] *= ea;
        e[n][1] *= ea;
        e[n][2] *= eb;
        e[n][3] *= eb;
      }
    }
    for (int s0 = 0; s0 < CH; s0 += KT) {
      __syncthreads();
      stage_tile<KT, N, SP, NTH>(buf, Cb, N, l0 + s0, L);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      for (int i0 = max(s0, r0); i0 < s0 + KT; i0 += 16) {  // none above
        float z[2][4];                                       // the diagonal
        zero(z);
        mma_abt<2, P, YP>(z, xs + r0 * YP, ys + i0 * YP, lane);
        const bool diag = i0 == r0;
        float pv[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + 8 * half + 2 * tq;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = q < 2 ? ra : rb, ii = i + (q & 1);
            const bool low = !diag || ii >= j;
            pv[half][q] = expf(low ? cum[ii] - cum[j] : kBwdMask) *
                          z[half][q];
          }
          mma_acc_a<NTN, SP>(e, pv, half, buf + (i0 - s0) * SP, lane);
        }
      }
    }
    float* out = dbh + (long long)bch * CH * N + ra * N + 2 * tq;
#pragma unroll
    for (int n = 0; n < NTN; ++n) {
      store_vec<2>(out + 8 * n, e[n]);
      store_vec<2>(out + 8 * N + 8 * n, e[n] + 2);
    }
  }

  // 3. the head's dC_i = exp(cum_i) (dy S_in^T)_i + sum_{j<=i} P_ij B_j;
  //    the first term's C_i . (it) is dcum's exp(cum_i) dy_i . (S_in C_i);
  //    P recomputed from Z^T, B streamed in strips of KT rows
  {
    float f[NTN][4];
    zero(f);
    if (has_s) {
      __syncthreads();               // the last strip consumed
      stage_state<N, P, YP, NTH>(buf, sc);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      mma_abt<NTN, P, YP>(f, ys + r0 * YP, buf, lane);
      const float ea = ec[ra], eb = ec[rb];
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int n = 0; n < NTN; ++n) {
        const int col = 8 * n + 2 * tq;
        f[n][0] *= ea;
        f[n][1] *= ea;
        f[n][2] *= eb;
        f[n][3] *= eb;
        if (la < L) {
          const float2 cv = ld2(Cb + (long long)la * N + col);
          sa = fmaf(cv.x, f[n][0], sa);
          sa = fmaf(cv.y, f[n][1], sa);
        }
        if (lb < L) {
          const float2 cv = ld2(Cb + (long long)lb * N + col);
          sb = fmaf(cv.x, f[n][2], sb);
          sb = fmaf(cv.y, f[n][3], sb);
        }
      }
      sa = quad_sum(sa);
      sb = quad_sum(sb);
      if (tq == 0) {
        dcs[ra] = sa;
        dcs[rb] = sb;
      }
    }
    for (int s0 = 0; s0 < CH; s0 += KT) {
      __syncthreads();
      stage_tile<KT, N, SP, NTH>(buf, Bb, N, l0 + s0, L);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      for (int j0 = s0; j0 < s0 + KT && j0 <= r0; j0 += 16) {  // none above
        float z[2][4];                                          // the diagonal
        zero(z);
        mma_abt<2, P, YP>(z, ys + r0 * YP, xs + j0 * YP, lane);
        const bool diag = j0 == r0;
        float pv[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + 8 * half + 2 * tq;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = q < 2 ? ra : rb, jj = j + (q & 1);
            const bool low = !diag || jj <= i;
            pv[half][q] = expf(low ? cum[i] - cum[jj] : kBwdMask) *
                          z[half][q];
          }
          mma_acc_a<NTN, SP>(f, pv, half, buf + (j0 - s0) * SP, lane);
        }
      }
    }
    float* out = dch + (long long)bch * CH * N + ra * N + 2 * tq;
#pragma unroll
    for (int n = 0; n < NTN; ++n) {
      store_vec<2>(out + 8 * n, f[n]);
      store_vec<2>(out + 8 * N + 8 * n, f[n] + 2);
    }
  }
  __syncthreads();  // dcum, colp, wrow, ddts, dcs complete

  // 4. dcum_i: T's column sums over the warps of rows j <= i, in warp
  //    order, and the S_in term
  for (int i = tid; i < CH; i += NTH) {
    float s = 0.f;
    for (int w = 0; w <= i / 16; ++w) s += colp[w * CH + i];
    dcum[i] += s + dcs[i];
  }
  __syncthreads();

  // 5. cum_last's terms, da (dcum's reverse cumulative sum), ddt, the dA
  //    partial: one thread, in row order
  if (tid == 0) {
    float extra = 0.f;
    for (int j = 0; j < CH; ++j) extra += wrow[j];
    if (has_s) {
      const float* p = sg + ((long long)(b * H + h) * nc + c) *
                                SsdBwdShape<P, N, CH>::NT2;
      float dot = 0.f;
      for (int t = 0; t < SsdBwdShape<P, N, CH>::NT2; ++t) dot += p[t];
      extra = fmaf(expf(cum[CH - 1]), dot, extra);
    }
    float run = 0.f, da_sum = 0.f;
    for (int j = CH - 1; j >= 0; --j) {
      run += dcum[j] - wrow[j] + (j == CH - 1 ? extra : 0.f);
      dcum[j] = run;
      da_sum = fmaf(dts[j], run, da_sum);
    }
    dap[bch] = da_sum;
  }
  __syncthreads();
  const float a_h = A[h];
  for (int j = tid; j < CH; j += NTH) {
    const int l = l0 + j;
    if (l < L) ddt[((long long)b * L + l) * H + h] = fmaf(a_h, dcum[j], ddts[j]);
  }
}

// Stage 4: dB, dC (b, l, n) summed over the heads, dA over (batch, chunk),
// in order; blockIdx.y: 0 dB, 1 dC, 2 dA (its first block only).
template <typename T, int N, int CH>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_sum(const float* __restrict__ dbh, const float* __restrict__ dch,
                const float* __restrict__ dap, T* __restrict__ dB,
                T* __restrict__ dC, float* __restrict__ dA, int batch, int L,
                int H, int nc) {
  if (blockIdx.y == 2) {
    if (blockIdx.x != 0) return;
    for (int h = threadIdx.x; h < H; h += kBwdThreads) {
      float s = 0.f;
      for (int bc = 0; bc < batch * nc; ++bc) s += dap[(long long)bc * H + h];
      dA[h] = s;
    }
    return;
  }
  const long long idx = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
  if (idx >= (long long)batch * L * N) return;
  const int k = idx % N;
  const long long bl = idx / N;
  const int l = bl % L, b = bl / L, c = l / CH, r = l % CH;
  const float* src = (blockIdx.y ? dch : dbh) +
                     (((long long)b * nc + c) * H * CH + r) * N + k;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += src[(long long)h * CH * N];
  (blockIdx.y ? dC : dB)[idx] = from_float<T>(s);
}

// The backward's own fp32 scratch at (batch, L, H), in this order: g
// (batch, nc, H, N, P), sg (batch, H, nc, NT2), dbh and dch (batch, nc,
// H, chunk, N) each, dap (batch, nc, H).  g comes first, at the start of
// the caller's allocation, so that it is 16-byte aligned (float4 loads).
constexpr int kBwdParts = 5;

template <int P, int N, int CH>
void ssd_bwd_parts(int batch, int L, int H, long long (&f)[kBwdParts]) {
  using S = SsdBwdShape<P, N, CH>;
  const long long bnch = (long long)batch * ((L + CH - 1) / CH) * H;
  f[0] = bnch * N * P;
  f[1] = bnch * S::NT2;
  f[2] = f[3] = bnch * CH * N;
  f[4] = bnch;
}

// The four stages, in order, on `stream`; the error of the first launch
// that fails, else cudaGetLastError() after the last.
template <typename T, int P, int N, int CH>
cudaError_t launch_ssd_bwd(const void* x, const void* dt, const void* A,
                           const void* B, const void* C, const void* dy,
                           const void* dstate, const void* cum,
                           const void* s_in, const void* cbt, void* dx,
                           void* ddt, void* dA, void* dB, void* dC,
                           float* work, long long work_floats, int batch,
                           int L, int H, int device, cudaStream_t stream) {
  using S = SsdBwdShape<P, N, CH>;
  long long parts[kBwdParts];
  ssd_bwd_parts<P, N, CH>(batch, L, H, parts);
  float* part[kBwdParts];
  long long at = 0;
  for (int i = 0; i < kBwdParts; ++i) {
    part[i] = work + at;
    at += parts[i];
  }
  if (work_floats < at) return cudaErrorInvalidValue;
  cudaError_t err;
  const int nc = (L + CH - 1) / CH;
  const T *xp = static_cast<const T*>(x), *bp = static_cast<const T*>(B),
          *cp = static_cast<const T*>(C), *dyp = static_cast<const T*>(dy);
  const float *cump = static_cast<const float*>(cum),
              *sp = static_cast<const float*>(s_in);
  float *gp = part[0], *sgp = part[1], *dbhp = part[2], *dchp = part[3],
        *dapp = part[4];
  using M = SsdBwdMma<T, P, N, CH>;
  if ((err = allow_smem_once<ssd_bwd_dstate_mma<T, P, N, CH>>(
           M::kDstateSmem, device)) != cudaSuccess ||
      (err = allow_smem_once<ssd_bwd_chunk_mma<T, P, N, CH>>(
           M::kChunkSmem, device)) != cudaSuccess)
    return err;
  ssd_bwd_dstate_mma<T, P, N, CH><<<batch * nc * H, M::kDstateThreads,
                                    M::kDstateSmem, stream>>>(
      dyp, cp, cump, gp, L, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_state_pass<P, N, CH><<<dim3(batch * H, S::NT2), kBwdThreads, 0,
                                 stream>>>(
      cump, sp, static_cast<const float*>(dstate), gp, sgp, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_chunk_mma<T, P, N, CH><<<batch * nc * H, M::kThreads,
                                   M::kChunkSmem, stream>>>(
      xp, static_cast<const float*>(dt), static_cast<const float*>(A), bp,
      cp, dyp, cump, sp, static_cast<const float*>(cbt), gp, sgp,
      static_cast<T*>(dx), static_cast<float*>(ddt), dbhp, dchp, dapp, L, H,
      nc, dstate != nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long elems = (long long)batch * L * N;
  ssd_bwd_sum<T, N, CH><<<dim3((elems + kBwdThreads - 1) / kBwdThreads, 3),
                          kBwdThreads, 0, stream>>>(
      dbhp, dchp, dapp, static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), batch, L, H, nc);
  return cudaGetLastError();
}

// The (p, n, chunk) shapes instantiated: those of the forward (keep in
// step with csrc/ssd.cu and SSD_SHAPES in repro_torch/kernels/ops.py).
#define GFDIT_SSD_BWD_SHAPES(X) \
  X(64, 128, 128) /* mamba2-1.3b at full width */ \
  X(16, 16, 16)   /* mamba2-1.3b.reduced() */ \
  X(16, 16, 32)   /* the JAX package's kernel sweep */ \
  X(32, 16, 64) \
  X(64, 32, 128) \
  X(64, 64, 128)  /* zamba2-7b at full width */

template <typename T>
cudaError_t dispatch_ssd_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* dy,
                             const void* dstate, const void* cum,
                             const void* s_in, const void* cbt, void* dx,
                             void* ddt, void* dA, void* dB, void* dC,
                             float* work, long long work_floats, int batch,
                             int L, int H, int P, int N, int chunk,
                             int device, cudaStream_t s) {
#define GFDIT_SSD_BWD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) \
    return launch_ssd_bwd<T, p, n, c>(x, dt, A, B, C, dy, dstate, cum, s_in, \
                                      cbt, dx, ddt, dA, dB, dC, work, \
                                      work_floats, batch, L, H, device, s);
  GFDIT_SSD_BWD_SHAPES(GFDIT_SSD_BWD_CASE)
#undef GFDIT_SSD_BWD_CASE
  return cudaErrorInvalidValue;
}

// Floats of the backward's own scratch at (batch, L, H, P, N, chunk); -1
// for a shape that is not instantiated.
inline long long ssd_bwd_scratch(int batch, int L, int H, int P, int N,
                                 int chunk) {
  long long f[kBwdParts];
#define GFDIT_SSD_BWD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) { \
    ssd_bwd_parts<p, n, c>(batch, L, H, f); \
    return f[0] + f[1] + f[2] + f[3] + f[4]; \
  }
  GFDIT_SSD_BWD_SHAPES(GFDIT_SSD_BWD_CASE)
#undef GFDIT_SSD_BWD_CASE
  return -1;
}

template <typename T, int P, int N, int CH>
cudaError_t occupancy_ssd_bwd(int stage, int batch, int L, int H, int device,
                              int* blocks_per_sm, int* smem_bytes, int* grid,
                              int* threads) {
  using S = SsdBwdShape<P, N, CH>;
  using M = SsdBwdMma<T, P, N, CH>;
  const int nc = (L + CH - 1) / CH;
  *threads = kBwdThreads;
  switch (stage) {
    case 0:  // the chunk-0 blocks return at once
      *grid = batch * nc * H;
      *threads = M::kDstateThreads;
      return occupancy_of<ssd_bwd_dstate_mma<T, P, N, CH>>(
          M::kDstateSmem, M::kDstateThreads, device, blocks_per_sm,
          smem_bytes);
    case 1:
      *grid = batch * H * S::NT2;
      *smem_bytes = static_cast<int>(sizeof(float) * kBwdThreads / 32);
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, ssd_bwd_state_pass<P, N, CH>, kBwdThreads, 0);
    case 2:
      *grid = batch * nc * H;
      *threads = M::kThreads;
      return occupancy_of<ssd_bwd_chunk_mma<T, P, N, CH>>(
          M::kChunkSmem, M::kThreads, device, blocks_per_sm, smem_bytes);
    case 3:
      *grid = static_cast<int>(2 * (((long long)batch * L * N + kBwdThreads -
                                     1) / kBwdThreads) + 1);
      *smem_bytes = 0;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, ssd_bwd_sum<T, N, CH>, kBwdThreads, 0);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bwd_occupancy(int stage, int batch, int L, int H, int P,
                                   int N, int chunk, int device,
                                   int* blocks_per_sm, int* smem_bytes,
                                   int* grid, int* threads) {
#define GFDIT_SSD_BWD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) \
    return occupancy_ssd_bwd<T, p, n, c>(stage, batch, L, H, device, \
                                         blocks_per_sm, smem_bytes, grid, \
                                         threads);
  GFDIT_SSD_BWD_SHAPES(GFDIT_SSD_BWD_CASE)
#undef GFDIT_SSD_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace gfdit

// Floats of fp32 scratch gfdit_ssd_bwd needs of its caller at (batch, L,
// H, P, N, chunk), by its own rule (ssd_bwd_parts); -1 for a shape it
// cannot take.
extern "C" long long gfdit_ssd_bwd_scratch(int batch, int L, int H, int P,
                                           int N, int chunk) {
  if (batch <= 0 || L <= 0 || H <= 0) return -1;
  return gfdit::ssd_bwd_scratch(batch, L, H, P, N, chunk);
}

// x/dx, dy: (batch, L, H, P) and B/C/dB/dC: (batch, L, N), all of one
// dtype; dt/ddt: (batch, L, H), A/dA: (H,), dstate: (batch, H, P, N) or
// null, fp32.  From the forward's scratch (ops.ssd under autograd), fp32,
// nc = ceil(L / chunk): cum (batch, nc, H, chunk), s_in (batch, nc, H, N,
// P) and cbt (batch, nc, chunk, chunk).  work: fp32 scratch of
// work_floats, at least gfdit_ssd_bwd_scratch's.  work and s_in 16-byte
// aligned (float4 loads), and x, B, C and dy (16-byte cp.async in fp32).
extern "C" int gfdit_ssd_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* dy,
                             const void* dstate, const void* cum,
                             const void* s_in, const void* cbt, void* dx,
                             void* ddt, void* dA, void* dB, void* dC,
                             float* work, long long work_floats, int batch,
                             int L, int H, int P, int N, int chunk,
                             int dtype, int device, void* stream) {
  using namespace gfdit;
  if (batch <= 0 || L <= 0 || H <= 0 || work == nullptr)
    return cudaErrorInvalidValue;
  const void* vec[] = {work, s_in, x, B, C, dy};
  for (const void* p : vec)
    if (reinterpret_cast<unsigned long long>(p) & 15)
      return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_ssd_bwd<float>(x, dt, A, B, C, dy, dstate, cum, s_in, cbt,
                                   dx, ddt, dA, dB, dC, work, work_floats,
                                   batch, L, H, P, N, chunk, device, s);
  if (dtype == kBFloat16)
    return dispatch_ssd_bwd<__nv_bfloat16>(
        x, dt, A, B, C, dy, dstate, cum, s_in, cbt, dx, ddt, dA, dB, dC, work,
        work_floats, batch, L, H, P, N, chunk, device, s);
  return cudaErrorInvalidValue;
}

// Occupancy of one stage kernel of the (P, N, chunk) instantiation (0
// ssd_bwd_dstate_mma, the chunk states Q; 1 ssd_bwd_state_pass; 2
// ssd_bwd_chunk_mma; 3 ssd_bwd_sum) at (batch, L, H): resident blocks per
// SM, shared-memory bytes a block, the launch's grid and its threads a
// block.
extern "C" int gfdit_ssd_bwd_occupancy(int stage, int batch, int L, int H,
                                       int P, int N, int chunk, int dtype,
                                       int device, int* blocks_per_sm,
                                       int* smem_bytes, int* grid,
                                       int* threads) {
  using namespace gfdit;
  if (batch <= 0 || L <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (dtype == kFloat32)
    return dispatch_bwd_occupancy<float>(stage, batch, L, H, P, N, chunk,
                                         device, blocks_per_sm, smem_bytes,
                                         grid, threads);
  if (dtype == kBFloat16)
    return dispatch_bwd_occupancy<__nv_bfloat16>(
        stage, batch, L, H, P, N, chunk, device, blocks_per_sm, smem_bytes,
        grid, threads);
  return cudaErrorInvalidValue;
}
