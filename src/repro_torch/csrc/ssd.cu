// Mamba2 SSD (state-space dual) chunked scan, chunk-parallel.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_scan (_ssd_kernel),
// which walks each (batch, head)'s chunks in order carrying the (p x n)
// state.  Within a chunk of c rows, with cum the in-chunk cumulative sum
// of dt*A and xb = x*dt,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xb_j
//         + exp(cum_i) (C_i . S_in)
//   S_out = exp(cum_last) S_in + sum_j exp(cum_last - cum_j) xb_j (x) B_j
// and the last S_out is the final state.  Only the S_in hand-off is
// sequential across chunks, so one call runs four stage kernels in turn
// on the caller's stream (the decomposition of the JAX package's jnp
// ssd_chunked and of Mamba2's "minimal SSD", arXiv:2405.21060 sec. 6):
//   1. ssd_chunk_state_mma, a block per (batch, chunk, head): cum (to
//      scratch) and the chunk-local state S_c = sum_j exp(cum_last -
//      cum_j) xb_j (x) B_j, stored transposed (n x p) in a chunk-state
//      scratch;
//   2. ssd_state_pass, a block per (batch, head, n-row tile): walks the
//      chunks in order, S_in[0] = 0, S_in[c+1] = exp(cum_last_c) S_in[c]
//      + S_c, overwriting the scratch with each chunk's S_in; writes the
//      final state (p x n);
//   3. ssd_cb_mma, a block per (batch, chunk, tile of the causal
//      triangle): C B^T once for all heads (B and C have one group),
//      stored transposed (j, i);
//   4. ssd_chunk_scan_mma, a block per (batch, chunk, head, 64-row tile):
//      y.
// B and C are read from the shared (b, l, n) arrays, never copied per
// head.  A ragged last chunk is masked here: rows past l load dt = x = B
// = C = 0, which leaves cum and the state as they are, and are not
// written, so callers need not pad.
//
// Bound on the card: operations for fp32 operands, bytes for bf16.  The
// function needs, per (batch, chunk) of c rows, the causal C B^T once,
// c(c+1)/2 n multiply-adds, and per head the causal scores . xb, c(c+1)/2
// p, C . state, c p n (none in the first chunk), and the state update,
// c p n: 21.1 GFLOP at the full-width mamba2-1.3b prefill (b=4, l=2048,
// h=64, p=64, n=128, c=128; chip_smoke.ssd_flops), against ~287 MB of x,
// y, dt, B, C and the state in fp32 (0.086 ms at 3.35 TB/s).  In fp32
// each product is three TF32 ones: 0.128 ms at the tensor cores' 494.7
// TFLOP/s (0.315 ms at the 67 TFLOP/s fp32 CUDA-core rate); bf16 takes
// 0.021 ms at 989 TFLOP/s, under its 0.044 ms of bytes.  These kernels do
// 21.7 GFLOP of products, 1.03x the need (stage 1 8.59, stage 4 8.05 for
// C . S_in and 4.83 for the scores over whole 16-row key steps, stage 3
// 0.20), in fp32 65.1 GFLOP of TF32 ones; the CUDA-core stages before did
// 23.3, the single-kernel design before them 33.3.
// Scratch (one allocation by the wrapper, none here), at that shape:
// chunk states b*nc*h*n*p fp32, 134.2 MB; cum b*nc*h*c, 2.1 MB; C B^T
// b*nc*c*c, 4.2 MB: 140.5 MB, which stays in HBM (the chunk states) and
// L2 (the rest).  The state traffic (stage 1 writes, stage 2 reads and
// writes, stage 4 reads: 0.54 GB) is ~0.16 ms at the DRAM rate: with the
// function's bytes, the design's own floor, 0.246 ms in fp32 and 0.205
// in bf16 (PERF.md).
//
// Design.  One kernel set for both dtypes: stages 1, 3 and 4 are templates
// over the operand type that run their products on the tensor cores
// through mma.cuh's helpers (shared with K2 and K4's backward, whose fp32
// and bf16 instances make the same choices); stage 2 (ssd_state_pass) is
// one fp32 walk over the chunks.
//   * fp32 operands (the default intra_dtype): split-TF32 mma.sync
//     m16n8k8: each fp32 operand splits in registers into hi = tf32(x)
//     and lo = tf32(x - hi), and each product is three TF32 ones, a_lo
//     b_hi + a_hi b_lo + a_hi b_hi (one TF32 product keeps ~1e-3 against
//     K4's 1e-4 budget: tests/test_torch_ssd_fp32.py models both).
//     Operands go to shared memory as fp32 rows by 16-byte cp.async;
//     rows read by ldmatrix (a row-major fp32 tile is the TF32 fragment:
//     row lane/4, word lane%4) lie at an odd number of 16-byte units (N +
//     4), rows read as rows t and t + 4 at 8 (mod 32) words (N + 8, P +
//     8), rows read as row pairs 2t, 2t + 1 at 4 (mod 16) (P + 4, and the
//     C B^T tile's RT + 4), so no read of a warp meets a bank twice.
//   * bf16 operands (intra_dtype="bfloat16", the JAX package's ssd_bf16
//     variant): mma.sync m16n8k16 on bf16 operands into fp32
//     accumulators, every row read by ldmatrix(.trans) at a pitch of 8
//     more elements.  They round where JAX's ssd_chunked at bf16 rounds, at
//     comparable points: stage 1 scales B's row j by w_j = dt_j
//     exp(cum_last - cum_j) in registers and rounds it once (x enters as
//     the bf16 it is; JAX rounds the decay and keeps x dt in fp32); stage
//     4 builds M'_ij = (C B^T)_ij exp(cum_i - cum_j) dt_j from the fp32 C
//     B^T tile and rounds it to bf16 A fragments (JAX rounds the scores
//     and the decay apart), and takes S_in in bf16, converted as it is
//     staged (JAX rounds prev_states); every sum is fp32
//     (tests/test_torch_ssd_bf16.py models each rounding).
// The stages:
//   * Stage 1, a block per (batch, chunk, head) of 8 warps, a warp a 16 x
//     PW tile of S_c^T = sum_j (w_j B_j)^T (x) x_j: A = w B^T from B's
//     rows, B = x's rows (mma_atb_scaled, as K4's backward computes its
//     state gradients: bf16 by ldmatrix.trans, each row scaled and
//     rounded once; fp32 from B's rows t, t + 4, scaled after the load,
//     then split, each 32-row tile's k steps into a fresh accumulator
//     that the CUDA cores add to the sum); 32-row key tiles by cp.async
//     in two stages.
//   * Stage 3, a block per (batch, chunk, 64 x 64 tile of the causal
//     triangle), a warp 16 rows j by 32 columns i: A = B's rows, B = C's
//     (mma_abt; fp32 splits each fragment after its ldmatrix), written as
//     fp32 (j, i) tiles, which the backward reads.
//   * Stage 4, a block per (batch, chunk, head, 64-row tile) of 4 warps, a
//     warp its 16 rows: first C S_in over n (A = C's rows by ldmatrix, B =
//     S_in: fp32 by cp.async, read as rows t, t + 4; bf16 converted as it
//     is staged), then exp(cum_i) times that, then the key tiles up to the
//     tile's end (C B^T's (j, i) tile in fp32 and x's rows, double-
//     buffered over the C S_in operands' bytes): M' built in the
//     accumulator layout, times x's rows (mma_acc_a: fp32 as two k steps
//     of 8 whose columns 2t, 2t + 1 serve as k slots t, t + 4, x read as
//     row pairs; bf16 rounded to one A fragment); a warp skips the 16-row
//     key steps wholly past its rows, and masks the decay to -1e30 BEFORE
//     the exp on its diagonal step only (the upper triangle's cum_i -
//     cum_j is positive and its exp can overflow: inf * 0 = NaN).
//   * Shared memory, registers (ptxas) and blocks an SM at (64, 128, 128):
//     bf16 stage 1 27 KiB, 64 registers (16 B spilled), 4 blocks; stage 3
//     34 KiB, 6 blocks; stage 4 36 KiB, 95 registers, 5 blocks of 128
//     threads (116 registers and 4 blocks without the launch bounds: 2%
//     slower).  fp32 stage 1 53 KiB, 127 registers, 2 blocks (at 3
//     blocks, 80 registers, it spills 332 B and was 10% slower; at
//     zamba2-7b's (64, 64, 128) 3 blocks were 8% faster, so n <= 64 takes
//     3); stage 3 66 KiB, 3 blocks; stage 4 70 KiB (S_in 36, C's rows
//     33), 99 registers, 3 blocks of 128 threads.  Splitting x once a
//     block into hi and lo planes in shared memory, for all warps to read,
//     was 11-15% slower in both stages than splitting in registers where a
//     warp reads it (twice the shared-memory reads); 64-row key tiles in
//     stage 4, 64-row tiles in stage 1 and a whole unroll of C S_in were
//     no faster, up to 11% slower (PERF.md).  ptxas's report of every
//     instantiation: chip_smoke.py's build phase.
#include "mma.cuh"

#include <type_traits>

namespace gfdit {

constexpr int kSsdThreads = 256;  // stages 1, 2 and 3
constexpr float kSsdMask = -1e30f;

// Stage 2's shape: the n-rows of the state a block walks (4 floats a
// thread).
template <int P, int N, int CH>
struct SsdShape {
  static_assert(P % 16 == 0 && N % 16 == 0 && CH % 16 == 0 && P <= 64 &&
                    N <= 128 && CH <= 128,
                "ssd: p, n and chunk must be multiples of 16, p at most 64, "
                "n and chunk at most 128");
  static constexpr int R2 = N < 4 * kSsdThreads / P ? N : 4 * kSsdThreads / P;
};

// Stage 2: the pass of states across chunks, in place; the final state.
template <int P, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_state_pass(const float* __restrict__ cum, float* __restrict__ states,
                   float* __restrict__ state_out, int H, int nc) {
  constexpr int R2 = SsdShape<P, N, CH>::R2;
  __shared__ float tile[R2][P + 1];
  const int tid = threadIdx.x, bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * R2, e = 4 * tid;
  if (e < R2 * P) {
    const long long stride = (long long)H * N * P;  // one chunk
    float* s_c = states + ((long long)b * nc * H + h) * N * P + k0 * P + e;
    const float* last = cum + ((long long)b * nc * H + h) * CH + CH - 1;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = *reinterpret_cast<const float4*>(s_c);
    for (int c = 0; c < nc; ++c) {
      const float4 next = c + 1 < nc
          ? *reinterpret_cast<const float4*>(s_c + (c + 1) * stride)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      // S_in of chunk 0 is zero and never read: stage 4 skips C . S_in
      if (c > 0) *reinterpret_cast<float4*>(s_c + c * stride) = s;
      const float dec = expf(last[(long long)c * H * CH]);
      s = make_float4(fmaf(dec, s.x, v.x), fmaf(dec, s.y, v.y),
                      fmaf(dec, s.z, v.z), fmaf(dec, s.w, v.w));
      v = next;
    }
    float* tr = &tile[e / P][e % P];
    tr[0] = s.x; tr[1] = s.y; tr[2] = s.z; tr[3] = s.w;
  }
  __syncthreads();
  // (n x p) -> (p x n): runs of R2 consecutive floats of state_out
  float* out = state_out + (long long)bh * P * N + k0;
  for (int i = tid; i < R2 * P; i += kSsdThreads)
    out[(i / R2) * N + i % R2] = tile[i % R2][i / R2];
}

// ---------------------------------------------------------------------------
// Stages 1, 3 and 4 on the tensor cores, one template for both dtypes
// ---------------------------------------------------------------------------

// Tiles, warps and shared memory of the tensor-core stages; pitches in
// elements of T (see the file's note): bf16 rows 8 elements more than
// they hold; fp32 rows read by ldmatrix N + 4, as rows t, t + 4 8 more,
// as row pairs 4 more.
template <typename T, int P, int N, int CH>
struct SsdMma {
  static_assert(P % 16 == 0 && N % 16 == 0 && CH % 16 == 0 && P <= 64 &&
                    N <= 128 && CH <= 128,
                "ssd: p, n and chunk must be multiples of 16, p at most 64, "
                "n and chunk at most 128");
  static constexpr bool kFp32 = std::is_same_v<T, float>;
  static constexpr int KT = CH < 32 ? CH : 32;  // rows of a key tile
  static constexpr int RT = CH < 64 ? CH : 64;  // rows of a y or C B^T tile
  static constexpr int NRT = CH / RT;
  static constexpr int EPC = 16 / sizeof(T);    // elements a 16-byte copy
  static constexpr int BP = N + 8;   // stage 1's B rows (fp32: rows t, t+4)
  static constexpr int XP = P + 8;   // stage 1's x rows and stage 4's S_in
                                     // rows (n x p) (fp32: rows t, t+4)
  static constexpr int LP = kFp32 ? N + 4 : N + 8;  // B and C rows read by
                                                    // ldmatrix (stages 3, 4)
  static constexpr int YP = kFp32 ? P + 4 : P + 8;  // stage 4's x rows
                                                    // (fp32: row pairs)
  static constexpr int MP = RT + 4;  // C B^T (j, i) rows, fp32: the rows
                                     // 2t of a quad lie 8 banks apart
  // stage 1: a warp a tile of 16 state rows (n) by PW columns (p)
  static constexpr int MT = N / 16;
  static constexpr int CG1 = cmin(cmax(kSsdThreads / 32 / MT, 1), P / 16);
  static constexpr int PW = P / CG1;
  // stage 1's blocks an SM for its launch bounds (the file's note)
  static constexpr int kStateBlocks = kFp32 ? (N > 64 ? 2 : 3) : 4;
  static constexpr size_t kStateSmem =
      sizeof(float) * (2 * CH + 4) + sizeof(T) * 2 * KT * (BP + XP);
  // stage 3: a warp 16 rows j by CW columns i of the RT x RT tile
  static constexpr int CG3 = cmin(kSsdThreads / 32 / (RT / 16), RT / 16);
  static constexpr int CW = RT / CG3;
  static constexpr size_t kCbSmem = sizeof(T) * 2 * RT * LP;
  // stage 4: a warp 16 rows of the RT-row tile; C S_in first (S_in, the
  // tile's C rows), then double-buffered key tiles (C B^T's (j, i) tile,
  // fp32, and x rows) over the same bytes
  static constexpr int kScanThreads = 32 * (RT / 16);
  static constexpr int kScanBlocks = kFp32 ? 3 : 5;
  static constexpr size_t kKeyStage =
      sizeof(float) * KT * MP + sizeof(T) * KT * YP;
  static constexpr size_t kScanSmem =
      sizeof(float) * 2 * CH +
      cmax(sizeof(T) * (N * XP + RT * LP), 2 * kKeyStage);
};

// Stage 1: cum, and S_c^T = sum_j (w_j B_j)^T (x) x_j with w_j = dt_j
// exp(cum_last - cum_j), (n x p), fp32.  A warp a 16 x PW tile of S_c^T:
// A = B's tile rows scaled by w_j in registers (mma_atb_scaled: bf16
// rounds each scaled row back to bf16, so x enters as the bf16 it is:
// one rounding, where a bf16 x dt would give two; fp32 splits it), B =
// x's rows.
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads,
                                  SsdMma<T, P, N, CH>::kStateBlocks)
    ssd_chunk_state_mma(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        float* __restrict__ cum_out,
                        float* __restrict__ states, int L, int H, int nc) {
  using S = SsdMma<T, P, N, CH>;
  constexpr int KT = S::KT, EPC = S::EPC, BP = S::BP, XP = S::XP;
  constexpr int NT = CH / KT, PW = S::PW, NTC = PW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* coef = reinterpret_cast<float*>(smem_raw);  // dt_j exp(last - cum_j)
  float* cum = coef + CH;
  float* wsum = cum + CH;                              // warp totals
  T* Bs = reinterpret_cast<T*>(wsum + 4);              // 2 x KT x BP
  T* Xs = Bs + 2 * KT * BP;                            // 2 x KT x XP

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc, l0 = c * CH;

  auto load_tile = [&](int t, int stage) {
    T* bd = Bs + stage * KT * BP;
    T* xd = Xs + stage * KT * XP;
    for (int i = tid; i < KT * (N / EPC); i += kSsdThreads) {
      const int r = i / (N / EPC), col = i % (N / EPC), l = l0 + t * KT + r;
      const bool ok = l < L;
      cp_async16(bd + r * BP + col * EPC,
                 Bm + ((long long)b * L + (ok ? l : 0)) * N + col * EPC, ok);
    }
    for (int i = tid; i < KT * (P / EPC); i += kSsdThreads) {
      const int r = i / (P / EPC), col = i % (P / EPC), l = l0 + t * KT + r;
      const bool ok = l < L;
      cp_async16(xd + r * XP + col * EPC,
                 x + (((long long)b * L + (ok ? l : 0)) * H + h) * P +
                     col * EPC,
                 ok);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // the in-chunk inclusive scan of dt * A: warp shuffles, then the warps'
  // offsets
  constexpr int kScan = (CH + 31) / 32 * 32;
  float d = 0.f;
  if (tid < kScan) {
    const int l = l0 + tid;
    d = (tid < CH && l < L) ? dt[((long long)b * L + l) * H + h] : 0.f;
    float v = d * A[h];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (tid < CH) cum[tid] = v;
    if (lane == 31) wsum[tid >> 5] = v;
  }
  __syncthreads();
  if (tid < CH) {
    float off = 0.f;
    for (int w = 0; w < (tid >> 5); ++w) off += wsum[w];
    cum[tid] += off;
  }
  __syncthreads();
  if (tid < CH) {
    coef[tid] = d * expf(cum[CH - 1] - cum[tid]);
    cum_out[((long long)bc * H + h) * CH + tid] = cum[tid];
  }

  const int mt = warp % S::MT, cg = warp / S::MT;
  const bool active = cg < S::CG1;
  float acc[NTC][4];
#pragma unroll
  for (int n = 0; n < NTC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int t = 0; t < NT; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed (and coef written); stage t^1 is free
    if (t + 1 < NT) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    if (active)
      mma_atb_scaled<NTC, KT, BP, XP>(
          acc, Bs + (t & 1) * KT * BP + 16 * mt, coef + t * KT,
          Xs + (t & 1) * KT * XP + cg * PW, lane);
  }
  if (!active) return;
  float* out = states + ((long long)bc * H + h) * N * P +
               (16 * mt + (lane >> 2)) * P + cg * PW + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NTC; ++n) {
    store_vec<2>(out + 8 * n, acc[n]);
    store_vec<2>(out + 8 * P + 8 * n, acc[n] + 2);
  }
}

// Stage 3: per (batch, chunk), the (j, i) tile of C B^T (zero for j > i),
// fp32, which the backward reads: a warp 16 rows j by CW columns i, A =
// B's rows, B = C's rows (mma_abt).
template <typename T, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_cb_mma(const T* __restrict__ Bm, const T* __restrict__ Cm,
               float* __restrict__ cbt, int L, int nc) {
  using S = SsdMma<T, 16, N, CH>;  // p does not enter this stage
  constexpr int RT = S::RT, NRT = S::NRT, LP = S::LP, EPC = S::EPC;
  constexpr int CW = S::CW, NTC = CW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Bs = reinterpret_cast<T*>(smem_raw);  // RT x LP: B_j rows
  T* Cs = Bs + RT * LP;                    // RT x LP: C_i rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bc = blockIdx.x / (NRT * NRT), tile = blockIdx.x % (NRT * NRT);
  const int tj = tile / NRT, ti = tile % NRT;
  if (tj > ti) return;  // wholly above the diagonal: never read
  const int b = bc / nc, l0 = (bc % nc) * CH;
  for (int i = tid; i < RT * (N / EPC); i += kSsdThreads) {
    const int r = i / (N / EPC), col = (i % (N / EPC)) * EPC;
    const int lj = l0 + tj * RT + r, li = l0 + ti * RT + r;
    cp_async16(Bs + r * LP + col,
               Bm + ((long long)b * L + (lj < L ? lj : 0)) * N + col, lj < L);
    cp_async16(Cs + r * LP + col,
               Cm + ((long long)b * L + (li < L ? li : 0)) * N + col, li < L);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int mt = warp % (RT / 16), cg = warp / (RT / 16);
  if (cg >= S::CG3) return;
  float acc[NTC][4];
#pragma unroll
  for (int n = 0; n < NTC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  mma_abt<NTC, N, LP, T>(acc, Bs + 16 * mt * LP, Cs + cg * CW * LP, lane);
  const int j = tj * RT + 16 * mt + (lane >> 2);
  const int i = ti * RT + cg * CW + 2 * (lane & 3);
  float* out = cbt + (long long)bc * CH * CH + (long long)j * CH + i;
#pragma unroll
  for (int n = 0; n < NTC; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jr = j + 8 * half, ic = i + 8 * n;
      const float v[2] = {jr <= ic ? acc[n][2 * half] : 0.f,
                          jr <= ic + 1 ? acc[n][2 * half + 1] : 0.f};
      store_vec<2>(out + 8 * half * CH + 8 * n, v);
    }
}

// Stage 4: y for one RT-row tile of a (batch, chunk, head); warp w owns
// its rows [16w, 16w + 16).  First (chunks c > 0) y = exp(cum_i) C_i
// S_in: A = C's rows (fp32: split after the ldmatrix), B = S_in's rows,
// staged by cp.async in fp32 and converted to bf16 as it is staged in
// bf16 (the fp32 scratch stays as it is, for the backward).  Then over
// the key tiles up to the tile's end: y += M' x with M'_ij = (C B^T)_ij
// exp(cum_i - cum_j) dt_j built in registers from the fp32 C B^T tile
// (the decay masked to -1e30 BEFORE the exp on the diagonal 16 x 16
// tiles, the only ones it reaches), times x's rows (mma_acc_a: fp32 in
// split-TF32 a half at a time; bf16 rounded to one A fragment, x read by
// ldmatrix.trans).  A warp skips the key steps wholly past its rows.
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(SsdMma<T, P, N, CH>::kScanThreads,
                                  SsdMma<T, P, N, CH>::kScanBlocks)
    ssd_chunk_scan_mma(const T* __restrict__ x, const T* __restrict__ Cm,
                       const float* __restrict__ dt,
                       const float* __restrict__ cum_in,
                       const float* __restrict__ states,
                       const float* __restrict__ cbt, T* __restrict__ y,
                       int L, int H, int nc) {
  using S = SsdMma<T, P, N, CH>;
  constexpr int KT = S::KT, RT = S::RT, NRT = S::NRT, EPC = S::EPC;
  constexpr int LP = S::LP, XP = S::XP, YP = S::YP, MP = S::MP;
  constexpr int NTH = S::kScanThreads, NTP = P / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // CH
  float* dts = cum + CH;                            // CH
  unsigned char* region = reinterpret_cast<unsigned char*>(dts + CH);
  T* Sb = reinterpret_cast<T*>(region);  // N x XP: S_in (n x p)
  T* Cs = Sb + N * XP;                   // RT x LP: the tile's C rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int rt = blockIdx.x % NRT, bch = blockIdx.x / NRT;
  const int h = bch % H, bc = bch / H, c = bc % nc, b = bc / nc;
  const int l0 = c * CH, i0 = rt * RT, r0 = 16 * warp;
  const int ia = i0 + r0 + g, ib = ia + 8;  // the thread's chunk rows
  const int NK = (i0 + RT) / KT;            // key tiles up to the tile's end

  auto load_keys = [&](int t, int stage) {
    float* md = reinterpret_cast<float*>(region + stage * S::kKeyStage);
    T* xd = reinterpret_cast<T*>(md + KT * MP);
    const int j0 = t * KT;
    for (int q = tid; q < KT * (RT / 4); q += NTH) {
      const int r = q / (RT / 4), col = 4 * (q % (RT / 4));
      cp_async16(md + r * MP + col,
                 cbt + ((long long)bc * CH + j0 + r) * CH + i0 + col, true);
    }
    for (int q = tid; q < KT * (P / EPC); q += NTH) {
      const int r = q / (P / EPC), col = (q % (P / EPC)) * EPC;
      const int l = l0 + j0 + r;
      const bool ok = l < L;
      cp_async16(xd + r * YP + col,
                 x + (((long long)b * L + (ok ? l : 0)) * H + h) * P + col,
                 ok);
    }
  };

  for (int j = tid; j < CH; j += NTH) {
    const int l = l0 + j;
    cum[j] = cum_in[(long long)bch * CH + j];
    dts[j] = l < L ? dt[((long long)b * L + l) * H + h] : 0.f;
  }
  float acc[NTP][4];
#pragma unroll
  for (int n = 0; n < NTP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if (c > 0) {  // the first chunk's S_in is zero
    for (int q = tid; q < RT * (N / EPC); q += NTH) {
      const int r = q / (N / EPC), col = (q % (N / EPC)) * EPC;
      const int l = l0 + i0 + r;
      const bool ok = l < L;
      cp_async16(Cs + r * LP + col,
                 Cm + ((long long)b * L + (ok ? l : 0)) * N + col, ok);
    }
    stage_state<N, P, XP, NTH>(Sb, states + (long long)bch * N * P);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // C rows, S_in, cum and dts in place
    if constexpr (S::kFp32) {
      const float* sr = Sb + (lane & 3) * XP + g;  // rows t, t + 4
#pragma unroll 4
      for (int ks = 0; ks < N / 8; ++ks) {
        unsigned ahi[4], alo[4];
        frag_a<LP>(ahi, alo, Cs + r0 * LP, 8 * ks, lane);
        const float* s0 = sr + 8 * ks * XP;
#pragma unroll
        for (int n = 0; n < NTP; ++n)
          mma_3xtf32(acc[n], ahi, alo, split_tf32(s0[8 * n]),
                     split_tf32(s0[4 * XP + 8 * n]));
      }
    } else {
      const T* ca = Cs + (r0 + (lane & 15)) * LP + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        unsigned af[1][4];
        ldsm4(af[0], ca + 16 * ks);
        mma_ab<NTP, 1, XP>(acc, af, Sb + 16 * ks * XP, lane);
      }
    }
    const float ea = expf(cum[ia]), eb = expf(cum[ib]);
#pragma unroll
    for (int n = 0; n < NTP; ++n) {
      acc[n][0] *= ea;
      acc[n][1] *= ea;
      acc[n][2] *= eb;
      acc[n][3] *= eb;
    }
    __syncthreads();  // C rows and S_in consumed: the key tiles' bytes
  }

  load_keys(0, 0);
  cp_async_commit();
  for (int t = 0; t < NK; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed (cum, dts written); stage t^1 is free
    if (t + 1 < NK) load_keys(t + 1, (t + 1) & 1);
    cp_async_commit();
    const float* md =
        reinterpret_cast<const float*>(region + (t & 1) * S::kKeyStage);
    const T* xd = reinterpret_cast<const T*>(md + KT * MP);
    const float cia = cum[ia], cib = cum[ib];
#pragma unroll
    for (int s = 0; s < KT / 16; ++s) {
      const int jj = t * KT + 16 * s;  // the key step's first row
      if (jj > i0 + r0) break;         // wholly past the warp's rows
      const bool diag = jj == i0 + r0;
      float m[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = jj + 8 * half + t2;  // columns j, j + 1
        const float2 cj = ld2(cum + j), dj = ld2(dts + j);
        const float* mr = md + (j - t * KT) * MP + ia - i0;
        // (ia, j), (ia, j+1), (ib, j), (ib, j+1): masked where j > i
        const float s0 = !diag || j <= ia ? cia - cj.x : kSsdMask;
        const float s1 = !diag || j + 1 <= ia ? cia - cj.y : kSsdMask;
        const float s2 = !diag || j <= ib ? cib - cj.x : kSsdMask;
        const float s3 = !diag || j + 1 <= ib ? cib - cj.y : kSsdMask;
        m[half][0] = mr[0] * __expf(s0) * dj.x;
        m[half][1] = mr[MP] * __expf(s1) * dj.y;
        m[half][2] = mr[8] * __expf(s2) * dj.x;
        m[half][3] = mr[MP + 8] * __expf(s3) * dj.y;
        mma_acc_a<NTP, YP>(acc, m, half, xd + 16 * s * YP, lane);
      }
    }
  }
  const int la = l0 + ia, lb = l0 + ib;
#pragma unroll
  for (int n = 0; n < NTP; ++n) {
    const int col = 8 * n + t2;
    if (la < L)
      store_vec<2>(y + (((long long)b * L + la) * H + h) * P + col, acc[n]);
    if (lb < L)
      store_vec<2>(y + (((long long)b * L + lb) * H + h) * P + col,
                   acc[n] + 2);
  }
}

// The four stages, in order, on `stream`; the error of the first launch
// that fails, else cudaGetLastError() after the last.
template <typename T, int P, int N, int CH>
cudaError_t launch_ssd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* state,
                       void* cum, void* states, void* cbt, int batch, int L,
                       int H, int device, cudaStream_t stream) {
  using S = SsdShape<P, N, CH>;
  using M = SsdMma<T, P, N, CH>;
  cudaError_t err;
  const int nc = (L + CH - 1) / CH;
  const T *xp = static_cast<const T*>(x), *bp = static_cast<const T*>(B),
          *cp = static_cast<const T*>(C);
  const float *dtp = static_cast<const float*>(dt),
              *ap = static_cast<const float*>(A);
  float *cump = static_cast<float*>(cum), *stp = static_cast<float*>(states),
        *cbtp = static_cast<float*>(cbt);
  if ((err = allow_smem_once<ssd_chunk_state_mma<T, P, N, CH>>(
           M::kStateSmem, device)) != cudaSuccess ||
      (err = allow_smem_once<ssd_cb_mma<T, N, CH>>(M::kCbSmem, device)) !=
          cudaSuccess ||
      (err = allow_smem_once<ssd_chunk_scan_mma<T, P, N, CH>>(
           M::kScanSmem, device)) != cudaSuccess)
    return err;
  ssd_chunk_state_mma<T, P, N, CH><<<batch * nc * H, kSsdThreads,
                                     M::kStateSmem, stream>>>(
      xp, dtp, ap, bp, cump, stp, L, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass<P, N, CH><<<dim3(batch * H, N / S::R2), kSsdThreads, 0,
                             stream>>>(cump, stp, static_cast<float*>(state),
                                       H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_cb_mma<T, N, CH><<<batch * nc * M::NRT * M::NRT, kSsdThreads,
                         M::kCbSmem, stream>>>(bp, cp, cbtp, L, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan_mma<T, P, N, CH><<<batch * nc * H * M::NRT, M::kScanThreads,
                                    M::kScanSmem, stream>>>(
      xp, cp, dtp, cump, stp, cbtp, static_cast<T*>(y), L, H, nc);
  return cudaGetLastError();
}

// The (p, n, chunk) shapes instantiated; keep in step with SSD_SHAPES in
// repro_torch/kernels/ops.py.  X(p, n, chunk) is expanded once per shape.
#define GFDIT_SSD_SHAPES(X) \
  X(64, 128, 128) /* mamba2-1.3b at full width */ \
  X(16, 16, 16)   /* mamba2-1.3b.reduced() */ \
  X(16, 16, 32)   /* the JAX package's kernel sweep */ \
  X(32, 16, 64) \
  X(64, 32, 128) \
  X(64, 64, 128)  /* zamba2-7b at full width */

template <typename T>
cudaError_t dispatch_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* state,
                         void* cum, void* states, void* cbt, int batch, int L,
                         int H, int P, int N, int chunk, int device,
                         cudaStream_t s) {
#define GFDIT_SSD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) \
    return launch_ssd<T, p, n, c>(x, dt, A, B, C, y, state, cum, states, \
                                  cbt, batch, L, H, device, s);
  GFDIT_SSD_SHAPES(GFDIT_SSD_CASE)
#undef GFDIT_SSD_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int P, int N, int CH>
cudaError_t occupancy_ssd(int stage, int batch, int L, int H, int device,
                          int* blocks_per_sm, int* smem_bytes, int* grid,
                          int* threads) {
  using S = SsdShape<P, N, CH>;
  using M = SsdMma<T, P, N, CH>;
  const int nc = (L + CH - 1) / CH;
  *threads = kSsdThreads;
  switch (stage) {
    case 0:
      *grid = batch * nc * H;
      return occupancy_of<ssd_chunk_state_mma<T, P, N, CH>>(
          M::kStateSmem, kSsdThreads, device, blocks_per_sm, smem_bytes);
    case 1:
      *grid = batch * H * (N / S::R2);
      *smem_bytes = static_cast<int>(sizeof(float) * S::R2 * (P + 1));
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, ssd_state_pass<P, N, CH>, kSsdThreads, 0);
    case 2:  // the blocks above the diagonal return at once
      *grid = batch * nc * M::NRT * M::NRT;
      return occupancy_of<ssd_cb_mma<T, N, CH>>(
          M::kCbSmem, kSsdThreads, device, blocks_per_sm, smem_bytes);
    case 3:
      *grid = batch * nc * H * M::NRT;
      *threads = M::kScanThreads;
      return occupancy_of<ssd_chunk_scan_mma<T, P, N, CH>>(
          M::kScanSmem, M::kScanThreads, device, blocks_per_sm, smem_bytes);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_occupancy(int stage, int batch, int L, int H, int P,
                               int N, int chunk, int device,
                               int* blocks_per_sm, int* smem_bytes,
                               int* grid, int* threads) {
#define GFDIT_SSD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) \
    return occupancy_ssd<T, p, n, c>(stage, batch, L, H, device, \
                                     blocks_per_sm, smem_bytes, grid, \
                                     threads);
  GFDIT_SSD_SHAPES(GFDIT_SSD_CASE)
#undef GFDIT_SSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace gfdit

// x/y: (batch, L, H, P) and B/C: (batch, L, N), all of one dtype; dt:
// (batch, L, H) and A: (H,) fp32; state: (batch, H, P, N) fp32 output.
// Scratch, fp32, nc = ceil(L / chunk): cum (batch, nc, H, chunk), states
// (batch, nc, H, N, P), cbt (batch, nc, chunk, chunk).  x, B, C, y and
// every scratch buffer 16-byte aligned (cp.async, vector stores).
extern "C" int gfdit_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* state,
                         void* cum, void* states, void* cbt, int batch, int L,
                         int H, int P, int N, int chunk, int dtype,
                         int device, void* stream) {
  using namespace gfdit;
  if (batch <= 0 || L <= 0 || H <= 0) return cudaErrorInvalidValue;
  const void* copied[] = {x, B, C, y, cum, states, cbt};
  for (const void* p : copied)
    if (reinterpret_cast<unsigned long long>(p) & 15)
      return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_ssd<float>(x, dt, A, B, C, y, state, cum, states, cbt,
                               batch, L, H, P, N, chunk, device, s);
  if (dtype == kBFloat16)
    return dispatch_ssd<__nv_bfloat16>(x, dt, A, B, C, y, state, cum, states,
                                       cbt, batch, L, H, P, N, chunk, device,
                                       s);
  return cudaErrorInvalidValue;
}

// Occupancy of one stage kernel of the (P, N, chunk) instantiation (0
// ssd_chunk_state_mma, the chunk states; 1 ssd_state_pass; 2 ssd_cb_mma,
// C B^T; 3 ssd_chunk_scan_mma) in `dtype` at (batch, L, H): resident
// blocks per SM, shared-memory bytes a block, the launch's grid and its
// threads a block.
extern "C" int gfdit_ssd_occupancy(int stage, int batch, int L, int H, int P,
                                   int N, int chunk, int dtype, int device,
                                   int* blocks_per_sm, int* smem_bytes,
                                   int* grid, int* threads) {
  using namespace gfdit;
  if (batch <= 0 || L <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (dtype == kFloat32)
    return dispatch_occupancy<float>(stage, batch, L, H, P, N, chunk, device,
                                     blocks_per_sm, smem_bytes, grid,
                                     threads);
  if (dtype == kBFloat16)
    return dispatch_occupancy<__nv_bfloat16>(stage, batch, L, H, P, N, chunk,
                                             device, blocks_per_sm,
                                             smem_bytes, grid, threads);
  return cudaErrorInvalidValue;
}
