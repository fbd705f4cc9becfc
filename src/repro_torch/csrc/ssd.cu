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
//   1. ssd_chunk_state (bf16: ssd_chunk_state_mma), a block per (batch,
//      chunk, head): cum (to scratch) and the chunk-local state S_c =
//      sum_j exp(cum_last - cum_j) xb_j (x) B_j, stored transposed (n x
//      p) in a chunk-state scratch;
//   2. ssd_state_pass, a block per (batch, head, n-row tile): walks the
//      chunks in order, S_in[0] = 0, S_in[c+1] = exp(cum_last_c) S_in[c]
//      + S_c, overwriting the scratch with each chunk's S_in; writes the
//      final state (p x n);
//   3. ssd_cb (bf16: ssd_cb_mma), a block per (batch, chunk, tile of the
//      causal triangle): C B^T once for all heads (B and C have one
//      group), stored transposed (j, i), and (fp32) C^T of the chunk;
//   4. ssd_chunk_scan (bf16: ssd_chunk_scan_mma), a block per (batch,
//      chunk, head, 64-row tile): y.
// B and C are read from the shared (b, l, n) arrays, never copied per
// head.  A ragged last chunk is masked here: rows past l load dt = x = B
// = C = 0, which leaves cum and the state as they are, and are not
// written, so callers need not pad.
//
// Bound on the card: operations.  The function needs, per (batch, chunk)
// of c rows, the causal C B^T once, c(c+1)/2 n multiply-adds, and per
// head the causal scores . xb, c(c+1)/2 p, C . state, c p n (none in the
// first chunk), and the state update, c p n: 21.1 GFLOP at the
// full-width mamba2-1.3b prefill (b=4, l=2048, h=64, p=64, n=128,
// c=128; chip_smoke.ssd_flops), 0.315 ms at the 67 TFLOP/s fp32
// CUDA-core rate of an H100 SXM, against ~287 MB of x, y, dt, B, C and
// the state (0.086 ms at 3.35 TB/s).  These kernels do 23.3 GFLOP, 1.10x
// the need: stage 1 8.59 (the state update), stage 4 8.05 (C . S_in) and
// 6.44 (scores . xb over whole 32-row key tiles up to each 64-row tile's
// end, not the exact triangle), stage 3 0.20.  The single-kernel design
// before did 33.3, recomputing C B^T for every head.
// Scratch (one allocation by the wrapper, none here), at that shape:
// chunk states b*nc*h*n*p fp32, 134.2 MB; cum b*nc*h*c, 2.1 MB; C B^T and C^T
// b*nc*c*c and b*nc*n*c, 4.2 MB each: 144.7 MB, which stays in HBM (the
// chunk states) and L2 (the rest).  The state traffic (stage 1 writes,
// stage 2 reads and writes, stage 4 reads: 0.54 GB) is ~0.16 ms at the
// DRAM rate.
//
// Design.  The dtype chooses the stage kernels of stages 1, 3 and 4;
// stage 2 (ssd_state_pass) is one fp32 walk over the chunks for both.
//
// bf16 operands (intra_dtype="bfloat16", the JAX package's ssd_bf16
// variant): ssd_chunk_state_mma, ssd_cb_mma and ssd_chunk_scan_mma run
// their products on the tensor cores, mma.sync m16n8k16 on bf16 operands
// into fp32 accumulators, through mma.cuh's helpers, as templates over
// the operand type (fp32 in split-TF32 is their other instance, not
// written yet).  They round where JAX's ssd_chunked at bf16 rounds, at
// comparable points: stage 1 scales B's row j by w_j = dt_j exp(cum_last
// - cum_j) in registers and rounds it once (x enters as the bf16 it is;
// JAX rounds the decay and keeps x dt in fp32); stage 4 builds M'_ij =
// (C B^T)_ij exp(cum_i - cum_j) dt_j from the fp32 C B^T tile and rounds
// it to bf16 A fragments (JAX rounds the scores and the decay apart), and
// takes S_in in bf16, converted as it is staged (JAX rounds prev_states);
// every sum is fp32 (tests/test_torch_ssd_bf16.py models each rounding).
//   * Stage 1, a block per (batch, chunk, head) of 8 warps, a warp a 16 x
//     PW tile of S_c^T: A = B's rows by ldmatrix.trans (mma_atb_scaled),
//     B = x's rows; 32-row key tiles by cp.async in two stages.
//   * Stage 3, a block per (batch, chunk, 64 x 64 tile of the causal
//     triangle), a warp 16 rows j by 32 columns i: A = B's rows, B = C's
//     (mma_abt), written as fp32 (j, i) tiles, which the backward reads;
//     C^T is not written.
//   * Stage 4, a block per (batch, chunk, head, 64-row tile) of 4 warps, a
//     warp its 16 rows: first C S_in over n (A = C's rows, B = S_in), then
//     exp(cum_i) times that, then the key tiles up to the tile's end
//     (C B^T's (j, i) tile in fp32 and x's rows, double-buffered over the
//     C S_in operands' bytes); a warp skips the 16-row key steps wholly
//     past its rows, and masks the decay before the exp on its diagonal
//     step only.  At (64, 128, 128): 36 KB of shared memory; the launch
//     bounds hold it to 96 registers, 5 blocks an SM (116 and 4 without:
//     2% slower), and stage 1 to 64 registers, 4 blocks an SM.
//   * Executed at the mamba2-1.3b prefill: 21.7 GFLOP, 1.03x the need
//     (stage 1 8.59, stage 4 8.05 for C . S_in and 4.83 for the scores
//     over whole 16-row key steps, stage 3 0.20), at the tensor cores'
//     rate; the bound is bytes (0.044 ms), and the design's own floor, the
//     fp32 chunk states above, 0.21 ms (PERF.md).
//
// fp32 operands (the default intra_dtype): fp32 arithmetic on the CUDA
// cores, as the TPU kernel's, because TF32 keeps ~1e-3 against K4's 1e-4
// budget, so fp32 accuracy on the tensor cores needs split-TF32 (three
// TF32 products per fp32 one), the bf16 templates' other instance.
// Every fp32 stage is a 256-thread block, a 16 x 16 thread grid (ty, tx).
// Stages 1 and 4 are register-blocked outer products: a thread owns TM
// contiguous rows (ty*TM..) and TN contiguous columns (tx*TN..) of its
// output tile, and per step of the contraction reads its rows' TM values
// and its columns' TN values from one shared row each as vector loads
// (float4; 8 bytes in bf16): in a warp the 16 tx lanes read 256
// consecutive bytes (two wavefronts) and the 2 ty values are two
// addresses, so at (64, 128, 128) stage 1 issues 32 FMAs a thread per 3
// loads and 4 wavefronts, stage 4 16 per 2 loads and 3 wavefronts.  Both
// contraction operands of each product are laid out with the contracted
// index as the row, which is why the chunk states are kept n x p and
// stage 3 writes C B^T as (j, i) and C^T.  K-tiles of 32 rows come by
// 16-byte cp.async into two shared stages: tile t+1 is in flight while
// tile t is computed, one block barrier a tile (stage 4 adds one for the
// decay).  Stage 1 scales xb by its decay weight as it reads it; stage 4
// turns each C B^T tile into the decay-weighted score tile in place,
// masking the decay to -1e30 BEFORE the exp (the upper triangle's
// cum_i - cum_j is positive and its exp can overflow fp32: inf * 0 =
// NaN), skips key tiles wholly past its last row and, in the first chunk,
// the C . S_in term.  Stage 3 is a dot-product tile (16-byte reads along
// n, rows padded by 4 floats, so the 16 column lanes hit distinct banks).
// Shared memory at (64, 128, 128) fp32: stage 1 49.0 KB, stage 3 66.0 KB,
// stage 4 33.0 KB, stage 2 4.1 KB (static).  Launch bounds hold stage 1
// to 3 blocks an SM (80 registers) and stage 4 to 4 (64 registers, which
// spills 8 bytes in fp32: faster than 3 blocks at 80 with no spill).
#include "mma.cuh"

#include <type_traits>

namespace gfdit {

constexpr int kSsdThreads = 256;  // every stage but bf16's stage 4
constexpr float kSsdMask = -1e30f;

template <typename T, int P, int N, int CH>
struct SsdShape {
  static_assert(P % 16 == 0 && N % 16 == 0 && CH % 16 == 0 && P <= 64 &&
                    N <= 128 && CH <= 128,
                "ssd: p, n and chunk must be multiples of 16, p at most 64, "
                "n and chunk at most 128");
  static constexpr int KT = CH < 32 ? CH : 32;  // rows of a K-tile
  static constexpr int KA = KT < N ? KT : N;    // ... of a C^T / S_in tile
  static constexpr int RT = CH < 64 ? CH : 64;  // rows of a y or CB tile
  static constexpr int NRT = CH / RT;
  static constexpr int EPC = 16 / sizeof(T);    // elements a 16-byte copy
  // stage 2: n-rows of the state a block walks (4 floats a thread)
  static constexpr int R2 = N < 4 * kSsdThreads / P ? N : 4 * kSsdThreads / P;
  // dynamic shared memory, bytes
  static constexpr size_t kStateSmem =
      sizeof(float) * (2 * CH + 4) + sizeof(T) * 2 * KT * (N + P);
  static constexpr size_t kCbSmem = sizeof(float) * 2 * RT * (N + 4);
  static constexpr size_t kScanSmem =
      sizeof(float) * (2 * CH + 2 * KT * (RT + P));
};

// Stage 1: cum and the chunk-local state, transposed (n x p).
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads, 3)
    ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    float* __restrict__ cum_out, float* __restrict__ states,
                    int L, int H, int nc) {
  using S = SsdShape<T, P, N, CH>;
  constexpr int KT = S::KT, EPC = S::EPC, NT = CH / KT;
  constexpr int TM = N / 16, TN = P / 16;  // n-rows, p-columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* coef = reinterpret_cast<float*>(smem_raw);  // dt_j exp(last - cum_j)
  float* cum = coef + CH;
  float* wsum = cum + CH;                              // warp totals
  T* Bs = reinterpret_cast<T*>(wsum + 4);              // 2 x KT x N
  T* Xs = Bs + 2 * KT * N;                             // 2 x KT x P

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc, l0 = c * CH;

  auto load_tile = [&](int t, int stage) {
    T* bd = Bs + stage * KT * N;
    T* xd = Xs + stage * KT * P;
    for (int i = tid; i < KT * (N / EPC); i += kSsdThreads) {
      const int r = i / (N / EPC), col = i % (N / EPC), l = l0 + t * KT + r;
      const bool ok = l < L;
      cp_async16(bd + r * N + col * EPC,
                 Bm + ((long long)b * L + (ok ? l : 0)) * N + col * EPC, ok);
    }
    for (int i = tid; i < KT * (P / EPC); i += kSsdThreads) {
      const int r = i / (P / EPC), col = i % (P / EPC), l = l0 + t * KT + r;
      const bool ok = l < L;
      cp_async16(xd + r * P + col * EPC,
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
    const int lane = tid & 31;
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

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < TN; ++e) acc[i][e] = 0.f;
  for (int t = 0; t < NT; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed (and coef written); stage t^1 is free
    if (t + 1 < NT) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    const T* bt = Bs + (t & 1) * KT * N + ty * TM;
    const T* xt = Xs + (t & 1) * KT * P + tx * TN;
    const float* ct = coef + t * KT;
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float bv[TM], xv[TN];
      load_vec<TM>(bt + j * N, bv);
      load_vec<TN>(xt + j * P, xv);
      const float w = ct[j];
#pragma unroll
      for (int e = 0; e < TN; ++e) xv[e] *= w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int e = 0; e < TN; ++e) acc[i][e] = fmaf(bv[i], xv[e], acc[i][e]);
    }
  }
  float* out = states + ((long long)bc * H + h) * N * P;
#pragma unroll
  for (int i = 0; i < TM; ++i) store_vec<TN>(out + (ty * TM + i) * P + tx * TN,
                                             acc[i]);
}

// Stage 2: the pass of states across chunks, in place; the final state.
template <int P, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_state_pass(const float* __restrict__ cum, float* __restrict__ states,
                   float* __restrict__ state_out, int H, int nc) {
  constexpr int R2 = SsdShape<float, P, N, CH>::R2;
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

// Stage 3: per (batch, chunk), the (j, i) tile of C B^T (zero for j > i),
// and, from the blocks of the first key-row tile, C^T (n x c).
template <typename T, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
           float* __restrict__ cbt, float* __restrict__ ct, int L, int nc) {
  using S = SsdShape<T, 16, N, CH>;  // p does not enter this stage
  constexpr int RT = S::RT, NRT = S::NRT, PITCH = N + 4, MR = RT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Bs = reinterpret_cast<float*>(smem_raw);  // RT x PITCH: B_j rows
  float* Cs = Bs + RT * PITCH;                     // RT x PITCH: C_i rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bc = blockIdx.x / (NRT * NRT), tile = blockIdx.x % (NRT * NRT);
  const int tj = tile / NRT, ti = tile % NRT;
  if (tj > ti) return;  // wholly above the diagonal: never read
  const int b = bc / nc, l0 = (bc % nc) * CH;
  for (int i = tid; i < RT * N; i += kSsdThreads) {
    const int r = i / N, k = i % N;
    const int lj = l0 + tj * RT + r, li = l0 + ti * RT + r;
    Bs[r * PITCH + k] =
        lj < L ? to_float(Bm[((long long)b * L + lj) * N + k]) : 0.f;
    Cs[r * PITCH + k] =
        li < L ? to_float(Cm[((long long)b * L + li) * N + k]) : 0.f;
  }
  __syncthreads();
  if (tj == 0) {  // C^T rows k, columns i of this tile (coalesced writes)
    float* out = ct + (long long)bc * N * CH + ti * RT;
    for (int i = tid; i < RT * N; i += kSsdThreads)
      out[(i / RT) * CH + i % RT] = Cs[(i % RT) * PITCH + i / RT];
  }
  // rows j = ty + 16a, columns i = tx + 16e
  float acc[MR][MR];
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int e = 0; e < MR; ++e) acc[a][e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < N; k += 4) {
    float4 bv[MR], cv[MR];
#pragma unroll
    for (int a = 0; a < MR; ++a) bv[a] = ld4(Bs + (ty + 16 * a) * PITCH + k);
#pragma unroll
    for (int e = 0; e < MR; ++e) cv[e] = ld4(Cs + (tx + 16 * e) * PITCH + k);
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int e = 0; e < MR; ++e) {
        float v = acc[a][e];
        v = fmaf(bv[a].x, cv[e].x, v);
        v = fmaf(bv[a].y, cv[e].y, v);
        v = fmaf(bv[a].z, cv[e].z, v);
        v = fmaf(bv[a].w, cv[e].w, v);
        acc[a][e] = v;
      }
  }
  float* out = cbt + (long long)bc * CH * CH;
#pragma unroll
  for (int a = 0; a < MR; ++a) {
    const int j = tj * RT + ty + 16 * a;
#pragma unroll
    for (int e = 0; e < MR; ++e) {
      const int i = ti * RT + tx + 16 * e;
      out[j * CH + i] = j <= i ? acc[a][e] : 0.f;
    }
  }
}

// Stage 4: y for one 64-row tile of a (batch, chunk, head).
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads, 4)
    ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ cum_in,
                   const float* __restrict__ states,
                   const float* __restrict__ cbt, const float* __restrict__ ct,
                   T* __restrict__ y, int L, int H, int nc) {
  using S = SsdShape<T, P, N, CH>;
  constexpr int KT = S::KT, KA = S::KA, RT = S::RT, NRT = S::NRT;
  constexpr int EPC = S::EPC, STAGE = KT * (RT + P);
  constexpr int TM = RT / 16, TN = P / 16;  // rows, p-columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // CH
  float* dts = cum + CH;                            // CH
  float* buf = dts + CH;  // 2 stages x (KT x RT scores, KT x P S_in or x)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rt = blockIdx.x % NRT, bch = blockIdx.x / NRT;
  const int h = bch % H, bc = bch / H, c = bc % nc, b = bc / nc;
  const int l0 = c * CH, i0 = rt * RT;
  // tiles: C^T / S_in over n (none in the first chunk, whose S_in is 0),
  // then C B^T / x over the key rows up to the tile's last row
  const int NA = c > 0 ? N / KA : 0;
  const int NT = NA + (i0 + RT) / KT;
  const float* s_in = states + (long long)bch * N * P;

  auto load_tile = [&](int t, int stage) {
    float* md = buf + stage * STAGE;
    float* vd = md + KT * RT;
    if (t < NA) {
      const int k0 = t * KA;
      for (int i = tid; i < KA * RT / 4; i += kSsdThreads) {
        const int r = i / (RT / 4), col = i % (RT / 4);
        cp_async16(md + r * RT + col * 4,
                   ct + ((long long)bc * N + k0 + r) * CH + i0 + col * 4,
                   true);
      }
      for (int i = tid; i < KA * P / 4; i += kSsdThreads) {
        const int r = i / (P / 4), col = i % (P / 4);
        cp_async16(vd + r * P + col * 4, s_in + (k0 + r) * P + col * 4, true);
      }
    } else {
      const int j0 = (t - NA) * KT;
      for (int i = tid; i < KT * RT / 4; i += kSsdThreads) {
        const int r = i / (RT / 4), col = i % (RT / 4);
        cp_async16(md + r * RT + col * 4,
                   cbt + ((long long)bc * CH + j0 + r) * CH + i0 + col * 4,
                   true);
      }
      T* xd = reinterpret_cast<T*>(vd);
      for (int i = tid; i < KT * (P / EPC); i += kSsdThreads) {
        const int r = i / (P / EPC), col = i % (P / EPC), l = l0 + j0 + r;
        const bool ok = l < L;
        cp_async16(xd + r * P + col * EPC,
                   x + (((long long)b * L + (ok ? l : 0)) * H + h) * P +
                       col * EPC,
                   ok);
      }
    }
  };
  load_tile(0, 0);
  cp_async_commit();
  for (int j = tid; j < CH; j += kSsdThreads) {
    const int l = l0 + j;
    cum[j] = cum_in[(long long)bch * CH + j];
    dts[j] = l < L ? dt[((long long)b * L + l) * H + h] : 0.f;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < TN; ++e) acc[i][e] = 0.f;
  for (int t = 0; t < NT; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed (cum, dts written); stage t^1 is free
    if (t + 1 < NT) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    float* md = buf + (t & 1) * STAGE;
    const float* vd = md + KT * RT;
    if (t < NA) {  // C_i . S_in: rows k of C^T and of S_in^T
#pragma unroll 4
      for (int k = 0; k < KA; ++k) {
        float cv[TM], sv[TN];
        load_vec<TM>(md + k * RT + ty * TM, cv);
        load_vec<TN>(vd + k * P + tx * TN, sv);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < TN; ++e) acc[i][e] = fmaf(cv[i], sv[e], acc[i][e]);
      }
      continue;
    }
    if (t == NA && NA > 0) {  // the carried term times exp(cum_i)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float e_i = expf(cum[i0 + ty * TM + i]);
#pragma unroll
        for (int e = 0; e < TN; ++e) acc[i][e] *= e_i;
      }
    }
    // scores: (C B^T)_ji exp(cum_i - cum_j) dt_j, in place; the decay is
    // masked before the exp
    const int j0 = (t - NA) * KT;
    for (int q = tid; q < KT * RT; q += kSsdThreads) {
      const int j = j0 + q / RT, i = i0 + q % RT;
      const float seg = j <= i ? cum[i] - cum[j] : kSsdMask;
      md[q] *= expf(seg) * dts[j];
    }
    __syncthreads();
    const T* xt = reinterpret_cast<const T*>(vd) + tx * TN;
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float mv[TM], xv[TN];
      load_vec<TM>(md + j * RT + ty * TM, mv);
      load_vec<TN>(xt + j * P, xv);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int e = 0; e < TN; ++e) acc[i][e] = fmaf(mv[i], xv[e], acc[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int l = l0 + i0 + ty * TM + i;
    if (l < L)
      store_vec<TN>(y + (((long long)b * L + l) * H + h) * P + tx * TN,
                    acc[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16: stages 1, 3 and 4 on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// Tiles, warps and shared memory of the tensor-core stages; pitches in
// elements.  Every bf16 row that ldmatrix reads is a whole number of 16-
// byte units at a pitch of 8 more elements, so the 8 rows of one matrix
// start on distinct 4-word bank groups.
template <typename T, int P, int N, int CH>
struct SsdMma {
  static_assert(std::is_same_v<T, bf16>,
                "ssd: the tensor-core stages take bf16 operands; fp32 in "
                "split-TF32 is their other instance, not written yet");
  static_assert(P % 16 == 0 && N % 16 == 0 && CH % 16 == 0 && P <= 64 &&
                    N <= 128 && CH <= 128,
                "ssd: p, n and chunk must be multiples of 16, p at most 64, "
                "n and chunk at most 128");
  static constexpr int KT = CH < 32 ? CH : 32;  // rows of a key tile
  static constexpr int RT = CH < 64 ? CH : 64;  // rows of a y or C B^T tile
  static constexpr int NRT = CH / RT;
  static constexpr int EPC = 16 / sizeof(T);    // elements a 16-byte copy
  static constexpr int BP = N + 8;   // B, C rows
  static constexpr int XP = P + 8;   // x rows, and S_in's (n x p) rows
  static constexpr int MP = RT + 4;  // C B^T (j, i) rows, fp32: the rows
                                     // 2t of a quad lie 8 banks apart
  // stage 1: a warp a tile of 16 state rows (n) by PW columns (p)
  static constexpr int MT = N / 16;
  static constexpr int CG1 = cmin(cmax(kSsdThreads / 32 / MT, 1), P / 16);
  static constexpr int PW = P / CG1;
  static constexpr size_t kStateSmem =
      sizeof(float) * (2 * CH + 4) + sizeof(T) * 2 * KT * (BP + XP);
  // stage 3: a warp 16 rows j by CW columns i of the RT x RT tile
  static constexpr int CG3 = cmin(kSsdThreads / 32 / (RT / 16), RT / 16);
  static constexpr int CW = RT / CG3;
  static constexpr size_t kCbSmem = sizeof(T) * 2 * RT * BP;
  // stage 4: a warp 16 rows of the RT-row tile; C S_in first (S_in in
  // bf16, the tile's C rows), then double-buffered key tiles (C B^T's
  // (j, i) tile, fp32, and x rows) over the same bytes
  static constexpr int kScanThreads = 32 * (RT / 16);
  static constexpr size_t kKeyStage =
      sizeof(float) * KT * MP + sizeof(T) * KT * XP;
  static constexpr size_t kScanSmem =
      sizeof(float) * 2 * CH +
      cmax(sizeof(T) * (N * XP + RT * BP), 2 * kKeyStage);
};

// Stage 1, bf16: cum, and S_c^T = sum_j (w_j B_j)^T (x) x_j with w_j = dt_j
// exp(cum_last - cum_j), (n x p), fp32.  A warp a 16 x PW tile of S_c^T:
// A = B's tile rows by ldmatrix.trans, each row j scaled by w_j in
// registers before it is rounded back to bf16 (x enters as the bf16 it
// is: one rounding, where a bf16 x dt would give two); B = x's rows.
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads, 4)
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

  // the in-chunk inclusive scan of dt * A, as ssd_chunk_state's
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
      mma_atb_scaled<NTC, KT / 16, BP, XP>(
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

// Stage 3, bf16: per (batch, chunk), the (j, i) tile of C B^T (zero for
// j > i), fp32, as ssd_cb writes it (the backward reads it): a warp 16
// rows j by CW columns i, A = B's rows, B = C's rows (mma_abt).  C^T is
// not written: the bf16 stage 4 reads C's rows.
template <typename T, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_cb_mma(const T* __restrict__ Bm, const T* __restrict__ Cm,
               float* __restrict__ cbt, int L, int nc) {
  using S = SsdMma<T, 16, N, CH>;  // p does not enter this stage
  constexpr int RT = S::RT, NRT = S::NRT, BP = S::BP, EPC = S::EPC;
  constexpr int CW = S::CW, NTC = CW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Bs = reinterpret_cast<T*>(smem_raw);  // RT x BP: B_j rows
  T* Cs = Bs + RT * BP;                    // RT x BP: C_i rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bc = blockIdx.x / (NRT * NRT), tile = blockIdx.x % (NRT * NRT);
  const int tj = tile / NRT, ti = tile % NRT;
  if (tj > ti) return;  // wholly above the diagonal: never read
  const int b = bc / nc, l0 = (bc % nc) * CH;
  for (int i = tid; i < RT * (N / EPC); i += kSsdThreads) {
    const int r = i / (N / EPC), col = (i % (N / EPC)) * EPC;
    const int lj = l0 + tj * RT + r, li = l0 + ti * RT + r;
    cp_async16(Bs + r * BP + col,
               Bm + ((long long)b * L + (lj < L ? lj : 0)) * N + col, lj < L);
    cp_async16(Cs + r * BP + col,
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
  mma_abt<NTC, N, BP, T>(acc, Bs + 16 * mt * BP, Cs + cg * CW * BP, lane);
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

// Stage 4, bf16: y for one RT-row tile of a (batch, chunk, head); warp w
// owns its rows [16w, 16w + 16).  First (chunks c > 0) y = exp(cum_i) C_i
// S_in: A = C's rows, B = S_in converted to bf16 while it is staged (the
// fp32 scratch stays as it is, for the backward).  Then over the key
// tiles up to the tile's end: y += M' x with M'_ij = (C B^T)_ij
// exp(cum_i - cum_j) dt_j built in registers from the fp32 C B^T tile
// (the decay masked to -1e30 BEFORE the exp on the diagonal 16 x 16
// tiles, the only ones it reaches) and rounded to bf16 A fragments
// (to_a_frags); x is B by ldmatrix.trans.  A warp skips the key steps
// wholly past its rows.
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(SsdMma<T, P, N, CH>::kScanThreads, 5)
    ssd_chunk_scan_mma(const T* __restrict__ x, const T* __restrict__ Cm,
                       const float* __restrict__ dt,
                       const float* __restrict__ cum_in,
                       const float* __restrict__ states,
                       const float* __restrict__ cbt, T* __restrict__ y,
                       int L, int H, int nc) {
  using S = SsdMma<T, P, N, CH>;
  constexpr int KT = S::KT, RT = S::RT, NRT = S::NRT, EPC = S::EPC;
  constexpr int BP = S::BP, XP = S::XP, MP = S::MP, NTH = S::kScanThreads;
  constexpr int NTP = P / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // CH
  float* dts = cum + CH;                            // CH
  unsigned char* region = reinterpret_cast<unsigned char*>(dts + CH);
  T* Sb = reinterpret_cast<T*>(region);  // N x XP: S_in (n x p), bf16
  T* Cs = Sb + N * XP;                   // RT x BP: the tile's C rows

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
      cp_async16(xd + r * XP + col,
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
      cp_async16(Cs + r * BP + col,
                 Cm + ((long long)b * L + (ok ? l : 0)) * N + col, ok);
    }
    cp_async_commit();
    stage_rounded<N, P, XP, NTH>(Sb, states + (long long)bch * N * P);
    cp_async_wait_all();
    __syncthreads();  // C rows, S_in, cum and dts in place
    const T* ca = Cs + (r0 + (lane & 15)) * BP + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      unsigned af[1][4];
      ldsm4(af[0], ca + 16 * ks);
      mma_ab<NTP, 1, XP>(acc, af, Sb + 16 * ks * XP, lane);
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
      }
      unsigned af[1][4];
      to_a_frags<2>(af, m);
      mma_ab<NTP, 1, XP>(acc, af, xd + 16 * s * XP, lane);
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
// that fails, else cudaGetLastError() after the last.  fp32 runs the
// CUDA-core stages; bf16 the tensor-core ones.  Stage 2 is shared.
template <typename T, int P, int N, int CH>
cudaError_t launch_ssd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* state,
                       void* cum, void* states, void* cbt, void* ct,
                       int batch, int L, int H, int device,
                       cudaStream_t stream) {
  constexpr bool kFp32 = std::is_same_v<T, float>;
  using S = SsdShape<float, P, N, CH>;  // stage 2's rows, both dtypes
  cudaError_t err;
  const int nc = (L + CH - 1) / CH;
  const T *xp = static_cast<const T*>(x), *bp = static_cast<const T*>(B),
          *cp = static_cast<const T*>(C);
  const float *dtp = static_cast<const float*>(dt),
              *ap = static_cast<const float*>(A);
  float *cump = static_cast<float*>(cum), *stp = static_cast<float*>(states),
        *cbtp = static_cast<float*>(cbt), *ctp = static_cast<float*>(ct);
  if constexpr (kFp32) {
    if ((err = allow_smem_once<ssd_chunk_state<T, P, N, CH>>(
             S::kStateSmem, device)) != cudaSuccess ||
        (err = allow_smem_once<ssd_cb<T, N, CH>>(S::kCbSmem, device)) !=
            cudaSuccess ||
        (err = allow_smem_once<ssd_chunk_scan<T, P, N, CH>>(
             S::kScanSmem, device)) != cudaSuccess)
      return err;
    ssd_chunk_state<T, P, N, CH><<<batch * nc * H, kSsdThreads,
                                   S::kStateSmem, stream>>>(
        xp, dtp, ap, bp, cump, stp, L, H, nc);
  } else {
    using M = SsdMma<T, P, N, CH>;
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
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass<P, N, CH><<<dim3(batch * H, N / S::R2), kSsdThreads, 0,
                             stream>>>(cump, stp, static_cast<float*>(state),
                                       H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (kFp32) {
    ssd_cb<T, N, CH><<<batch * nc * S::NRT * S::NRT, kSsdThreads,
                       S::kCbSmem, stream>>>(bp, cp, cbtp, ctp, L, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_chunk_scan<T, P, N, CH><<<batch * nc * H * S::NRT, kSsdThreads,
                                  S::kScanSmem, stream>>>(
        xp, dtp, cump, stp, cbtp, ctp, static_cast<T*>(y), L, H, nc);
  } else {
    using M = SsdMma<T, P, N, CH>;
    ssd_cb_mma<T, N, CH><<<batch * nc * M::NRT * M::NRT, kSsdThreads,
                           M::kCbSmem, stream>>>(bp, cp, cbtp, L, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_chunk_scan_mma<T, P, N, CH><<<batch * nc * H * M::NRT,
                                      M::kScanThreads, M::kScanSmem,
                                      stream>>>(
        xp, cp, dtp, cump, stp, cbtp, static_cast<T*>(y), L, H, nc);
  }
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
                         void* cum, void* states, void* cbt, void* ct,
                         int batch, int L, int H, int P, int N, int chunk,
                         int device, cudaStream_t s) {
#define GFDIT_SSD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) \
    return launch_ssd<T, p, n, c>(x, dt, A, B, C, y, state, cum, states, \
                                  cbt, ct, batch, L, H, device, s);
  GFDIT_SSD_SHAPES(GFDIT_SSD_CASE)
#undef GFDIT_SSD_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int P, int N, int CH>
cudaError_t occupancy_ssd(int stage, int batch, int L, int H, int device,
                          int* blocks_per_sm, int* smem_bytes, int* grid,
                          int* threads) {
  constexpr bool kFp32 = std::is_same_v<T, float>;
  using S = SsdShape<float, P, N, CH>;
  const int nc = (L + CH - 1) / CH;
  *threads = kSsdThreads;
  switch (stage) {
    case 0:
      *grid = batch * nc * H;
      if constexpr (kFp32) {
        return occupancy_of<ssd_chunk_state<T, P, N, CH>>(
            S::kStateSmem, kSsdThreads, device, blocks_per_sm, smem_bytes);
      } else {
        return occupancy_of<ssd_chunk_state_mma<T, P, N, CH>>(
            SsdMma<T, P, N, CH>::kStateSmem, kSsdThreads, device,
            blocks_per_sm, smem_bytes);
      }
    case 1:
      *grid = batch * H * (N / S::R2);
      *smem_bytes = static_cast<int>(sizeof(float) * S::R2 * (P + 1));
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, ssd_state_pass<P, N, CH>, kSsdThreads, 0);
    case 2:  // the blocks above the diagonal return at once
      *grid = batch * nc * S::NRT * S::NRT;
      if constexpr (kFp32) {
        return occupancy_of<ssd_cb<T, N, CH>>(S::kCbSmem, kSsdThreads,
                                              device, blocks_per_sm,
                                              smem_bytes);
      } else {
        return occupancy_of<ssd_cb_mma<T, N, CH>>(
            SsdMma<T, P, N, CH>::kCbSmem, kSsdThreads, device,
            blocks_per_sm, smem_bytes);
      }
    case 3:
      *grid = batch * nc * H * S::NRT;
      if constexpr (kFp32) {
        return occupancy_of<ssd_chunk_scan<T, P, N, CH>>(
            S::kScanSmem, kSsdThreads, device, blocks_per_sm, smem_bytes);
      } else {
        using M = SsdMma<T, P, N, CH>;
        *threads = M::kScanThreads;
        return occupancy_of<ssd_chunk_scan_mma<T, P, N, CH>>(
            M::kScanSmem, M::kScanThreads, device, blocks_per_sm,
            smem_bytes);
      }
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
// (batch, nc, H, N, P), cbt (batch, nc, chunk, chunk), ct (batch, nc, N,
// chunk).  x, B, C and every scratch buffer 16-byte aligned (cp.async).
extern "C" int gfdit_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* state,
                         void* cum, void* states, void* cbt, void* ct,
                         int batch, int L, int H, int P, int N, int chunk,
                         int dtype, int device, void* stream) {
  using namespace gfdit;
  if (batch <= 0 || L <= 0 || H <= 0) return cudaErrorInvalidValue;
  const void* copied[] = {x, B, C, y, cum, states, cbt, ct};
  for (const void* p : copied)
    if (reinterpret_cast<unsigned long long>(p) & 15)
      return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_ssd<float>(x, dt, A, B, C, y, state, cum, states, cbt, ct,
                               batch, L, H, P, N, chunk, device, s);
  if (dtype == kBFloat16)
    return dispatch_ssd<__nv_bfloat16>(x, dt, A, B, C, y, state, cum, states,
                                       cbt, ct, batch, L, H, P, N, chunk,
                                       device, s);
  return cudaErrorInvalidValue;
}

// Occupancy of one stage kernel of the (P, N, chunk) instantiation (0
// the chunk states, 1 ssd_state_pass, 2 C B^T, 3 the chunk scan; stages
// 0, 2 and 3 run ssd_chunk_state, ssd_cb and ssd_chunk_scan in fp32,
// ssd_chunk_state_mma, ssd_cb_mma and ssd_chunk_scan_mma in bf16) at
// (batch, L, H): resident blocks per SM, shared-memory bytes a block, the
// launch's grid and its threads a block.
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
