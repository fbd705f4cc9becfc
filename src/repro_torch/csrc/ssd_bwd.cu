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
//   1. ssd_bwd_chunk_dstate, a block per (batch, chunk > 0, head):
//      Q_c = sum_i exp(cum_i) C_i (x) dy_i, (n x p), into scratch;
//   2. ssd_bwd_state_pass, a block per (batch, head, n-row tile): walks
//      the chunks backwards, G_{nc-1} = dstate^T (or 0), G_{c-1} =
//      exp(cum_last_c) G_c + Q_c, overwriting Q_c with G_c; and the
//      partial dot <S_in, G_c> of its rows for the dcum of cum_last;
//   3. ssd_bwd_chunk, a block per (batch, chunk, head): every product
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
// Bound on the card: operations.  The function needs, per (batch, chunk)
// of c rows, the causal triangles of the dB and dC products once,
// c(c+1)/2 n multiply-adds each (B and C have one group, so each head's
// P can be summed over the heads first), and per head the triangles of
// dy . xb and of the dxb product, c(c+1)/2 p each, and four c p n
// products (Q, S_in^T dy: none in the first chunk; G B, G^T xb: none in
// the last without dstate): 20.6 GFLOP at the mamba2-1.3b training shape
// (b=2, l=2048, h=64, p=64, n=128, c=128; chip_smoke.ssd_bwd_flops).  On
// an H100 SXM that is 0.125 ms for fp32 operands (three TF32 products for
// each fp32 one at 495 TFLOP/s; 0.307 ms at the 67 TFLOP/s CUDA-core
// rate), against 0.21 GB of operands and gradients (0.063 ms at 3.35
// TB/s); bf16 operands are bound by their 0.107 GB (0.032 ms), the 989
// TFLOP/s bf16 rate taking 0.021 ms.  These kernels do 41.9 GFLOP there,
// 2.04x the need: dB and dC a head, and every product over whole tiles,
// the masked triangle included.
//
// Design, simple first: fp32 on the CUDA cores, as K2's first backward
// was; the tensor cores (split-TF32, as csrc/attention_bwd.cu) wait.
// Every stage is a 256-thread block, a 16 x 16 thread grid (ty, tx); each
// product is a register-blocked outer product over shared memory
// (block_mma) in which a thread owns rows ty + 16a and columns tx + 16e of
// the output, and each operand is read with the strides of its stored
// layout: every pitch is odd or the stride along tx is 1, so the 16
// column lanes of a warp hit 16 banks and its 2 row lanes 2.  Stage 3
// keeps dy, xb (c x (p+1)) and P^T (c x (c+1)) in shared memory for the
// whole chunk and streams every other operand through one tile buffer in
// 32-row tiles (plain loads, one barrier before and after each tile):
// 165.5 KiB at (64, 128, 128), one block an SM.  The products run over
// whole tiles, the masked triangle included; the decay is masked to
// -1e30 BEFORE the exp in every orientation (the upper triangle's cum_i -
// cum_j > 0 reaches ~200 at Mamba2's published dt and A: inf * 0 = NaN).
// dB and dC are written per head (b*nc*h*c*n floats each, 134 MB at the
// training shape) and summed by stage 4 in head order.  A ragged last
// chunk is masked as in the forward: rows past l load dt = x = B = C = dy
// = 0 and are not written; the padded rows' dcum (cum_last's terms among
// them) reaches the real rows through the reverse cumulative sum over
// the whole chunk.
#include "common.cuh"

namespace gfdit {

constexpr int kBwdThreads = 256;  // a 16 x 16 thread grid in every stage
constexpr float kBwdMask = -1e30f;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int P, int N, int CH>
struct SsdBwdShape {
  static_assert(P % 16 == 0 && N % 16 == 0 && CH % 16 == 0 && P <= 64 &&
                    N <= 128 && CH <= 128,
                "ssd_bwd: p, n and chunk must be multiples of 16, p at most "
                "64, n and chunk at most 128");
  static constexpr int KT = CH < 32 ? CH : 32;  // rows of a tile over c
  static constexpr int KE = P < 32 ? P : 32;    // ... over p
  static constexpr int KN = N < 32 ? N : 32;    // ... over n
  static constexpr int YP = P + 1;              // pitch of dy, xb rows
  static constexpr int ZP = CH + 1;             // pitch of P^T rows
  // stage 2: n-rows of the state a block walks (4 floats a thread), and
  // the blocks (n-tiles) of one (batch, head)
  static constexpr int R2 = N < 4 * kBwdThreads / P ? N : 4 * kBwdThreads / P;
  static constexpr int NT2 = N / R2;
  // stage 3's tile buffer, floats: the largest streamed tile(s)
  static constexpr int BUF_A = CH * (KN + 1) + KN * P;  // B rows + G tile
  static constexpr int BUF_B = CH * (KT + 1);           // M tile
  static constexpr int BUF_C = N * (KE + 1);            // G or S_in tile
  static constexpr int BUF_D = KT * N;                  // B or C rows
  static constexpr int BUF = cmax(cmax(BUF_A, BUF_B), cmax(BUF_C, BUF_D));
  // dynamic shared memory, bytes
  static constexpr size_t kDstateSmem = sizeof(float) * (CH + KT * (N + P));
  static constexpr size_t kChunkSmem =
      sizeof(float) * (2 * CH * YP + CH * ZP + BUF + 7 * CH + 16 * CH);
};

// acc[a][e] += sum_{k < K} A(k, ty + 16a) * B(k, tx + 16e), the operands
// in shared memory at A[k * a_k + r * a_r] and B[k * b_k + col * b_c].
template <int TM, int TN>
__device__ __forceinline__ void block_mma(float (&acc)[TM][TN],
                                          const float* a, int a_k, int a_r,
                                          const float* bm, int b_k, int b_c,
                                          int K, int ty, int tx) {
  const float* ar = a + ty * a_r;
  const float* br = bm + tx * b_c;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = ar[k * a_k + 16 * i * a_r];
#pragma unroll
    for (int e = 0; e < TN; ++e) bv[e] = br[k * b_k + 16 * e * b_c];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int e = 0; e < TN; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
  }
}

// the sum over the 16 tx lanes of a row (the same half-warp), in a fixed
// order; every lane gets it
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < TN; ++e) acc[i][e] = 0.f;
}

// Stage 1: Q_c = sum_i exp(cum_i) C_i (x) dy_i, (n x p), chunks c > 0.
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_chunk_dstate(const T* __restrict__ dy, const T* __restrict__ Cm,
                         const float* __restrict__ cum_in,
                         float* __restrict__ g, int L, int H, int nc) {
  using S = SsdBwdShape<P, N, CH>;
  constexpr int KT = S::KT, TM = N / 16, TN = P / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ec = reinterpret_cast<float*>(smem_raw);  // exp(cum_i)
  float* cs = ec + CH;                              // KT x N: C rows
  float* ys = cs + KT * N;                          // KT x P: exp(cum) dy

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bch = blockIdx.x, h = bch % H, bc = bch / H;
  const int c = bc % nc, b = bc / nc, l0 = c * CH;
  if (c == 0) return;  // the gradient entering chunk 0 is not needed
  for (int i = tid; i < CH; i += kBwdThreads)
    ec[i] = expf(cum_in[(long long)bch * CH + i]);
  float acc[TM][TN];
  zero(acc);
  for (int i0 = 0; i0 < CH; i0 += KT) {
    __syncthreads();  // ec written; the previous tile consumed
    for (int q = tid; q < KT * N; q += kBwdThreads) {
      const int r = q / N, k = q % N, l = l0 + i0 + r;
      cs[q] = l < L ? to_float(Cm[((long long)b * L + l) * N + k]) : 0.f;
    }
    for (int q = tid; q < KT * P; q += kBwdThreads) {
      const int r = q / P, e = q % P, l = l0 + i0 + r;
      ys[q] = l < L ? to_float(dy[(((long long)b * L + l) * H + h) * P + e]) *
                          ec[i0 + r]
                    : 0.f;
    }
    __syncthreads();
    block_mma(acc, cs, N, 1, ys, P, 1, KT, ty, tx);
  }
  float* out = g + (long long)bch * N * P;
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int e = 0; e < TN; ++e)
      out[(ty + 16 * a) * P + tx + 16 * e] = acc[a][e];
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

// Stage 3: one (batch, chunk, head): dx, ddt, the head's dB and dC rows
// (into scratch) and its dA partial.
template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const T* __restrict__ dy,
                  const float* __restrict__ cum_in,
                  const float* __restrict__ s_in,
                  const float* __restrict__ cbt, const float* __restrict__ g,
                  const float* __restrict__ sg, T* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dbh,
                  float* __restrict__ dch, float* __restrict__ dap, int L,
                  int H, int nc, int has_dstate) {
  using S = SsdBwdShape<P, N, CH>;
  constexpr int KT = S::KT, KE = S::KE, KN = S::KN, YP = S::YP, ZP = S::ZP;
  constexpr int TC = CH / 16, TP = P / 16, TNN = N / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);  // CH x YP: dy
  float* xs = ys + CH * YP;                        // CH x YP: xb = x dt
  float* pz = xs + CH * YP;    // CH x ZP: pz[j][i] = P_ij = L_ij (dy_i . xb_j)
  float* buf = pz + CH * ZP;   // streamed tiles
  float* cum = buf + S::BUF;
  float* ec = cum + CH;        // exp(cum_i)
  float* ed = ec + CH;         // exp(cum_last - cum_j)
  float* dts = ed + CH;
  float* dcum = dts + CH;      // then da
  float* ddts = dcum + CH;     // ddt through xb
  float* wrow = ddts + CH;     // W_j
  float* part = wrow + CH;     // 16 x CH: column partial sums

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bch = blockIdx.x, h = bch % H, bc = bch / H;
  const int c = bc % nc, b = bc / nc, l0 = c * CH;
  const bool has_g = c < nc - 1 || has_dstate;  // G of this chunk nonzero
  const bool has_s = c > 0;                     // S_in nonzero
  const float* gc = g + (long long)bch * N * P;
  const float* sc = s_in + (long long)bch * N * P;
  const float* cbc = cbt + (long long)bc * CH * CH;
  auto row_of = [&](int l) { return (long long)b * L + l; };

  for (int j = tid; j < CH; j += kBwdThreads) {
    const int l = l0 + j;
    cum[j] = cum_in[(long long)bch * CH + j];
    dts[j] = l < L ? dt[row_of(l) * H + h] : 0.f;
    wrow[j] = 0.f;
  }
  __syncthreads();
  for (int j = tid; j < CH; j += kBwdThreads) {
    ec[j] = expf(cum[j]);
    ed[j] = expf(cum[CH - 1] - cum[j]);
  }
  for (int q = tid; q < CH * P; q += kBwdThreads) {
    const int r = q / P, e = q % P, l = l0 + r;
    const bool ok = l < L;
    const long long off = (row_of(ok ? l : 0) * H + h) * P + e;
    ys[r * YP + e] = ok ? to_float(dy[off]) : 0.f;
    xs[r * YP + e] = ok ? to_float(x[off]) * dts[r] : 0.f;
  }
  __syncthreads();

  // 1. Z[j][i] = xb_j . dy_i; P = L Z, T = (C B^T) P, dcum's intra terms:
  //    +T_ij on cum_i (column sums), -T_ij on cum_j (row sums)
  {
    float z[TC][TC];
    zero(z);
    block_mma(z, xs, 1, YP, ys, 1, YP, P, ty, tx);
    float rows[TC], cols[TC];
#pragma unroll
    for (int a = 0; a < TC; ++a) rows[a] = cols[a] = 0.f;
#pragma unroll
    for (int a = 0; a < TC; ++a) {
      const int j = ty + 16 * a;
#pragma unroll
      for (int e = 0; e < TC; ++e) {
        const int i = tx + 16 * e;
        const bool low = i >= j;
        const float pv = expf(low ? cum[i] - cum[j] : kBwdMask) * z[a][e];
        // only C B^T's written tiles (j <= i) are read
        const float t = low ? cbc[j * CH + i] * pv : 0.f;
        pz[j * ZP + i] = pv;
        rows[a] += t;
        cols[e] += t;
      }
    }
#pragma unroll
    for (int a = 0; a < TC; ++a) {
      const float r = row_sum16(rows[a]);
      if (tx == 0) dcum[ty + 16 * a] = -r;
    }
#pragma unroll
    for (int e = 0; e < TC; ++e) part[ty * CH + tx + 16 * e] = cols[e];
  }
  __syncthreads();
  for (int i = tid; i < CH; i += kBwdThreads) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += part[t * CH + i];
    dcum[i] += s;
  }

  // 2. dxb_j = exp(cum_last - cum_j) G B_j + sum_{i>=j} M_ij dy_i with
  //    M_ij = (C_i . B_j) L_ij; W_j = xb_j . (its first term); dx, ddt
  {
    float d[TC][TP];
    zero(d);
    if (has_g) {
      float* bt = buf;                 // CH x (KN + 1): B rows, a k-tile
      float* gt = buf + CH * (KN + 1); // KN x P: G rows
      for (int k0 = 0; k0 < N; k0 += KN) {
        __syncthreads();
        for (int q = tid; q < CH * KN; q += kBwdThreads) {
          const int j = q / KN, kk = q % KN, l = l0 + j;
          bt[j * (KN + 1) + kk] =
              l < L ? to_float(Bm[row_of(l) * N + k0 + kk]) : 0.f;
        }
        for (int q = tid; q < KN * P; q += kBwdThreads)
          gt[q] = gc[(long long)k0 * P + q];
        __syncthreads();
        block_mma(d, bt, 1, KN + 1, gt, P, 1, KN, ty, tx);
      }
#pragma unroll
      for (int a = 0; a < TC; ++a) {
        const int j = ty + 16 * a;
        float w = 0.f;
#pragma unroll
        for (int e = 0; e < TP; ++e) {
          d[a][e] *= ed[j];
          w = fmaf(xs[j * YP + tx + 16 * e], d[a][e], w);
        }
        w = row_sum16(w);
        if (tx == 0) wrow[j] = w;
      }
    }
    float* mt = buf;  // CH x (KT + 1): mt[j][ii] = M_{i0 + ii, j}
    for (int i0 = 0; i0 < CH; i0 += KT) {
      __syncthreads();
      for (int q = tid; q < CH * KT; q += kBwdThreads) {
        const int j = q / KT, ii = q % KT, i = i0 + ii;
        const bool low = i >= j;
        const float dec = expf(low ? cum[i] - cum[j] : kBwdMask);
        mt[j * (KT + 1) + ii] = low ? cbc[j * CH + i] * dec : 0.f;
      }
      __syncthreads();
      block_mma(d, mt, 1, KT + 1, ys + i0 * YP, YP, 1, KT, ty, tx);
    }
#pragma unroll
    for (int a = 0; a < TC; ++a) {
      const int j = ty + 16 * a, l = l0 + j;
      float s = 0.f;
      if (l < L) {
        T* dxr = dx + (row_of(l) * H + h) * P;
        const T* xr = x + (row_of(l) * H + h) * P;
#pragma unroll
        for (int e = 0; e < TP; ++e) {
          const int col = tx + 16 * e;
          dxr[col] = from_float<T>(d[a][e] * dts[j]);
          s = fmaf(to_float(xr[col]), d[a][e], s);
        }
      }
      s = row_sum16(s);
      if (tx == 0) ddts[j] = s;
    }
  }

  // 3. the head's dB_j = exp(cum_last - cum_j) G^T xb_j + sum_{i>=j}
  //    P_ij C_i
  {
    float acc[TC][TNN];
    zero(acc);
    if (has_g) {
      float* gt = buf;  // N x (KE + 1): G^T, an e-tile
      for (int e0 = 0; e0 < P; e0 += KE) {
        __syncthreads();
        for (int q = tid; q < N * KE; q += kBwdThreads) {
          const int k = q / KE, ee = q % KE;
          gt[k * (KE + 1) + ee] = gc[(long long)k * P + e0 + ee];
        }
        __syncthreads();
        block_mma(acc, xs + e0, 1, YP, gt, 1, KE + 1, KE, ty, tx);
      }
#pragma unroll
      for (int a = 0; a < TC; ++a)
#pragma unroll
        for (int e = 0; e < TNN; ++e) acc[a][e] *= ed[ty + 16 * a];
    }
    float* cs = buf;  // KT x N: C rows
    for (int i0 = 0; i0 < CH; i0 += KT) {
      __syncthreads();
      for (int q = tid; q < KT * N; q += kBwdThreads) {
        const int r = q / N, k = q % N, l = l0 + i0 + r;
        cs[q] = l < L ? to_float(Cm[row_of(l) * N + k]) : 0.f;
      }
      __syncthreads();
      block_mma(acc, pz + i0, 1, ZP, cs, N, 1, KT, ty, tx);
    }
    float* out = dbh + (long long)bch * CH * N;
#pragma unroll
    for (int a = 0; a < TC; ++a)
#pragma unroll
      for (int e = 0; e < TNN; ++e)
        out[(ty + 16 * a) * N + tx + 16 * e] = acc[a][e];
  }

  // 4. the head's dC_i = exp(cum_i) S_in^T dy_i + sum_{j<=i} P_ij B_j; the
  //    first term's C_i . (it) is dcum's term exp(cum_i) dy_i . (S_in C_i)
  {
    float acc[TC][TNN];
    zero(acc);
    if (has_s) {
      float* st = buf;  // N x (KE + 1): S_in (n x p), an e-tile
      for (int e0 = 0; e0 < P; e0 += KE) {
        __syncthreads();
        for (int q = tid; q < N * KE; q += kBwdThreads) {
          const int k = q / KE, ee = q % KE;
          st[k * (KE + 1) + ee] = sc[(long long)k * P + e0 + ee];
        }
        __syncthreads();
        block_mma(acc, ys + e0, 1, YP, st, 1, KE + 1, KE, ty, tx);
      }
#pragma unroll
      for (int a = 0; a < TC; ++a) {
        const int i = ty + 16 * a, l = l0 + i;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < TNN; ++e) {
          acc[a][e] *= ec[i];
          if (l < L)
            s = fmaf(to_float(Cm[row_of(l) * N + tx + 16 * e]), acc[a][e], s);
        }
        s = row_sum16(s);
        if (tx == 0) dcum[i] += s;
      }
    }
    float* bs = buf;  // KT x N: B rows
    for (int j0 = 0; j0 < CH; j0 += KT) {
      __syncthreads();
      for (int q = tid; q < KT * N; q += kBwdThreads) {
        const int r = q / N, k = q % N, l = l0 + j0 + r;
        bs[q] = l < L ? to_float(Bm[row_of(l) * N + k]) : 0.f;
      }
      __syncthreads();
      block_mma(acc, pz + j0 * ZP, ZP, 1, bs, N, 1, KT, ty, tx);
    }
    float* out = dch + (long long)bch * CH * N;
#pragma unroll
    for (int a = 0; a < TC; ++a)
#pragma unroll
      for (int e = 0; e < TNN; ++e)
        out[(ty + 16 * a) * N + tx + 16 * e] = acc[a][e];
  }
  __syncthreads();  // dcum, wrow, ddts complete

  // 5. cum_last's terms, da (dcum's reverse cumulative sum), ddt, the dA
  //    partial: one thread, in row order
  if (tid == 0) {
    float extra = 0.f;
    for (int j = 0; j < CH; ++j) extra += wrow[j];
    if (has_s) {
      const float* p = sg + ((long long)(b * H + h) * nc + c) * S::NT2;
      float dot = 0.f;
      for (int t = 0; t < S::NT2; ++t) dot += p[t];
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
  for (int j = tid; j < CH; j += kBwdThreads) {
    const int l = l0 + j;
    if (l < L) ddt[row_of(l) * H + h] = fmaf(a_h, dcum[j], ddts[j]);
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
  if ((err = allow_smem_once<ssd_bwd_chunk_dstate<T, P, N, CH>>(
           S::kDstateSmem, device)) != cudaSuccess ||
      (err = allow_smem_once<ssd_bwd_chunk<T, P, N, CH>>(
           S::kChunkSmem, device)) != cudaSuccess)
    return err;
  const int nc = (L + CH - 1) / CH;
  const T *xp = static_cast<const T*>(x), *bp = static_cast<const T*>(B),
          *cp = static_cast<const T*>(C), *dyp = static_cast<const T*>(dy);
  const float *cump = static_cast<const float*>(cum),
              *sp = static_cast<const float*>(s_in);
  float *gp = part[0], *sgp = part[1], *dbhp = part[2], *dchp = part[3],
        *dapp = part[4];
  ssd_bwd_chunk_dstate<T, P, N, CH><<<batch * nc * H, kBwdThreads,
                                      S::kDstateSmem, stream>>>(
      dyp, cp, cump, gp, L, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_state_pass<P, N, CH><<<dim3(batch * H, S::NT2), kBwdThreads, 0,
                                 stream>>>(
      cump, sp, static_cast<const float*>(dstate), gp, sgp, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_chunk<T, P, N, CH><<<batch * nc * H, kBwdThreads, S::kChunkSmem,
                               stream>>>(
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
                              int* blocks_per_sm, int* smem_bytes,
                              int* grid) {
  using S = SsdBwdShape<P, N, CH>;
  const int nc = (L + CH - 1) / CH;
  switch (stage) {
    case 0:  // the chunk-0 blocks return at once
      *grid = batch * nc * H;
      return occupancy_of<ssd_bwd_chunk_dstate<T, P, N, CH>>(
          S::kDstateSmem, kBwdThreads, device, blocks_per_sm, smem_bytes);
    case 1:
      *grid = batch * H * S::NT2;
      *smem_bytes = static_cast<int>(sizeof(float) * kBwdThreads / 32);
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, ssd_bwd_state_pass<P, N, CH>, kBwdThreads, 0);
    case 2:
      *grid = batch * nc * H;
      return occupancy_of<ssd_bwd_chunk<T, P, N, CH>>(
          S::kChunkSmem, kBwdThreads, device, blocks_per_sm, smem_bytes);
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
                                   int* grid) {
#define GFDIT_SSD_BWD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) \
    return occupancy_ssd_bwd<T, p, n, c>(stage, batch, L, H, device, \
                                         blocks_per_sm, smem_bytes, grid);
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
// aligned (float4 loads).
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
  const void* vec[] = {work, s_in};
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
// ssd_bwd_chunk_dstate, 1 ssd_bwd_state_pass, 2 ssd_bwd_chunk, 3
// ssd_bwd_sum) at (batch, L, H): resident 256-thread blocks per SM,
// shared-memory bytes a block and the launch's grid.
extern "C" int gfdit_ssd_bwd_occupancy(int stage, int batch, int L, int H,
                                       int P, int N, int chunk, int dtype,
                                       int device, int* blocks_per_sm,
                                       int* smem_bytes, int* grid) {
  using namespace gfdit;
  if (batch <= 0 || L <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (dtype == kFloat32)
    return dispatch_bwd_occupancy<float>(stage, batch, L, H, P, N, chunk,
                                         device, blocks_per_sm, smem_bytes,
                                         grid);
  if (dtype == kBFloat16)
    return dispatch_bwd_occupancy<__nv_bfloat16>(
        stage, batch, L, H, P, N, chunk, device, blocks_per_sm, smem_bytes,
        grid);
  return cudaErrorInvalidValue;
}
