// Flash attention and the §11 cache-splice attention: one tensor-core
// kernel template for both dtypes, over one key walk.
//
// Replaces two TPU kernels:
//   * src/repro/kernels/flash_attention.py::flash_attention (_attn_kernel):
//     online-softmax attention with GQA, optional causal block skipping and
//     an explicit sm_scale;
//   * src/repro/kernels/splice.py::splice_attention (_splice_kernel): the
//     same attention over the stale K/V snapshot whose rows
//     [offset, offset + L) are replaced by this step's fresh shard, without
//     ever materializing the spliced tensor.
// The TPU kernels pad Sq/Sk to 128 and bound the keys with kv_valid; here
// the ragged q and k edges are masked inside the kernel, so no caller pads.
// The key axis is walked as up to three segments, each read from ONE
// source tensor: plain attention has one; the splice has stale
// [0, offset), fresh [offset, offset+L) and stale [offset+L, Sk), so no
// per-row select is needed, and the stage pipeline runs across segments.
// The kernel writes each query row's log-sum-exp for a training caller:
// (B, H, Sq) fp32 in natural-log units (m is kept in raw score units and
// the exp is exp2 with log2(e) folded into the scale, so
// lse = (m * scale_log2 + log2(l)) * ln 2), which the backward kernels of
// attention_bwd.cu read to recompute P.  A null lse pointer (the serving
// path and the splice) writes nothing.
//
// Bound on the card: operations, 2d flops a (query, key) pair for QK^T and
// 2d for PV; bytes for a few queries over many keys (a decode step).
//
// attn_mma_kernel<T, D>: FlashAttention-2's forward on the tensor cores,
// mma.sync with fp32 accumulators, T in {bf16, float}, every head dim of
// ops.HEAD_DIMS.  S and O are summed in fp32; the online softmax runs in
// fp32 on the accumulator fragments (exp2f with log2(e) folded into the
// scale; masked scores -1e30).
//   * bf16 (the training callers' dtype, the LM zoo's bf16 serving):
//     m16n8k16 on bf16 operands (989 TFLOP/s dense on an H100 SXM).  S and
//     O are exact products of the bf16 operands summed in fp32; P is
//     rounded to bf16 before PV, as FlashAttention-2 and this file's
//     backward (attention_bwd.cu) do, while the row sum l adds the fp32 P.
//     (The TPU kernel keeps P in fp32; the rounding costs ~2e-3 rel-L2,
//     within the 3e-2 bf16 budget: tests/test_torch_attention_bf16.py
//     holds it in closed form.)
//   * fp32 (the DiT serving path, image and video, the §11 hit, every
//     fp32 gradient check; budget 1e-5 rel-L2, DESIGN.md §12, where one
//     TF32 product keeps ~1e-3): split-TF32, as the fp32 backward.  Each
//     fp32 operand x splits in registers into hi = tf32(x) and
//     lo = tf32(x - hi) (mma.cuh: split_tf32), and each product is three
//     m16n8k8 TF32 ones, a_lo b_hi + a_hi b_lo + a_hi b_hi, the small
//     terms first (494.7 TFLOP/s dense TF32, so three of them bound the
//     kernel at 165 TFLOP/s of fp32 work against the CUDA cores' 67).  P
//     stays fp32 and splits like any operand, as the TPU kernel keeps it
//     in fp32.  O += P V is mma.cuh's fp32 mma_ab: the accumulator tiles
//     of S are the A fragments as they lie, and each tile's product is
//     summed over kSumSteps k steps in a fresh accumulator that the CUDA
//     cores add to O, rounding to nearest, so O over 20,280 (video) or
//     75,600 keys does not gather the tensor cores' truncation.
//     tests/test_torch_attention_fp32.py holds this rounding in closed
//     form, one TF32 product shown over budget.
//   * Work split: 4 warps of 16 query rows, BQ = 64 rows a block; K/V
//     tiles of BK keys by 16-byte cp.async into two stages: tile j+1 is in
//     flight while tile j is computed, with one block barrier per tile.
//     Tiles stay in T in shared memory in rows of d plus one 16-byte unit
//     (d + 8 bf16, d + 4 fp32): the 8 rows one ldmatrix phase reads fall
//     in distinct banks at every head dim, and at the fp32 pitch
//     (= 4 mod 16 words) so do mma_ab's row-pair loads of V.  Rows past a
//     segment's end are zero-filled by the copy.
//   * S = Q K^T: one ldmatrix.x4 a k step of 16 bytes a row (16 bf16 or 8
//     fp32: on fp32 rows ldmatrix gives exactly the TF32 fragment).  Q's
//     fragments come from ldmatrix once a block and stay in registers
//     (bf16 d / 4 words at d <= 128; fp32 split into hi and lo once, d
//     words, at d <= 64); otherwise they are read again (and split) each
//     tile.  K is the col operand, read untransposed.  Each thread holds
//     rows g and g + 8 (g = lane / 4) of its warp's S: the row max is its
//     own 2 BK / 8 values and two quad shuffles; the row sum stays per
//     thread and is reduced once at the end.
//   * O += P V: bf16, the two n8 accumulator tiles of 16 keys, rounded, are
//     one k16 A fragment (to_a_frags) and V is read by ldmatrix.trans;
//     fp32, one n8 tile is one k8 A fragment (its columns permuted) and V
//     is read by 32-bit loads.  P never touches shared memory.
//   * Masks only where needed: a tile on a segment's ragged end or across
//     the warp's causal diagonal masks its scores to -1e30; a warp whose
//     16 rows all lie above a causal tile's first key, or all past Sq (a
//     decode step's 1-4 queries leave three warps idle), skips the tile's
//     products.  A row that has seen no key keeps P = 0 (its max stays
//     -1e30).
//   * Block shapes (MmaFwdShape): BK = 64 keys (bf16 d <= 128, fp32 d <=
//     32), else 32.  Shared memory (BQ + 4 BK) (d + 16 B / sizeof(T))
//     elements: bf16 45 KiB at d = 64, 85 KiB at 128, 99 KiB at 256; fp32
//     51 KiB at d = 64, 87 KiB at 112, 99 KiB at 128, 195 KiB at 256.  The
//     launch bounds hold the registers (O d / 2 fp32 a thread, S BK / 2, Q
//     as above) to 3 blocks an SM where shared memory allows it, else 2
//     (fp32 d = 256: 1).  ptxas's counts: chip_smoke.py's build phase.
//   * Split keys (flash decoding), both dtypes: a grid of ceil(Sq / 64) B H
//     tiles that cannot fill the card's SMs once (whisper's cross-attention
//     of a 4-token prompt or a decode step: 64 blocks of 1-4 valid rows
//     each walking the 1500 frames; a 512 px DiT request's SP-4 shard: 96
//     blocks over 1024 keys) also splits the key range into n pieces of
//     whole tiles (attn_split_rule: one wave of resident blocks, pieces of
//     two tiles or more, fp32's of one where each gets an SM of its own,
//     n <= kMaxSplits; the caller passes n), one grid z a piece.  The segment walk is
//     clipped to the piece, so causal and splice inputs split too.  Each
//     piece writes its unnormalized fp32 O, its row max (in log2 units)
//     and its row sum to the caller's scratch; attn_combine_kernel merges
//     the pieces by log-sum-exp in fp32, in a fixed order (deterministic,
//     no atomics), writing O in T and the lse when asked.  The scratch,
//     n B Sq H (d + 2) floats, written and read once, is 0.2% of K and
//     V's bytes at whisper's decode step (7 x 64 rows x 66 floats against
//     49 MB) but as large as they are at a 512 px shard (4 x 256 x 24 x
//     66 floats, 6.5 MB, against 12.6 MB), where the split still halves
//     the kernel's time.
#include "mma.cuh"

#include <algorithm>
#include <climits>

namespace gfdit {

constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr float kNegInf = -1e30f;  // fill in fp32 score space only
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A run of key positions [begin, end) read from one K/V source tensor of
// shape (B, src_len, KV, D); key `begin` lives at source row `src_row0`.
template <typename T>
struct Seg {
  const T* k;
  const T* v;
  int src_len;
  int begin;
  int end;
  int src_row0;
};

template <typename T>
struct Segs {
  Seg<T> s[3];
  int n;
};

// Picks a segment without a dynamic index into the kernel's parameters
// (which would copy them to local memory).
template <typename T>
__device__ __forceinline__ Seg<T> seg_at(const Segs<T>& segs, int i) {
  return i == 0 ? segs.s[0] : (i == 1 ? segs.s[1] : segs.s[2]);
}

// Where the tile walk stands: segment `si`, first key `k0`.
struct Cursor {
  int si;
  int k0;
};

template <typename T>
__device__ __forceinline__ int seg_stop(const Seg<T>& sg, int causal,
                                        int qlimit) {
  // causal block skip: keys past this tile's last query are never visited
  return causal ? min(sg.end, qlimit) : sg.end;
}

template <typename T>
Segs<T> plain_segs(const void* k, const void* v, int Sk) {
  Segs<T> segs{};
  segs.s[0] = {static_cast<const T*>(k), static_cast<const T*>(v), Sk, 0, Sk, 0};
  segs.n = 1;
  return segs;
}

template <typename T>
Segs<T> splice_segs(const void* ks, const void* vs, const void* kf,
                    const void* vf, int Sk, int L, int offset) {
  Segs<T> segs{};
  segs.s[0] = {static_cast<const T*>(ks), static_cast<const T*>(vs), Sk, 0,
               offset, 0};
  segs.s[1] = {static_cast<const T*>(kf), static_cast<const T*>(vf), L, offset,
               offset + L, 0};
  segs.s[2] = {static_cast<const T*>(ks), static_cast<const T*>(vs), Sk,
               offset + L, Sk, offset + L};
  segs.n = 3;
  return segs;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// the tensor-core kernel and the split-key combine
// ---------------------------------------------------------------------------

template <typename T, int D>
struct MmaFwdShape {
  static constexpr bool kTf32 = std::is_same_v<T, float>;
  static constexpr int E = 16 / sizeof(T);       // elements a 16-byte unit
  static constexpr int BQ = 16 * kAttnWarps;     // query rows a block
  // keys a tile
  static constexpr int BK = kTf32 ? (D <= 32 ? 64 : 32) : (D <= 128 ? 64 : 32);
  static constexpr int P = D + E;                // shared pitch, elements
  static constexpr int NK = BK / 8;              // n tiles of S
  static constexpr int ND = D / 8;               // n tiles of O
  static constexpr int KW = 2 * E;               // head-dim columns a k step
  static constexpr int KS = D / KW;              // k steps of S
  static constexpr int CPR = D / E;              // 16-byte copies a row
  // Q's fragments in registers (fp32: hi and lo)
  static constexpr bool kQRegs = D <= (kTf32 ? 64 : 128);
  static_assert(D % 16 == 0, "attention: head dim a multiple of 16");
  static constexpr size_t kSmem = sizeof(T) * P * (BQ + 4 * BK);
  // the blocks an SM the launch bounds hold the registers to
  static constexpr int MIN_BLOCKS =
      kTf32 ? (kSmem <= 64 * 1024 ? 3 : (kSmem <= 110 * 1024 ? 2 : 1))
            : (D <= 64 ? 3 : 2);
};

constexpr int kMaxSplits = 64;
constexpr int kCombineThreads = 256;

// The keys [lo, hi) a block walks: all of them, or its split piece.
struct Window {
  int lo, hi;
};

// The first tile at or after segment `si` with keys in the window.
template <typename T>
__device__ __forceinline__ Cursor win_first(const Segs<T>& segs, int si,
                                            int causal, int qlimit,
                                            Window w) {
  for (; si < segs.n; ++si) {
    const Seg<T> sg = seg_at(segs, si);
    const int k0 = max(sg.begin, w.lo);
    if (k0 < min(seg_stop(sg, causal, qlimit), w.hi)) return {si, k0};
  }
  return {segs.n, 0};
}

template <int BK, typename T>
__device__ __forceinline__ Cursor win_next(const Segs<T>& segs, Cursor c,
                                           int causal, int qlimit,
                                           Window w) {
  const Seg<T> sg = seg_at(segs, c.si);
  if (c.k0 + BK < min(seg_stop(sg, causal, qlimit), w.hi))
    return {c.si, c.k0 + BK};
  return win_first(segs, c.si + 1, causal, qlimit, w);
}

// One (query tile, batch*head[, split piece]) block.  split_keys = 0:
// every key, O normalized into `out` (and lse).  Otherwise piece
// blockIdx.z covers keys [z split_keys, (z + 1) split_keys) and writes,
// per row r = (b Sq + qi) H + h, its unnormalized O to part_o[z][r][:]
// and (row max * scale_log2, row sum) to part_ml[z][r].
template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads, MmaFwdShape<T, D>::MIN_BLOCKS)
    attn_mma_kernel(const T* __restrict__ q, T* __restrict__ out,
                    float* __restrict__ lse, Segs<T> segs, int Sq, int H,
                    int KV, float scale_log2, int causal, int split_keys,
                    float* __restrict__ part_o,
                    float2* __restrict__ part_ml) {
  using S = MmaFwdShape<T, D>;
  constexpr int BQ = S::BQ, BK = S::BK, P = S::P, NK = S::NK, ND = S::ND,
                KS = S::KS, KW = S::KW, E = S::E, CPR = S::CPR;
  constexpr bool kTf32 = S::kTf32;
  extern __shared__ __align__(16) unsigned char attn_mma_smem[];
  T* Qs = reinterpret_cast<T*>(attn_mma_smem);   // BQ x P
  T* KVs = Qs + BQ * P;                          // 2 stages x (K, V)

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);      // GQA: q head -> kv head
  const int q0 = blockIdx.x * BQ, iw = q0 + 16 * w;   // the warp's rows
  const int qlimit = q0 + BQ;
  const Window win = split_keys
      ? Window{static_cast<int>(blockIdx.z) * split_keys,
               static_cast<int>(blockIdx.z + 1) * split_keys}
      : Window{0, INT_MAX};

  for (int c = tid; c < BQ * CPR; c += kAttnThreads) {
    const int r = c / CPR, col = c % CPR, qi = q0 + r;
    cp_async16(Qs + r * P + col * E,
               q + (((long long)b * Sq + min(qi, Sq - 1)) * H + h) * D +
                   col * E,
               qi < Sq);
  }
  auto load_tile = [&](Cursor cur, int stage) {
    const Seg<T> sg = seg_at(segs, cur.si);
    const int end = min(sg.end, win.hi);
    T* Kd = KVs + 2 * stage * BK * P;
    T* Vd = Kd + BK * P;
    for (int c = tid; c < BK * CPR; c += kAttnThreads) {
      const int r = c / CPR, col = c % CPR, key = cur.k0 + r;
      const bool ok = key < end;   // rows past the end are zero-filled
      const long long src =
          (((long long)b * sg.src_len + sg.src_row0 +
            (ok ? key - sg.begin : 0)) * KV + kvh) * D + col * E;
      cp_async16(Kd + r * P + col * E, sg.k + src, ok);
      cp_async16(Vd + r * P + col * E, sg.v + src, ok);
    }
  };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8

  Cursor cur = win_first(segs, 0, causal, qlimit, win);
  if (cur.si < segs.n) load_tile(cur, 0);
  cp_async_commit();                 // Q and the first tile
  // Q's A fragments: rows 16 w + (lane & 15), 16-byte half lane >> 4
  const T* qa = Qs + (16 * w + (lane & 15)) * P + (lane >> 4) * E;
  [[maybe_unused]] unsigned qf[S::kQRegs ? KS : 1][4];    // bf16; fp32 hi
  [[maybe_unused]] unsigned ql[S::kQRegs && kTf32 ? KS : 1][4];   // lo
  if constexpr (S::kQRegs) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm4(qf[ks], qa + ks * KW);
      if constexpr (kTf32) split_frag(qf[ks], ql[ks]);
    }
  }
  // K's col-operand rows for an n-tile pair: (lane & 7) + 8 (lane >> 4),
  // 16-byte half (lane >> 3) & 1
  const int koff =
      ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * E;

  int stage = 0;
  while (cur.si < segs.n) {
    const Cursor nxt = win_next<BK>(segs, cur, causal, qlimit, win);
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage's readers are done
    if (nxt.si < segs.n) load_tile(nxt, stage ^ 1);
    cp_async_commit();

    const T* Kt = KVs + 2 * stage * BK * P;
    const T* Vt = Kt + BK * P;
    // warp-uniform: no row of the warp sees a key of this tile, or the
    // warp's rows all lie past Sq
    if (iw < Sq && !(causal && cur.k0 > iw + 15)) {
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned a[4];
        [[maybe_unused]] unsigned al[4];
        if constexpr (S::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = qf[ks][e];
            if constexpr (kTf32) al[e] = ql[ks][e];
          }
        } else {
          ldsm4(a, qa + ks * KW);
          if constexpr (kTf32) split_frag(a, al);
        }
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          unsigned bfr[4];
          ldsm4(bfr, Kt + koff + np * 16 * P + ks * KW);
          if constexpr (kTf32) {
            mma_3xtf32(s[2 * np], a, al, split_tf32(__uint_as_float(bfr[0])),
                       split_tf32(__uint_as_float(bfr[1])));
            mma_3xtf32(s[2 * np + 1], a, al,
                       split_tf32(__uint_as_float(bfr[2])),
                       split_tf32(__uint_as_float(bfr[3])));
          } else {
            mma_bf16(s[2 * np], a, bfr[0], bfr[1]);
            mma_bf16(s[2 * np + 1], a, bfr[2], bfr[3]);
          }
        }
      }

      const Seg<T> sg = seg_at(segs, cur.si);
      const int end = min(sg.end, win.hi);
      if (cur.k0 + BK > end || (causal && cur.k0 + BK - 1 > iw)) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = iw + g + 8 * (e >> 1);
            const int key = cur.k0 + 8 * n + 2 * t + (e & 1);
            if (key >= end || (causal && key > qi)) s[n][e] = kNegInf;
          }
      }

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the quad of lanes holding the row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
        // a row that has seen no key: every score is -1e30, P stays 0
        mc[r] = mx[r] == kNegInf ? 0.f : mx[r] * scale_log2;
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(fmaf(s[n][e], scale_log2, -mc[e >> 1]));
          rs[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      if constexpr (kTf32) {
        mma_ab<ND, NK, P>(o, s, Vt, lane);      // P stays fp32
      } else {
        unsigned pa[NK / 2][4];
        to_a_frags<NK>(pa, s);                  // P rounded to bf16
        mma_ab<ND, NK / 2, P>(o, pa, Vt, lane);
      }
    }
    cur = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = iw + g + 8 * r;
    if (qi >= Sq) continue;
    const long long row = ((long long)b * Sq + qi) * H + h;
    if (split_keys) {
      const long long rows = (long long)gridDim.y * Sq;   // B Sq H
      float* po = part_o + (blockIdx.z * rows + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(po + 8 * n) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (t == 0)
        part_ml[blockIdx.z * rows + row] = make_float2(m[r] * scale_log2, l[r]);
      continue;
    }
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + h) * Sq + qi] =
          (m[r] * scale_log2 + log2f(l[r])) * kLn2;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* po = out + row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float v2[2] = {o[n][2 * r] * inv, o[n][2 * r + 1] * inv};
      store_vec<2>(po + 8 * n, v2);
    }
  }
}

// One warp a row r = (b Sq + qi) H + h: merges the n split pieces of
// attn_mma_kernel by log-sum-exp in fp32, pieces in order, and writes the
// row of O in T (and its lse).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    attn_combine_kernel(const float* __restrict__ part_o,
                        const float2* __restrict__ part_ml,
                        T* __restrict__ out, float* __restrict__ lse,
                        int n, int rows, int Sq, int H, int D) {
  const int row = (blockIdx.x * kCombineThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                 // whole warps leave together
  float M = kNegInf;                       // the row max, log2 units
  for (int z = 0; z < n; ++z)
    M = fmaxf(M, part_ml[(long long)z * rows + row].x);
  float L = 0.f;
  for (int z = 0; z < n; ++z) {
    const float2 ml = part_ml[(long long)z * rows + row];
    L += ml.y * exp2f(ml.x - M);
  }
  if (lse != nullptr && lane == 0) {
    const int h = row % H, bq = row / H;
    lse[((long long)(bq / Sq) * H + h) * Sq + bq % Sq] =
        (M + log2f(L)) * kLn2;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int c = 2 * lane; c < D; c += 64) {
    float2 acc = make_float2(0.f, 0.f);
    for (int z = 0; z < n; ++z) {
      const long long zr = (long long)z * rows + row;
      const float wz = exp2f(part_ml[zr].x - M);
      const float2 v = *reinterpret_cast<const float2*>(part_o + zr * D + c);
      acc.x = fmaf(wz, v.x, acc.x);
      acc.y = fmaf(wz, v.y, acc.y);
    }
    const float v2[2] = {acc.x * inv, acc.y * inv};
    store_vec<2>(out + (long long)row * D + c, v2);
  }
}

// The card's SMs, read once a device.
inline cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int v = cached[device].load(std::memory_order_acquire);
  if (v == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached[device].store(v, std::memory_order_release);
  }
  *sms = v;
  return cudaSuccess;
}

struct SplitPlan {
  int n;      // pieces (1: no split)
  int keys;   // keys a piece, a whole number of tiles
};

// The pieces the library splits the keys into (gfdit_attention_splits),
// 1 where the tile grid fills the card's SMs once.  Otherwise as many
// pieces as fill one wave of resident blocks and no more (a second,
// partial wave cost more than it saved: an fp32 512 px SP-4 shard, 96
// tiles over 1024 keys, 0.0436 ms in 4 pieces, 0.0501 in 5; whisper's
// decode 0.0305 in 6, 0.0416 in 7), of at least two key tiles each.  An
// fp32 piece may be one tile where every piece then has an SM of its own
// (the text encoder's 8 tiles over 3 key tiles: 0.0297 ms unsplit, 0.0180
// in 3; a 512 px shard's cross-attention, 96 tiles over 3 key tiles,
// lost: 0.0112 unsplit, 0.0132 in 3).  A split must take at least two
// tiles off each block's walk: one is what the combine costs (a 128 px
// request's 24 tiles over 2 key tiles: 0.0085 ms unsplit, 0.0084 in 2,
// at 16.5 and 36.7 us of host time a call).
// Measured on an H100 by chip_smoke.py --phase splits.
template <typename T, int D>
int attn_split_rule(int B, int Sq, int Sk, int H, int sms) {
  using S = MmaFwdShape<T, D>;
  const long long tiles = (long long)((Sq + S::BQ - 1) / S::BQ) * B * H;
  const int ktiles = (Sk + S::BK - 1) / S::BK;
  if (tiles >= sms) return 1;
  const int min_tiles = S::kTf32 && tiles * ktiles <= sms ? 1 : 2;
  const int n = static_cast<int>(
      std::min({(long long)sms * S::MIN_BLOCKS / tiles,
                (long long)(ktiles / min_tiles), (long long)kMaxSplits}));
  if (n < 2 || ktiles - (ktiles + n - 1) / n < 2) return 1;
  return n;
}

// The keys split into at most n pieces of whole tiles, spread evenly.
template <typename T, int D>
SplitPlan attn_split_plan(int Sk, int n) {
  constexpr int BK = MmaFwdShape<T, D>::BK;
  const int ktiles = (Sk + BK - 1) / BK;
  const int per = (ktiles + n - 1) / n;     // tiles a piece
  return {(ktiles + per - 1) / per, per * BK};
}

template <typename T, int D>
cudaError_t launch_attn_mma(const void* q, void* out, float* lse,
                            const Segs<T>& segs, int B, int Sq, int Sk,
                            int H, int KV, float sm_scale, int causal,
                            float* scratch, long long scratch_floats,
                            int splits, int device, cudaStream_t stream) {
  using S = MmaFwdShape<T, D>;
  cudaError_t err = allow_smem_once<attn_mma_kernel<T, D>>(S::kSmem, device);
  if (err != cudaSuccess) return err;
  const SplitPlan sp = attn_split_plan<T, D>(Sk, splits);
  const dim3 grid((Sq + S::BQ - 1) / S::BQ, B * H, sp.n);
  const float scale_log2 = sm_scale * kLog2e;
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
  if (sp.n == 1) {
    attn_mma_kernel<T, D><<<grid, kAttnThreads, S::kSmem, stream>>>(
        qt, ot, lse, segs, Sq, H, KV, scale_log2, causal, 0, nullptr,
        nullptr);
    return cudaGetLastError();
  }
  const long long rows = (long long)B * Sq * H;
  if (scratch == nullptr || scratch_floats < sp.n * rows * (D + 2))
    return cudaErrorInvalidValue;
  float* part_o = scratch;
  float2* part_ml = reinterpret_cast<float2*>(scratch + sp.n * rows * D);
  attn_mma_kernel<T, D><<<grid, kAttnThreads, S::kSmem, stream>>>(
      qt, ot, lse, segs, Sq, H, KV, scale_log2, causal, sp.keys, part_o,
      part_ml);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(
      (rows * 32 + kCombineThreads - 1) / kCombineThreads);
  attn_combine_kernel<T><<<blocks, kCombineThreads, 0, stream>>>(
      part_o, part_ml, ot, lse, sp.n, static_cast<int>(rows), Sq, H, D);
  return cudaGetLastError();
}

#define GFDIT_ATTN_HEAD_DIMS(X) X(16) X(32) X(64) X(112) X(128) X(256)

template <typename T>
cudaError_t dispatch_attn_mma(const void* q, void* out, float* lse,
                              const Segs<T>& segs, int B, int Sq, int Sk,
                              int H, int KV, int D, float sm_scale,
                              int causal, float* scratch,
                              long long scratch_floats, int splits,
                              int device, cudaStream_t stream) {
#define GFDIT_ATTN_MMA(DIM)                                                 \
  case DIM:                                                                 \
    return launch_attn_mma<T, DIM>(q, out, lse, segs, B, Sq, Sk, H, KV,     \
                                   sm_scale, causal, scratch,               \
                                   scratch_floats, splits, device, stream);
  switch (D) {
    GFDIT_ATTN_HEAD_DIMS(GFDIT_ATTN_MMA)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ATTN_MMA
}

// The split pieces the `dtype` kernel takes at this shape (1: none).
cudaError_t attn_splits(int B, int Sq, int Sk, int H, int D, int dtype,
                        int device, int* n) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
#define GFDIT_ATTN_SPLITS(DIM)                                              \
  case DIM:                                                                 \
    *n = dtype == kFloat32                                                  \
             ? attn_split_rule<float, DIM>(B, Sq, Sk, H, sms)               \
             : attn_split_rule<bf16, DIM>(B, Sq, Sk, H, sms);               \
    return cudaSuccess;
  switch (D) {
    GFDIT_ATTN_HEAD_DIMS(GFDIT_ATTN_SPLITS)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ATTN_SPLITS
}

template <typename T, int D>
cudaError_t occupancy_attn_mma(int device, int* blocks, int* smem) {
  return occupancy_of<attn_mma_kernel<T, D>>(
      MmaFwdShape<T, D>::kSmem, kAttnThreads, device, blocks, smem);
}

}  // namespace gfdit

// q/out: (B, Sq, H, D); k/v: (B, Sk, KV, D); all contiguous, one dtype,
// 16-byte aligned (cp.async copies 16 bytes).  lse: null, or (B, H, Sq)
// fp32 to receive each row's log-sum-exp (the autograd path).  splits:
// the key pieces, 1 (the tile kernel alone) to kMaxSplits; the serving
// callers pass gfdit_attention_splits' count.  scratch: the split-key
// path's fp32 pieces, scratch_floats >= splits B Sq H (D + 2) (null where
// splits = 1).
extern "C" int gfdit_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, float* scratch,
                               long long scratch_floats, int splits, int B,
                               int Sq, int Sk, int H, int KV, int D,
                               int causal, float sm_scale, int dtype,
                               int device, void* stream) {
  using namespace gfdit;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      splits < 1 || splits > kMaxSplits ||
      (causal && Sq != Sk) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_attn_mma<float>(q, out, lse, plain_segs<float>(k, v, Sk),
                                    B, Sq, Sk, H, KV, D, sm_scale, causal,
                                    scratch, scratch_floats, splits, device,
                                    s);
  if (dtype == kBFloat16)
    return dispatch_attn_mma<bf16>(q, out, lse, plain_segs<bf16>(k, v, Sk),
                                   B, Sq, Sk, H, KV, D, sm_scale, causal,
                                   scratch, scratch_floats, splits, device,
                                   s);
  return cudaErrorInvalidValue;
}

// q/out: (B, Sq, H, D); k_stale/v_stale: (B, Sk, KV, D);
// k_fresh/v_fresh: (B, L, KV, D) with 0 <= offset and offset + L <= Sk;
// splits and scratch as gfdit_attention's.
extern "C" int gfdit_splice_attention(const void* q, const void* k_stale,
                                      const void* v_stale, const void* k_fresh,
                                      const void* v_fresh, void* out,
                                      float* scratch, long long scratch_floats,
                                      int splits, int B, int Sq, int Sk, int L,
                                      int H, int KV, int D, int offset,
                                      float sm_scale, int dtype, int device,
                                      void* stream) {
  using namespace gfdit;
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0 || L <= 0 || offset < 0 ||
      splits < 1 || splits > kMaxSplits ||
      offset + L > Sk || !aligned16(q) || !aligned16(k_stale) ||
      !aligned16(v_stale) || !aligned16(k_fresh) || !aligned16(v_fresh) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_attn_mma<float>(
        q, out, nullptr,
        splice_segs<float>(k_stale, v_stale, k_fresh, v_fresh, Sk, L, offset),
        B, Sq, Sk, H, KV, D, sm_scale, 0, scratch, scratch_floats, splits,
        device, s);
  if (dtype == kBFloat16)
    return dispatch_attn_mma<bf16>(
        q, out, nullptr,
        splice_segs<bf16>(k_stale, v_stale, k_fresh, v_fresh, Sk, L, offset),
        B, Sq, Sk, H, KV, D, sm_scale, 0, scratch, scratch_floats, splits,
        device, s);
  return cudaErrorInvalidValue;
}

// The pieces the `dtype` kernel splits the keys of a (B, Sq, H) query grid
// over Sk key positions into (1: no split).
extern "C" int gfdit_attention_splits(int B, int Sq, int Sk, int H, int D,
                                      int dtype, int device, int* n) {
  using namespace gfdit;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  return attn_splits(B, Sq, Sk, H, D, dtype, device, n);
}

// Resident blocks per SM and dynamic shared bytes of the `dtype` tile
// kernel (attn_mma_kernel<T, D>), from the CUDA occupancy calculator.
extern "C" int gfdit_attention_occupancy(int D, int dtype, int device,
                                         int* blocks, int* smem) {
  using namespace gfdit;
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
#define GFDIT_OCC(DIM)                                                      \
  case DIM:                                                                 \
    return dtype == kFloat32                                                \
               ? occupancy_attn_mma<float, DIM>(device, blocks, smem)       \
               : occupancy_attn_mma<bf16, DIM>(device, blocks, smem);
  switch (D) {
    GFDIT_ATTN_HEAD_DIMS(GFDIT_OCC)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_OCC
}

extern "C" const char* gfdit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
