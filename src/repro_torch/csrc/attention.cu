// Flash attention and the §11 cache-splice attention: two kernel
// templates, one for each dtype, over one key walk.
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
// Both templates write each query row's log-sum-exp for a training
// caller: (B, H, Sq) fp32 in natural-log units (m is kept in raw score
// units and the exp is exp2 with log2(e) folded into the scale, so
// lse = (m * scale_log2 + log2(l)) * ln 2), which the backward kernels of
// attention_bwd.cu read to recompute P.  A null lse pointer (the serving
// path and the splice) writes nothing.
//
// Bound on the card: operations, 2d flops a (query, key) pair for QK^T and
// 2d for PV; bytes for a few queries over many keys (a decode step).
//
// fp32 (attn_kernel<float, D>; the DiT serving path, every gradient
// check): CUDA cores, 67 TFLOP/s on an H100 SXM.  The tensor cores are
// not used: the fp32 path holds each kernel to its plain version within
// 1e-5 (DESIGN.md §12), one TF32 product keeps ~1e-3, and split-TF32 (the
// fp32 backward's three TF32 products for each fp32 one) is left for a
// later redesign of this forward.  An SM serves one 128-byte
// shared-memory wavefront a clock, so the two products reach the FMA rate
// only if each wavefront feeds >= 4 FMAs.  Design: one 128-thread block
// (4 warps) per (batch*head, BQ-query tile); BQ = 64 (32 at d=256).  Keys
// come in tiles of 32.
//   * Register blocking.  Lane (rg = lane/8, kg = lane%8) of warp w owns
//     A = 4 query rows (w*16 + 4a + rg) and 4 keys (kg + 8t) of the score
//     tile, and the same rows times d/8 columns of the output.  Q, K and V
//     sit in shared memory row-major with a 16-byte pad, so a lane reads 4
//     consecutive d-values of a row as one 16-byte load, the 4 query rows
//     of one load instruction are broadcast over the 8 key lanes, and the
//     8 key rows of one load fall in distinct banks.  QK^T: per 4
//     d-values, 8 loads of one wavefront each feed 64 FMAs, 8 FMAs a
//     wavefront.  PV: per key, one P load (4 rows) and d/32 V loads of one
//     wavefront each feed 4*d/8 FMAs, 10.7 a wavefront at d=64.
//   * A warp's 16 rows see all 32 keys of a tile, so the softmax's row
//     max is a 3-step shuffle among the 8 key lanes, the row sum is kept
//     per lane and reduced once at the end, and P goes to a per-warp
//     shared buffer (written as one 16-byte store per key, read back as
//     one 16-byte load) behind a __syncwarp, not a block barrier.
//   * K/V tiles arrive by 16-byte cp.async.cg into two stages: tile j+1
//     is in flight while tile j is computed, with one block barrier per
//     tile.  Rows past a segment's end are zero-filled by the copy and
//     their scores masked to -1e30 (fp32 score space); interior tiles skip
//     the mask.
//   * exp2f with log2(e) folded into sm_scale (the MUFU ex2).
//   * Shared memory (d=64): Q 17.0 KB, two K/V stages 34.0 KB, P 8 KB, 59
//     KB a block: 3 blocks (12 warps) an SM, so the DiT's 384 blocks at
//     Sq=1024 x 24 heads fit one wave on 132 SMs.  d=128 takes 2 blocks an
//     SM; d=256 halves BQ and takes 1.
//   * Head dim 112 (zamba2-7b's shared attention): 32 does not divide it,
//     so a lane owns 7 pairs of output columns (VW = 2, one 8-byte V load
//     per pair) instead of padding the tile to 128 columns, whose masked
//     16 would cost 1/8 of the FMAs.  Rows of 116 floats keep the 8 key
//     rows of a load on distinct banks.  95.0 KB a block: 2 blocks an SM.
//
// bf16 (attn_mma_kernel<D>, every head dim; the training callers' dtype,
// the LM zoo's bf16 serving): FlashAttention-2's forward on the tensor
// cores, mma.sync m16n8k16 on bf16 operands with fp32 accumulators (989
// TFLOP/s dense on an H100 SXM).  S and O are exact products of the bf16
// operands summed in fp32; the online softmax runs in fp32 on the
// accumulator fragments; P is rounded to bf16 before PV, as
// FlashAttention-2 and this file's backward (attention_bwd.cu) do, while
// the row sum l adds the fp32 P.  (The TPU kernel keeps P in fp32; the
// rounding costs ~2e-3 rel-L2, within the 3e-2 bf16 budget:
// tests/test_torch_attention_bf16.py holds it in closed form.)
//   * Work split: 4 warps of 16 query rows, BQ = 64 rows a block; K/V
//     tiles of BK = 64 keys (32 at d = 256) by 16-byte cp.async into two
//     stages, as above.  Tiles stay bf16 in shared memory in rows of d + 8
//     (one 16-byte pad: the 8 rows one ldmatrix phase reads fall in
//     distinct banks at every head dim).
//   * S = Q K^T: Q's fragments come from ldmatrix once a block and stay
//     in registers (d / 4 of them); at d = 256, where the 16 x 256 fp32 O
//     accumulator alone takes 128 registers, they are read again from
//     shared memory each tile.  K is the col operand, read untransposed by
//     ldmatrix.  Each thread holds rows g and g + 8 (g = lane / 4) of its
//     warp's S: the row max is its own 2 BK / 8 values and two quad
//     shuffles; the row sum stays per thread and is reduced once at the
//     end.
//   * O += P V: the two n8 accumulator tiles of 16 keys, rounded to bf16,
//     are one k16 A fragment (to_a_frags), so P never touches shared
//     memory; V is read by ldmatrix.trans.
//   * Masks only where needed: a tile on a segment's ragged end or across
//     the warp's causal diagonal masks its scores to -1e30; a warp whose
//     16 rows all lie above a causal tile's first key skips the tile.  A
//     row that has seen no key keeps P = 0 (its max stays -1e30).
//   * Registers: O d / 2, S BK / 2, P BK / 4, Q d / 4 fp32 or packed bf16
//     words a thread; the launch bounds hold d <= 64 to 3 blocks an SM,
//     the rest to 2 (ptxas's counts: chip_smoke.py's build phase).
//     Shared memory: (64 + 4 BK) (d + 8) bf16, 45 KiB at d = 64, 85 KiB
//     at d = 128, 99 KiB at d = 256.
//   * Split keys (flash decoding): a grid of ceil(Sq / 64) B H tiles that
//     cannot fill the card's SMs once (whisper's cross-attention of a
//     4-token prompt or a decode step: 64 blocks of 1-4 valid rows each
//     walking 24 key tiles) also splits the key range into n pieces of
//     whole tiles (attn_split_plan: enough blocks for every SM's resident
//     blocks, each piece >= kMinSplitTiles tiles, n <= kMaxSplits), one
//     grid z a piece.  The segment walk is clipped to the piece, so causal
//     and splice inputs split too.  Each piece writes its unnormalized
//     fp32 O, its row max (in log2 units) and its row sum to the caller's
//     scratch; attn_combine_kernel merges the pieces by log-sum-exp in
//     fp32, in a fixed order (deterministic, no atomics), writing O in
//     bf16 and the lse when asked.  The scratch, n B Sq H (d + 2) floats,
//     is a few percent of K and V's bytes at those shapes.
#include "mma.cuh"

#include <algorithm>
#include <climits>

namespace gfdit {

constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr int kBK = 32;            // keys per tile
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

template <typename T, int D>
struct AttnShape {
  static constexpr int A = D <= 128 ? 4 : 2;     // query rows a lane owns
  static constexpr int BQ = kAttnWarps * 4 * A;  // query rows a block owns
  // output columns a vector: 4, or 2 where 32 does not divide D (16 and
  // 112: at D=112 a lane owns 7 pairs of columns, 14 in all)
  static constexpr int VW = D % 32 == 0 ? 4 : 2;
  static constexpr int NVC = D / (8 * VW);       // column vectors a lane
  static_assert(D % 16 == 0 && NVC * 8 * VW == D,
                "attention: head dim must be a multiple of 16");
  static constexpr int EPC = 16 / sizeof(T);     // elements a 16-byte copy
  static constexpr int CPR = D / EPC;            // copies a row
  static constexpr int PITCH = D + EPC;          // shared row, 16-byte pad
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : (D <= 128 ? 2 : 1);
  static constexpr size_t kSmem =
      sizeof(T) * PITCH * (BQ + 4 * kBK) +
      sizeof(float) * kAttnWarps * kBK * 4 * A;
};

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

// The first tile at or after segment `si` whose range is not empty.
template <typename T>
__device__ __forceinline__ Cursor first_tile(const Segs<T>& segs, int si,
                                             int causal, int qlimit) {
  for (; si < segs.n; ++si) {
    const Seg<T> sg = seg_at(segs, si);
    if (sg.begin < seg_stop(sg, causal, qlimit)) return {si, sg.begin};
  }
  return {segs.n, 0};
}

template <typename T>
__device__ __forceinline__ Cursor next_tile(const Segs<T>& segs, Cursor c,
                                            int causal, int qlimit) {
  const Seg<T> sg = seg_at(segs, c.si);
  if (c.k0 + kBK < seg_stop(sg, causal, qlimit)) return {c.si, c.k0 + kBK};
  return first_tile(segs, c.si + 1, causal, qlimit);
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads,
                                  AttnShape<T, D>::MIN_BLOCKS)
    attn_kernel(const T* __restrict__ q, T* __restrict__ out,
                float* __restrict__ lse, Segs<T> segs, int Sq, int H, int KV,
                float scale_log2, int causal) {
  using S = AttnShape<T, D>;
  constexpr int A = S::A, BQ = S::BQ, VW = S::VW, NVC = S::NVC;
  constexpr int EPC = S::EPC, CPR = S::CPR, PITCH = S::PITCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);          // BQ x PITCH
  T* KVs = Qs + BQ * PITCH;                        // 2 stages x (K, V)
  float* Ps = reinterpret_cast<float*>(KVs + 4 * kBK * PITCH);

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, kg = lane & 7;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);      // GQA: q head -> kv head
  const int q0 = blockIdx.x * BQ;
  const int qlimit = q0 + BQ;
  const int wrow = w * 4 * A;        // the warp's first row in the tile
  float* Pw = Ps + w * kBK * 4 * A;  // the warp's P: kBK x 4A, row-permuted

  for (int c = tid; c < BQ * CPR; c += kAttnThreads) {
    const int r = c / CPR, col = c % CPR, qi = q0 + r;
    const T* src =
        q + (((long long)b * Sq + min(qi, Sq - 1)) * H + h) * D + col * EPC;
    cp_async16(Qs + r * PITCH + col * EPC, src, qi < Sq);
  }

  auto load_tile = [&](Cursor cur, int stage) {
    const Seg<T> sg = seg_at(segs, cur.si);
    T* Kd = KVs + 2 * stage * kBK * PITCH;
    T* Vd = Kd + kBK * PITCH;
    for (int c = tid; c < kBK * CPR; c += kAttnThreads) {
      const int r = c / CPR, col = c % CPR, key = cur.k0 + r;
      const bool ok = key < sg.end;
      const long long src =
          (((long long)b * sg.src_len + sg.src_row0 +
            (ok ? key - sg.begin : 0)) * KV + kvh) * D + col * EPC;
      cp_async16(Kd + r * PITCH + col * EPC, sg.k + src, ok);
      cp_async16(Vd + r * PITCH + col * EPC, sg.v + src, ok);
    }
  };

  float m[A], l[A], acc[A][NVC * VW];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NVC * VW; ++c) acc[a][c] = 0.f;
  }

  Cursor cur = first_tile(segs, 0, causal, qlimit);
  if (cur.si < segs.n) load_tile(cur, 0);
  cp_async_commit();                 // Q and the first tile
  int stage = 0;
  while (cur.si < segs.n) {
    const Cursor nxt = next_tile(segs, cur, causal, qlimit);
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage's readers are done
    if (nxt.si < segs.n) load_tile(nxt, stage ^ 1);
    cp_async_commit();

    const T* Kt = KVs + 2 * stage * kBK * PITCH;
    const T* Vt = Kt + kBK * PITCH;
    float s[A][4];
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[a][t] = 0.f;
#pragma unroll(D <= 64 ? D / 4 : 4)
    for (int kk = 0; kk < D; kk += 4) {
      float4 qa[A], kb[4];
#pragma unroll
      for (int a = 0; a < A; ++a)
        qa[a] = ld4(Qs + (wrow + 4 * a + rg) * PITCH + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) kb[t] = ld4(Kt + (kg + 8 * t) * PITCH + kk);
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float v = s[a][t];
          v = fmaf(qa[a].x, kb[t].x, v);
          v = fmaf(qa[a].y, kb[t].y, v);
          v = fmaf(qa[a].z, kb[t].z, v);
          v = fmaf(qa[a].w, kb[t].w, v);
          s[a][t] = v;
        }
    }

    const Seg<T> sg = seg_at(segs, cur.si);
    const bool ragged = cur.k0 + kBK > sg.end;
    const bool diagonal = causal && cur.k0 + kBK - 1 > q0 + wrow;
    if (ragged || diagonal) {        // warp-uniform
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int qi = q0 + wrow + 4 * a + rg;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int key = cur.k0 + kg + 8 * t;
          if (key >= sg.end || (causal && key > qi)) s[a][t] = kNegInf;
        }
      }
    }

#pragma unroll
    for (int a = 0; a < A; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)  // the 8 key lanes of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = exp2f((m[a] - m_new) * scale_log2);
      const float mc = m_new * scale_log2;
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        s[a][t] = exp2f(fmaf(s[a][t], scale_log2, -mc));
        rs += s[a][t];
      }
      l[a] = l[a] * alpha + rs;      // this lane's keys; reduced at the end
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NVC * VW; ++c) acc[a][c] *= alpha;
    }
    // P[key][rg*A + a]: a lane's A rows of one key are one store
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float pv[A];
#pragma unroll
      for (int a = 0; a < A; ++a) pv[a] = s[a][t];
      store_vec<A>(Pw + (kg + 8 * t) * 4 * A + rg * A, pv);
    }
    __syncwarp();

#pragma unroll(D <= 128 ? kBK : 8)
    for (int j = 0; j < kBK; ++j) {
      float pa[A];
      load_vec<A>(Pw + j * 4 * A + rg * A, pa);
#pragma unroll
      for (int u = 0; u < NVC; ++u) {
        float vv[VW];
        load_vec<VW>(Vt + j * PITCH + (u * 8 + kg) * VW, vv);
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[a][u * VW + e] = fmaf(pa[a], vv[e], acc[a][u * VW + e]);
      }
    }
    cur = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int a = 0; a < A; ++a) {
    float lsum = l[a];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    const int qi = q0 + wrow + 4 * a + rg;
    if (qi >= Sq) continue;
    if (lse != nullptr && kg == 0)
      lse[((long long)b * H + h) * Sq + qi] =
          (m[a] * scale_log2 + log2f(lsum)) * kLn2;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    T* o = out + (((long long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int u = 0; u < NVC; ++u) {
      float v[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) v[e] = acc[a][u * VW + e] * inv;
      store_vec<VW>(o + (u * 8 + kg) * VW, v);
    }
  }
}

template <typename T, int D>
cudaError_t launch_attn(const void* q, void* out, float* lse,
                        const Segs<T>& segs, int B, int Sq, int H, int KV,
                        float sm_scale, int causal, int device,
                        cudaStream_t stream) {
  using S = AttnShape<T, D>;
  const cudaError_t err = allow_smem_once<attn_kernel<T, D>>(S::kSmem, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + S::BQ - 1) / S::BQ, B * H);
  attn_kernel<T, D><<<grid, kAttnThreads, S::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(out), lse, segs, Sq, H, KV,
      sm_scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t occupancy_attn(int device, int* blocks, int* smem) {
  const cudaError_t err =
      allow_smem_once<attn_kernel<T, D>>(AttnShape<T, D>::kSmem, device);
  if (err != cudaSuccess) return err;
  *smem = static_cast<int>(AttnShape<T, D>::kSmem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_kernel<T, D>, kAttnThreads, AttnShape<T, D>::kSmem);
}

template <typename T>
cudaError_t dispatch_attn(const void* q, void* out, float* lse,
                          const Segs<T>& segs, int B, int Sq, int H, int KV,
                          int D, float sm_scale, int causal, int device,
                          cudaStream_t stream) {
#define GFDIT_ATTN(DIM)                                                    \
  case DIM:                                                                \
    return launch_attn<T, DIM>(q, out, lse, segs, B, Sq, H, KV, sm_scale,  \
                               causal, device, stream);
  switch (D) {
    GFDIT_ATTN(16)
    GFDIT_ATTN(32)
    GFDIT_ATTN(64)
    GFDIT_ATTN(112)
    GFDIT_ATTN(128)
    GFDIT_ATTN(256)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ATTN
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
// bf16: the tensor-core kernel and the split-key combine
// ---------------------------------------------------------------------------

template <int D>
struct MmaFwdShape {
  static constexpr int BQ = 16 * kAttnWarps;     // query rows a block
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys a tile
  static constexpr int P = D + 8;                // shared pitch, bf16
  static constexpr int NK = BK / 8;              // n tiles of S
  static constexpr int ND = D / 8;               // n tiles of O
  static constexpr int KS = D / 16;              // k steps of S
  static constexpr int CPR = D / 8;              // 16-byte copies a row
  static constexpr bool kQRegs = D <= 128;       // Q fragments in registers
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;
  static_assert(D % 16 == 0, "attention: head dim a multiple of 16");
  static constexpr size_t kSmem = sizeof(bf16) * P * (BQ + 4 * BK);
};

constexpr int kMinSplitTiles = 2;   // key tiles a split piece at least
constexpr int kMaxSplits = 64;
constexpr int kCombineThreads = 256;

// The keys [lo, hi) a block walks: all of them, or its split piece.
struct Window {
  int lo, hi;
};

// The first tile at or after segment `si` with keys in the window.
__device__ __forceinline__ Cursor win_first(const Segs<bf16>& segs, int si,
                                            int causal, int qlimit,
                                            Window w) {
  for (; si < segs.n; ++si) {
    const Seg<bf16> sg = seg_at(segs, si);
    const int k0 = max(sg.begin, w.lo);
    if (k0 < min(seg_stop(sg, causal, qlimit), w.hi)) return {si, k0};
  }
  return {segs.n, 0};
}

template <int BK>
__device__ __forceinline__ Cursor win_next(const Segs<bf16>& segs, Cursor c,
                                           int causal, int qlimit,
                                           Window w) {
  const Seg<bf16> sg = seg_at(segs, c.si);
  if (c.k0 + BK < min(seg_stop(sg, causal, qlimit), w.hi))
    return {c.si, c.k0 + BK};
  return win_first(segs, c.si + 1, causal, qlimit, w);
}

// One (query tile, batch*head[, split piece]) block.  split_keys = 0:
// every key, O normalized into `out` (and lse).  Otherwise piece
// blockIdx.z covers keys [z split_keys, (z + 1) split_keys) and writes,
// per row r = (b Sq + qi) H + h, its unnormalized O to part_o[z][r][:]
// and (row max * scale_log2, row sum) to part_ml[z][r].
template <int D>
__global__ void __launch_bounds__(kAttnThreads, MmaFwdShape<D>::MIN_BLOCKS)
    attn_mma_kernel(const bf16* __restrict__ q, bf16* __restrict__ out,
                    float* __restrict__ lse, Segs<bf16> segs, int Sq, int H,
                    int KV, float scale_log2, int causal, int split_keys,
                    float* __restrict__ part_o,
                    float2* __restrict__ part_ml) {
  using S = MmaFwdShape<D>;
  constexpr int BQ = S::BQ, BK = S::BK, P = S::P, NK = S::NK, ND = S::ND,
                KS = S::KS, CPR = S::CPR;
  extern __shared__ __align__(16) unsigned char attn_mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(attn_mma_smem);   // BQ x P
  bf16* KVs = Qs + BQ * P;                             // 2 stages x (K, V)

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
    cp_async16(Qs + r * P + col * 8,
               q + (((long long)b * Sq + min(qi, Sq - 1)) * H + h) * D +
                   col * 8,
               qi < Sq);
  }
  auto load_tile = [&](Cursor cur, int stage) {
    const Seg<bf16> sg = seg_at(segs, cur.si);
    const int end = min(sg.end, win.hi);
    bf16* Kd = KVs + 2 * stage * BK * P;
    bf16* Vd = Kd + BK * P;
    for (int c = tid; c < BK * CPR; c += kAttnThreads) {
      const int r = c / CPR, col = c % CPR, key = cur.k0 + r;
      const bool ok = key < end;   // rows past the end are zero-filled
      const long long src =
          (((long long)b * sg.src_len + sg.src_row0 +
            (ok ? key - sg.begin : 0)) * KV + kvh) * D + col * 8;
      cp_async16(Kd + r * P + col * 8, sg.k + src, ok);
      cp_async16(Vd + r * P + col * 8, sg.v + src, ok);
    }
  };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8

  Cursor cur = win_first(segs, 0, causal, qlimit, win);
  if (cur.si < segs.n) load_tile(cur, 0);
  cp_async_commit();                 // Q and the first tile
  // Q's A fragments: rows 16 w + (lane & 15), 16-column half lane >> 4
  const bf16* qa = Qs + (16 * w + (lane & 15)) * P + (lane >> 4) * 8;
  unsigned qf[S::kQRegs ? KS : 1][4];
  if constexpr (S::kQRegs) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm4(qf[ks], qa + ks * 16);
  }
  // K's col-operand rows for an n-tile pair: (lane & 7) + 8 (lane >> 4),
  // 8-column half (lane >> 3) & 1
  const int koff =
      ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;

  int stage = 0;
  while (cur.si < segs.n) {
    const Cursor nxt = win_next<BK>(segs, cur, causal, qlimit, win);
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage's readers are done
    if (nxt.si < segs.n) load_tile(nxt, stage ^ 1);
    cp_async_commit();

    const bf16* Kt = KVs + 2 * stage * BK * P;
    const bf16* Vt = Kt + BK * P;
    // warp-uniform: no row of the warp sees a key of this tile
    if (!(causal && cur.k0 > iw + 15)) {
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned a[4];
        if constexpr (S::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
        } else {
          ldsm4(a, qa + ks * 16);
        }
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          unsigned bfr[4];
          ldsm4(bfr, Kt + koff + np * 16 * P + ks * 16);
          mma_bf16(s[2 * np], a, bfr[0], bfr[1]);
          mma_bf16(s[2 * np + 1], a, bfr[2], bfr[3]);
        }
      }

      const Seg<bf16> sg = seg_at(segs, cur.si);
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
      unsigned pa[NK / 2][4];
      to_a_frags<NK>(pa, s);           // P rounded to bf16
      mma_ab<ND, NK / 2, P>(o, pa, Vt, lane);
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
    bf16* po = out + row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<unsigned*>(po + 8 * n) =
          bf16x2_bits(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// One warp a row r = (b Sq + qi) H + h: merges the n split pieces of
// attn_mma_kernel by log-sum-exp in fp32, pieces in order, and writes the
// row of O in bf16 (and its lse).
__global__ void __launch_bounds__(kCombineThreads)
    attn_combine_kernel(const float* __restrict__ part_o,
                        const float2* __restrict__ part_ml,
                        bf16* __restrict__ out, float* __restrict__ lse,
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
    *reinterpret_cast<unsigned*>(out + (long long)row * D + c) =
        bf16x2_bits(acc.x * inv, acc.y * inv);
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

// Split the keys when the tile grid cannot fill the card's SMs once:
// enough pieces for every SM's resident blocks, each of at least
// kMinSplitTiles key tiles, at most kMaxSplits, the tiles spread evenly.
template <int D>
SplitPlan attn_split_plan(int B, int Sq, int Sk, int H, int sms) {
  using S = MmaFwdShape<D>;
  const long long tiles = (long long)((Sq + S::BQ - 1) / S::BQ) * B * H;
  const int ktiles = (Sk + S::BK - 1) / S::BK;
  if (tiles >= sms) return {1, 0};
  const long long want =
      ((long long)sms * S::MIN_BLOCKS + tiles - 1) / tiles;
  const int n = static_cast<int>(std::min(
      {want, (long long)(ktiles / kMinSplitTiles), (long long)kMaxSplits}));
  if (n < 2) return {1, 0};
  const int per = (ktiles + n - 1) / n;     // tiles a piece
  return {(ktiles + per - 1) / per, per * S::BK};
}

template <int D>
cudaError_t launch_attn_mma(const void* q, void* out, float* lse,
                            const Segs<bf16>& segs, int B, int Sq, int Sk,
                            int H, int KV, float sm_scale, int causal,
                            float* scratch, long long scratch_floats,
                            int device, cudaStream_t stream) {
  using S = MmaFwdShape<D>;
  cudaError_t err = allow_smem_once<attn_mma_kernel<D>>(S::kSmem, device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(device, &sms)) != cudaSuccess) return err;
  const SplitPlan sp = attn_split_plan<D>(B, Sq, Sk, H, sms);
  const dim3 grid((Sq + S::BQ - 1) / S::BQ, B * H, sp.n);
  const float scale_log2 = sm_scale * kLog2e;
  const bf16* qt = static_cast<const bf16*>(q);
  bf16* ot = static_cast<bf16*>(out);
  if (sp.n == 1) {
    attn_mma_kernel<D><<<grid, kAttnThreads, S::kSmem, stream>>>(
        qt, ot, lse, segs, Sq, H, KV, scale_log2, causal, 0, nullptr,
        nullptr);
    return cudaGetLastError();
  }
  const long long rows = (long long)B * Sq * H;
  if (scratch == nullptr || scratch_floats < sp.n * rows * (D + 2))
    return cudaErrorInvalidValue;
  float* part_o = scratch;
  float2* part_ml = reinterpret_cast<float2*>(scratch + sp.n * rows * D);
  attn_mma_kernel<D><<<grid, kAttnThreads, S::kSmem, stream>>>(
      qt, ot, lse, segs, Sq, H, KV, scale_log2, causal, sp.keys, part_o,
      part_ml);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(
      (rows * 32 + kCombineThreads - 1) / kCombineThreads);
  attn_combine_kernel<<<blocks, kCombineThreads, 0, stream>>>(
      part_o, part_ml, ot, lse, sp.n, static_cast<int>(rows), Sq, H, D);
  return cudaGetLastError();
}

#define GFDIT_ATTN_HEAD_DIMS(X) X(16) X(32) X(64) X(112) X(128) X(256)

cudaError_t dispatch_attn_mma(const void* q, void* out, float* lse,
                              const Segs<bf16>& segs, int B, int Sq, int Sk,
                              int H, int KV, int D, float sm_scale,
                              int causal, float* scratch,
                              long long scratch_floats, int device,
                              cudaStream_t stream) {
#define GFDIT_ATTN_MMA(DIM)                                                 \
  case DIM:                                                                 \
    return launch_attn_mma<DIM>(q, out, lse, segs, B, Sq, Sk, H, KV,        \
                                sm_scale, causal, scratch, scratch_floats,  \
                                device, stream);
  switch (D) {
    GFDIT_ATTN_HEAD_DIMS(GFDIT_ATTN_MMA)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ATTN_MMA
}

// The split pieces the bf16 kernel takes at this shape (1: none).
cudaError_t attn_splits(int B, int Sq, int Sk, int H, int D, int device,
                        int* n) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
#define GFDIT_ATTN_SPLITS(DIM)                                     \
  case DIM:                                                        \
    *n = attn_split_plan<DIM>(B, Sq, Sk, H, sms).n;                \
    return cudaSuccess;
  switch (D) {
    GFDIT_ATTN_HEAD_DIMS(GFDIT_ATTN_SPLITS)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ATTN_SPLITS
}

template <int D>
cudaError_t occupancy_attn_mma(int device, int* blocks, int* smem) {
  return occupancy_of<attn_mma_kernel<D>>(MmaFwdShape<D>::kSmem,
                                          kAttnThreads, device, blocks, smem);
}

}  // namespace gfdit

// q/out: (B, Sq, H, D); k/v: (B, Sk, KV, D); all contiguous, one dtype,
// 16-byte aligned (cp.async copies 16 bytes).  lse: null, or (B, H, Sq)
// fp32 to receive each row's log-sum-exp (the autograd path).  scratch:
// the bf16 split-key path's fp32 pieces, scratch_floats >= n B Sq H (D + 2)
// with n from gfdit_attention_splits (null where n = 1, and for fp32).
extern "C" int gfdit_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, float* scratch,
                               long long scratch_floats, int B, int Sq,
                               int Sk, int H, int KV, int D, int causal,
                               float sm_scale, int dtype, int device,
                               void* stream) {
  using namespace gfdit;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (causal && Sq != Sk) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_attn<float>(q, out, lse, plain_segs<float>(k, v, Sk), B,
                                Sq, H, KV, D, sm_scale, causal, device, s);
  if (dtype == kBFloat16)
    return dispatch_attn_mma(q, out, lse, plain_segs<bf16>(k, v, Sk), B, Sq,
                             Sk, H, KV, D, sm_scale, causal, scratch,
                             scratch_floats, device, s);
  return cudaErrorInvalidValue;
}

// q/out: (B, Sq, H, D); k_stale/v_stale: (B, Sk, KV, D);
// k_fresh/v_fresh: (B, L, KV, D) with 0 <= offset and offset + L <= Sk;
// scratch as gfdit_attention's.
extern "C" int gfdit_splice_attention(const void* q, const void* k_stale,
                                      const void* v_stale, const void* k_fresh,
                                      const void* v_fresh, void* out,
                                      float* scratch, long long scratch_floats,
                                      int B, int Sq, int Sk, int L, int H,
                                      int KV, int D, int offset,
                                      float sm_scale, int dtype, int device,
                                      void* stream) {
  using namespace gfdit;
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0 || L <= 0 || offset < 0 ||
      offset + L > Sk || !aligned16(q) || !aligned16(k_stale) ||
      !aligned16(v_stale) || !aligned16(k_fresh) || !aligned16(v_fresh) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_attn<float>(
        q, out, nullptr, splice_segs<float>(k_stale, v_stale, k_fresh, v_fresh, Sk, L, offset),
        B, Sq, H, KV, D, sm_scale, 0, device, s);
  if (dtype == kBFloat16)
    return dispatch_attn_mma(
        q, out, nullptr,
        splice_segs<bf16>(k_stale, v_stale, k_fresh, v_fresh, Sk, L, offset),
        B, Sq, Sk, H, KV, D, sm_scale, 0, scratch, scratch_floats, device, s);
  return cudaErrorInvalidValue;
}

// The pieces the bf16 kernel splits the keys of a (B, Sq, H) query grid
// over Sk key positions into (1: no split, and always for fp32).
extern "C" int gfdit_attention_splits(int B, int Sq, int Sk, int H, int D,
                                      int dtype, int device, int* n) {
  using namespace gfdit;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    *n = 1;
    return cudaSuccess;
  }
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  return attn_splits(B, Sq, Sk, H, D, device, n);
}

// Resident blocks per SM and dynamic shared bytes of the attention kernel
// of `dtype` at head dim D (fp32: attn_kernel, bf16: attn_mma_kernel),
// from the CUDA occupancy calculator.
extern "C" int gfdit_attention_occupancy(int D, int dtype, int device,
                                         int* blocks, int* smem) {
  using namespace gfdit;
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
#define GFDIT_OCC(DIM)                                                      \
  case DIM:                                                                 \
    return dtype == kFloat32                                                \
               ? occupancy_attn<float, DIM>(device, blocks, smem)           \
               : occupancy_attn_mma<DIM>(device, blocks, smem);
  switch (D) {
    GFDIT_ATTN_HEAD_DIMS(GFDIT_OCC)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_OCC
}

extern "C" const char* gfdit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
