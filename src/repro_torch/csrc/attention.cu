// Flash attention and the §11 cache-splice attention, one kernel template.
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
//
// Bound on the card: operations.  Per (query, key) pair the kernel does 2d
// flops for QK^T and 2d for PV, all in fp32 on the CUDA cores: 67 TFLOP/s
// on an H100 SXM, four warp-wide FMAs an SM a clock.  The tensor cores are
// not used: the DiT path runs fp32 with TF32 off and holds each kernel to
// its plain version within 1e-5 (DESIGN.md §12), and TF32 keeps ~1e-3.
// An SM serves one 128-byte shared-memory wavefront a clock, so the two
// products reach the FMA rate only if each wavefront feeds >= 4 FMAs.
//
// Design: one 128-thread block (4 warps) per (batch*head, BQ-query tile);
// BQ = 64 (32 at d=256).  Keys come in tiles of 32.
//   * Register blocking.  Lane (rg = lane/8, kg = lane%8) of warp w owns
//     A = 4 query rows (w*16 + 4a + rg) and 4 keys (kg + 8t) of the score
//     tile, and the same rows times d/8 columns of the output.  Q, K and V
//     sit in shared memory row-major with a 16-byte pad, so a lane reads 4
//     consecutive d-values of a row as one 16-byte load (8 bytes in bf16),
//     the 4 query rows of one load instruction are broadcast over the 8
//     key lanes, and the 8 key rows of one load fall in distinct banks.
//     QK^T: per 4 d-values, 8 loads of one wavefront each feed 64 FMAs,
//     8 FMAs a wavefront.  PV: per key, one P load (4 rows) and d/32 V
//     loads of one wavefront each feed 4*d/8 FMAs, 10.7 a wavefront at
//     d=64.  (A 4x4 micro-tile read by scalar loads, one row of Q and K
//     a load, feeds 2 in both: 16 FMAs per 8 loads.)
//   * A warp's 16 rows see all 32 keys of a tile, so the softmax's row
//     max is a 3-step shuffle among the 8 key lanes, the row sum is kept
//     per lane and reduced once at the end, and P goes to a per-warp
//     shared buffer (written as one 16-byte store per key, read back as
//     one 16-byte load) behind a __syncwarp, not a block barrier.
//   * K/V tiles arrive by 16-byte cp.async.cg into two stages: tile j+1
//     is in flight while tile j is computed, with one block barrier per
//     tile.  Rows past a segment's end are zero-filled by the copy and
//     their scores masked to -1e30 (fp32 score space); interior tiles skip
//     the mask.  bf16 is staged raw and converted on each shared read.
//   * exp2f with log2(e) folded into sm_scale (the MUFU ex2).
//   * Shared memory (fp32, d=64): Q 17.0 KB, two K/V stages 34.0 KB, P
//     8 KB, 59 KB a block: 3 blocks (12 warps) an SM, so the DiT's 384
//     blocks at Sq=1024 x 24 heads fit one wave on 132 SMs.  d=128 takes
//     2 blocks an SM; d=256 halves BQ and takes 1.
//   * Head dim 112 (zamba2-7b's shared attention): 32 does not divide it,
//     so a lane owns 7 pairs of output columns (VW = 2, one 8-byte V load
//     per pair: 8 FMAs a load, half of d=128's 16) instead of padding the
//     tile to 128 columns, whose masked 16 would cost 1/8 of the FMAs.
//     QK^T still reads 4 d-values a load (112 = 28 x 4).  Rows of 116
//     floats keep the 8 key rows of a load on distinct banks (29 16-byte
//     units a row, odd).  Shared memory (fp32): Q 29.0 KB, two K/V stages
//     58.0 KB, P 8 KB, 95.0 KB a block: 2 blocks an SM, as at d=128.
//   * Log-sum-exp.  For a training caller the epilogue also writes each
//     query row's log-sum-exp of its scaled scores, (B, H, Sq) fp32 in
//     natural-log units (m is kept in raw score units and the exp is
//     exp2 with log2(e) folded into the scale, so
//     lse = (m * scale_log2 + log2(l)) * ln 2), which the backward
//     kernels of attention_bwd.cu read to recompute P.  A null lse
//     pointer (the serving path and the splice) writes nothing.
// The key axis is walked as up to three segments, each read from ONE
// source tensor: plain attention has one; the splice has stale
// [0, offset), fresh [offset, offset+L) and stale [offset+L, Sk), so no
// per-row select is needed, and the stage pipeline runs across segments.
#include "common.cuh"

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

}  // namespace gfdit

// q/out: (B, Sq, H, D); k/v: (B, Sk, KV, D); all contiguous, one dtype,
// 16-byte aligned (cp.async copies 16 bytes).  lse: null, or (B, H, Sq)
// fp32 to receive each row's log-sum-exp (the autograd path).
extern "C" int gfdit_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int Sq, int Sk,
                               int H, int KV, int D, int causal,
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
    return dispatch_attn<__nv_bfloat16>(
        q, out, lse, plain_segs<__nv_bfloat16>(k, v, Sk), B, Sq, H, KV, D,
        sm_scale, causal, device, s);
  return cudaErrorInvalidValue;
}

// q/out: (B, Sq, H, D); k_stale/v_stale: (B, Sk, KV, D);
// k_fresh/v_fresh: (B, L, KV, D) with 0 <= offset and offset + L <= Sk.
extern "C" int gfdit_splice_attention(const void* q, const void* k_stale,
                                      const void* v_stale, const void* k_fresh,
                                      const void* v_fresh, void* out, int B,
                                      int Sq, int Sk, int L, int H, int KV,
                                      int D, int offset, float sm_scale,
                                      int dtype, int device, void* stream) {
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
    return dispatch_attn<__nv_bfloat16>(
        q, out, nullptr,
        splice_segs<__nv_bfloat16>(k_stale, v_stale, k_fresh, v_fresh, Sk, L, offset),
        B, Sq, H, KV, D, sm_scale, 0, device, s);
  return cudaErrorInvalidValue;
}

// Resident blocks per SM and dynamic shared bytes of the attention kernel
// at head dim D, from the CUDA occupancy calculator.
extern "C" int gfdit_attention_occupancy(int D, int dtype, int device,
                                         int* blocks, int* smem) {
  using namespace gfdit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
#define GFDIT_OCC(DIM)                                                      \
  case DIM:                                                                 \
    return dtype == kFloat32                                                \
               ? occupancy_attn<float, DIM>(device, blocks, smem)           \
               : occupancy_attn<__nv_bfloat16, DIM>(device, blocks, smem);
  switch (D) {
    GFDIT_OCC(16)
    GFDIT_OCC(32)
    GFDIT_OCC(64)
    GFDIT_OCC(112)
    GFDIT_OCC(128)
    GFDIT_OCC(256)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_OCC
}

extern "C" const char* gfdit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
