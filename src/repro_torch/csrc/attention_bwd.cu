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
// dS = P * (dO V^T - D):  dV = P^T dO,  dK = scale dS^T Q,
// dQ = scale dS K.  Three launches:
//   1. attn_bwd_delta_kernel: D, one warp a (batch, query, head) row.
//   2. attn_bwd_dkdv_kernel: one block a (batch, KV head, key tile).  It
//      holds its K and V tile in shared memory and dK, dV in registers,
//      and walks the H/KV query heads of its GQA group and their query
//      tiles (from the diagonal on when causal), recomputing P and dS
//      per tile.
//   3. attn_bwd_dq_kernel: one block a (batch, head, query tile), walking
//      the key tiles (up to the diagonal when causal).
// No atomics: each output element is summed by one thread in a fixed
// order, so the result is deterministic.  Masked entries (a ragged edge,
// above the causal diagonal) get P = 0 in fp32 score space, as the plain
// version's -1e30 fill gives.  Everything accumulates in fp32; operands
// are converted to fp32 as they are staged into shared memory, and the
// outputs are written in the inputs' dtype.
//
// Bound on the card: operations.  Five products of 2 d flops per (query,
// key) pair (S again, dP, dV, dK, dQ; the dQ kernel recomputes S and dP
// too), fp32 on the CUDA cores.  Design, simple first: 256 threads as a
// 16 x 16 grid; a BT x BT score tile (BT = 64, 32 at d = 256) gives each
// thread RT x RT entries (rows ty + 16a, columns tx + 16t) and a
// BT x d output tile RT x d/16 entries (columns tx + 16u).  Shared rows
// are fp32 with an odd pitch (d + 1, BT + 1), so the 16 rows one load
// instruction reads fall in 16 distinct banks and the other operand is a
// broadcast.  No cp.async, no tensor cores: wgmma and TMA are later work.
// Shared memory: 4 BT x (d + 1) tiles and 2 BT x (BT + 1) tiles, 100 KB
// at d = 64 (2 blocks an SM), 166 KB at d = 128 (one).
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

// Rows [r0, r0 + BT) of head `head` of a (B, S, NH, D) tensor into a
// BT x (D + 1) fp32 shared tile; rows past S are zero.
template <typename T, int D, int BT>
__device__ __forceinline__ void load_rows(float* dst,
                                          const T* __restrict__ src, int b,
                                          int r0, int S, int NH, int head) {
  constexpr int PD = D + 1;
  for (int idx = threadIdx.x; idx < BT * D; idx += kBwdThreads) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    dst[r * PD + c] =
        row < S ? to_float(src[((static_cast<long long>(b) * S + row) * NH +
                                head) * D + c])
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

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                         float scale, int causal) {
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
  load_rows<T, D, BT>(Ks, k, b, k0, Sk, KV, kvh);
  load_rows<T, D, BT>(Vs, v, b, k0, Sk, KV, kvh);

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
      load_rows<T, D, BT>(Qs, q, b, q0, Sq, H, h);
      load_rows<T, D, BT>(dOs, dout, b, q0, Sq, H, h);
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
      dk[base + tx + 16 * u] = from_float<T>(dka[a][u] * scale);
      dv[base + tx + 16 * u] = from_float<T>(dva[a][u]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int Sq, int Sk, int H, int KV, float scale,
                       int causal) {
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
  load_rows<T, D, BT>(Qs, q, b, q0, Sq, H, h);
  load_rows<T, D, BT>(dOs, dout, b, q0, Sq, H, h);
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
    load_rows<T, D, BT>(Ks, k, b, k0, Sk, KV, kvh);
    load_rows<T, D, BT>(Vs, v, b, k0, Sk, KV, kvh);
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
      dq[base + tx + 16 * u] = from_float<T>(dqa[a][u] * scale);
  }
}

template <typename T, int D>
cudaError_t launch_attn_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse,
                            void* dq, void* dk, void* dv, float* delta, int B,
                            int Sq, int Sk, int H, int KV, float sm_scale,
                            int causal, int device, cudaStream_t stream) {
  using S = BwdShape<D>;
  cudaError_t err =
      allow_smem_once<attn_bwd_dkdv_kernel<T, D>>(S::kSmem, device);
  if (err != cudaSuccess) return err;
  err = allow_smem_once<attn_bwd_dq_kernel<T, D>>(S::kSmem, device);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  attn_bwd_delta_kernel<T><<<(rows + kBwdThreads / 32 - 1) /
                                 (kBwdThreads / 32),
                             kBwdThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, rows, Sq, H, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, D>
      <<<dim3((Sk + S::BT - 1) / S::BT, B * KV), kBwdThreads, S::kSmem,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                   static_cast<T*>(dv), Sq, Sk, H, KV, sm_scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, D>
      <<<dim3((Sq + S::BT - 1) / S::BT, B * H), kBwdThreads, S::kSmem,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk,
                   H, KV, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, void* dq, void* dk, void* dv,
                              float* delta, int B, int Sq, int Sk, int H,
                              int KV, int D, float sm_scale, int causal,
                              int device, cudaStream_t stream) {
#define GFDIT_ATTN_BWD(DIM)                                                 \
  case DIM:                                                                 \
    return launch_attn_bwd<T, DIM>(q, k, v, o, dout, lse, dq, dk, dv,       \
                                   delta, B, Sq, Sk, H, KV, sm_scale,       \
                                   causal, device, stream);
  switch (D) {
    GFDIT_ATTN_BWD(16)
    GFDIT_ATTN_BWD(32)
    GFDIT_ATTN_BWD(64)
    GFDIT_ATTN_BWD(112)
    GFDIT_ATTN_BWD(128)
    GFDIT_ATTN_BWD(256)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ATTN_BWD
}

}  // namespace gfdit

// q/o/dout/dq: (B, Sq, H, D); k/v/dk/dv: (B, Sk, KV, D), all contiguous
// and of one dtype; lse and the scratch delta: (B, H, Sq) fp32.
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
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_attn_bwd<float>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                    B, Sq, Sk, H, KV, D, sm_scale, causal,
                                    device, s);
  if (dtype == kBFloat16)
    return dispatch_attn_bwd<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk,
                                            dv, delta, B, Sq, Sk, H, KV, D,
                                            sm_scale, causal, device, s);
  return cudaErrorInvalidValue;
}
