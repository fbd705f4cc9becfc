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
// flops for QK^T and 2d for PV in fp32 on the CUDA cores (67 TFLOP/s on an
// H100 SXM), while K/V tiles are reused by all 64 queries of a block, so
// bytes are far from the limit at the DiT's shapes.
//
// Design (simple and right first): one 256-thread block per
// (batch*head, 64-query tile).  The scaled Q tile and each 64-key K/V tile
// are staged in shared memory as fp32; a 16x16 thread grid computes the
// 64x64 score tile (4x4 a thread), masks it, and runs the online softmax
// with the running max, denominator and the (64 x d) accumulator held in
// registers (rows ty+16i, columns tx+16j, so the 16 threads of one row sit
// in one half-warp and reduce by shuffles).  Shared rows are padded by one
// float so that neither the QK^T nor the PV loop has bank conflicts.  The
// key axis is walked as up to three segments, each read from ONE source
// tensor: plain attention has one; the splice has stale [0, offset), fresh
// [offset, offset+L) and stale [offset+L, Sk), so no per-row select is
// needed.  No tensor cores yet: that is the next step for speed.
#include "common.cuh"

namespace gfdit {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kAttnThreads = 256;
constexpr float kNegInf = -1e30f;  // fill in fp32 score space only

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

template <int D>
constexpr size_t attn_smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
    attn_kernel(const T* __restrict__ q, T* __restrict__ out, Segs<T> segs,
                int Sq, int H, int KV, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // kBQ x (D + 1)
  float* Ks = Qs + kBQ * (D + 1);    // kBK x (D + 1)
  float* Vs = Ks + kBK * (D + 1);    // kBK x D
  float* Ps = Vs + kBK * D;          // kBQ x (kBK + 1)
  constexpr int DC = D / 16;         // accumulator columns a thread owns

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);      // GQA: q head -> kv head
  const int q0 = blockIdx.x * kBQ;

  for (int i = tid; i < kBQ * D; i += kAttnThreads) {
    const int r = i / D, c = i % D, qi = q0 + r;
    float val = 0.f;
    if (qi < Sq) val = to_float(q[(((long long)b * Sq + qi) * H + h) * D + c]);
    Qs[r * (D + 1) + c] = val * sm_scale;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int si = 0; si < segs.n; ++si) {
    const Seg<T> sg = segs.s[si];
    // causal block skip: keys past this tile's last query are never visited
    const int stop = causal ? min(sg.end, q0 + kBQ) : sg.end;
    for (int k0 = sg.begin; k0 < stop; k0 += kBK) {
      __syncthreads();  // Q staged / the previous tile's readers are done
      for (int i = tid; i < kBK * D; i += kAttnThreads) {
        const int r = i / D, c = i % D, key = k0 + r;
        float kval = 0.f, vval = 0.f;
        if (key < sg.end) {
          const long long src =
              (((long long)b * sg.src_len + sg.src_row0 + (key - sg.begin)) *
                   KV + kvh) * D + c;
          kval = to_float(sg.k[src]);
          vval = to_float(sg.v[src]);
        }
        Ks[r * (D + 1) + c] = kval;
        Vs[r * D + c] = vval;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D; ++kk) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (D + 1) + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * (D + 1) + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (key >= sg.end || (causal && key > qi)) s[i][j] = kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        for (int o = 8; o > 0; o >>= 1)  // the 16 lanes of this row
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
          rs += p;
        }
        for (int o = 8; o > 0; o >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, o);
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float vv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch_attn(const void* q, void* out, const Segs<T>& segs, int B,
                        int Sq, int H, int KV, float sm_scale, int causal,
                        cudaStream_t stream) {
  constexpr size_t smem = attn_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  attn_kernel<T, D><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(out), segs, Sq, H, KV,
      sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_attn(const void* q, void* out, const Segs<T>& segs, int B,
                          int Sq, int H, int KV, int D, float sm_scale,
                          int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_attn<T, 16>(q, out, segs, B, Sq, H, KV, sm_scale, causal, stream);
    case 32: return launch_attn<T, 32>(q, out, segs, B, Sq, H, KV, sm_scale, causal, stream);
    case 64: return launch_attn<T, 64>(q, out, segs, B, Sq, H, KV, sm_scale, causal, stream);
    case 128: return launch_attn<T, 128>(q, out, segs, B, Sq, H, KV, sm_scale, causal, stream);
    case 256: return launch_attn<T, 256>(q, out, segs, B, Sq, H, KV, sm_scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
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

}  // namespace gfdit

// q/out: (B, Sq, H, D); k/v: (B, Sk, KV, D); all contiguous, one dtype.
extern "C" int gfdit_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int H, int KV,
                               int D, int causal, float sm_scale, int dtype,
                               int device, void* stream) {
  using namespace gfdit;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (causal && Sq != Sk))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_attn<float>(q, out, plain_segs<float>(k, v, Sk), B, Sq, H,
                                KV, D, sm_scale, causal, s);
  if (dtype == kBFloat16)
    return dispatch_attn<__nv_bfloat16>(q, out,
                                        plain_segs<__nv_bfloat16>(k, v, Sk), B,
                                        Sq, H, KV, D, sm_scale, causal, s);
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
      offset + L > Sk)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_attn<float>(
        q, out, splice_segs<float>(k_stale, v_stale, k_fresh, v_fresh, Sk, L, offset),
        B, Sq, H, KV, D, sm_scale, 0, s);
  if (dtype == kBFloat16)
    return dispatch_attn<__nv_bfloat16>(
        q, out,
        splice_segs<__nv_bfloat16>(k_stale, v_stale, k_fresh, v_fresh, Sk, L, offset),
        B, Sq, H, KV, D, sm_scale, 0, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* gfdit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
