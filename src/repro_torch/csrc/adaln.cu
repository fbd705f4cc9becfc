// Fused adaLN-Zero modulate: (LN ->) shift/scale (-> gate -> residual add).
//
// Replaces the TPU kernel src/repro/kernels/adaln.py::adaln_modulate
// (_adaln_kernel): per token row, an fp32 LayerNorm (eps 1e-6, mean, then
// the variance of x - mean), then x*(1+scale)+shift, then
// residual + gate*x, with the stages chosen statically.  The variants the
// DiT uses are the modulated norm (bare LN when shift/scale are absent),
// the gated residual with ln=False, and the full fusion.
//
// Bound on the card: bytes.  A row of D=1536 does ~10 flops per element
// against 8-12 bytes moved per element, far below the H100's ~20 flops
// per fp32 byte, so the floor is reading x (and residual) once and
// writing out once: 12.6 MB, 3.8 us at 3.35 TB/s for the DiT's
// (1024, 1536) fp32 shard.  At that size a launch is a few microseconds,
// so what costs time is latency: how many loads are in flight at once,
// and how long the reductions keep them waiting.
//
// Design: one warp per token row, kAdaRows rows per 128-thread block, so
// the two reductions (mean, then variance, as the reference computes
// them) are warp shuffles with no shared memory and no block barrier.
// A lane holds NV vectors of V elements of the row in registers (V = 16
// bytes of T: a float4, or 8 bf16), so every load and store is one
// 16-byte access and neighbouring lanes touch neighbouring vectors; NV is
// a template parameter (12 float4 a lane at D=1536 fp32, 32 at D=4096).
// Before the first reduction the lane issues every load of its row at
// once: x, and also residual and the (B, D) modulation rows when their
// values, as fp32, fit the register budget (kEarlyBytes; at D=1536 that
// is every LN variant but the full fusion).  Otherwise those are read
// after the reductions, the modulation rows from L1/L2, where all rows
// of a batch reuse them.  x is read once and out written once.  When D
// is not a multiple of V or a pointer is not 16-byte aligned, the same
// template runs with V = 1 (scalar accesses), chosen at launch.
#include "common.cuh"

namespace gfdit {

constexpr int kAdaRows = 4;                 // rows (warps) per block
constexpr int kAdaThreads = 32 * kAdaRows;
constexpr int kAdaMaxDim = 4096;
constexpr int kEarlyBytes = 640;  // fp32 bytes a lane may load before the LN

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V, int NV, bool LN, bool MOD, bool GATE>
__global__ void __launch_bounds__(kAdaThreads)
    adaln_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                 const T* __restrict__ scale, const T* __restrict__ gate,
                 const T* __restrict__ residual, T* __restrict__ out,
                 int rows, int n, int d, float eps) {
  using P = Pack<T, V>;
  constexpr int kTensors = 1 + (MOD ? 2 : 0) + (GATE ? 2 : 0);
  // early loads only hide latency behind the reductions; counted as the
  // fp32 values they become (bf16 x is held converted through both)
  constexpr bool kEarly = LN && NV * V * 4 * kTensors <= kEarlyBytes;
  constexpr int NE = kEarly ? NV : 1;       // sizes of the early buffers
  constexpr bool kBranchy = LN && !kEarly && NV * V >= 128;

  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kAdaRows + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warps leave together
  const int nvec = d / V;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  P* outr = reinterpret_cast<P*>(out + row * d);
  const long long mrow = (row / n) * d;     // this row's (B, D) row
  const P* shr = reinterpret_cast<const P*>(shift + (MOD ? mrow : 0));
  const P* scr = reinterpret_cast<const P*>(scale + (MOD ? mrow : 0));
  const P* gr = reinterpret_cast<const P*>(gate + (GATE ? mrow : 0));
  const P* rr = reinterpret_cast<const P*>(residual + (GATE ? row * d : 0));

  // Loads take an index clamped into the row, so none sits behind a
  // branch and the compiler can issue them all at once; only the padding
  // lanes' sums and stores are masked.
  P xv[NV], shv[NE], scv[NE], gv[NE], rv[NE];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = min(lane + 32 * j, nvec - 1);
    xv[j] = xr[c];
    if constexpr (kEarly && MOD) {
      shv[j] = shr[c];
      scv[j] = scr[c];
    }
    if constexpr (kEarly && GATE) {
      gv[j] = gr[c];
      rv[j] = rr[c];
    }
  }

  float mu = 0.f, rstd = 1.f;
  if (LN) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) t += to_float(xv[j].v[e]);
      s += lane + 32 * j < nvec ? t : 0.f;
    }
    mu = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float u = to_float(xv[j].v[e]) - mu;
        t += u * u;
      }
      q += lane + 32 * j < nvec ? t : 0.f;
    }
    rstd = rsqrtf(warp_sum(q) / d + eps);
  }

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    // Rows of over 3072 elements read after the LN: free to hoist every
    // load, the compiler spills, so each vector's loads wait behind its
    // bounds test (never at the DiT's D=1536, whose loads all go out at
    // once).
    if constexpr (kBranchy)
      if (lane + 32 * j >= nvec) continue;
    const int c = min(lane + 32 * j, nvec - 1);
    P sh, sc, g, r, o;
    if (MOD) {
      sh = kEarly ? shv[j % NE] : shr[c];
      sc = kEarly ? scv[j % NE] : scr[c];
    }
    if (GATE) {
      g = kEarly ? gv[j % NE] : gr[c];
      r = kEarly ? rv[j % NE] : rr[c];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float v = to_float(xv[j].v[e]);
      if (LN) v = (v - mu) * rstd;
      if (MOD) v = v * (1.f + to_float(sc.v[e])) + to_float(sh.v[e]);
      if (GATE) v = to_float(r.v[e]) + to_float(g.v[e]) * v;
      o.v[e] = from_float<T>(v);
    }
    if (lane + 32 * j < nvec) outr[c] = o;
  }
}

template <typename T, int V, int NV>
cudaError_t launch_adaln(const void* x, const void* shift, const void* scale,
                         const void* gate, const void* residual, void* out,
                         int rows, int n, int d, int variant,
                         cudaStream_t stream) {
  const dim3 grid((rows + kAdaRows - 1) / kAdaRows);
#define GFDIT_ADALN(LN, MOD, GATE)                                           \
  adaln_kernel<T, V, NV, LN, MOD, GATE><<<grid, kAdaThreads, 0, stream>>>(  \
      static_cast<const T*>(x), static_cast<const T*>(shift),               \
      static_cast<const T*>(scale), static_cast<const T*>(gate),            \
      static_cast<const T*>(residual), static_cast<T*>(out), rows, n, d,    \
      1e-6f);                                                               \
  break;
  switch (variant) {  // bit 0: ln, bit 1: shift/scale, bit 2: gate/residual
    case 1: GFDIT_ADALN(true, false, false)
    case 2: GFDIT_ADALN(false, true, false)
    case 3: GFDIT_ADALN(true, true, false)
    case 4: GFDIT_ADALN(false, false, true)
    case 5: GFDIT_ADALN(true, false, true)
    case 6: GFDIT_ADALN(false, true, true)
    case 7: GFDIT_ADALN(true, true, true)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ADALN
  return cudaGetLastError();
}

// Picks the smallest instantiated NV (vectors a lane) that covers
// ceil(nvec / 32): the vector path at the DiT's D=1536 runs with no
// idle register (12 float4, 6 x 8 bf16).
template <typename T, int V>
cudaError_t dispatch_nv(const void* x, const void* shift, const void* scale,
                        const void* gate, const void* residual, void* out,
                        int rows, int n, int d, int variant,
                        cudaStream_t stream) {
  const int per_lane = (d / V + 31) / 32;
#define GFDIT_NV(NV)                                                       \
  if constexpr (32 * V * NV <= kAdaMaxDim) /* a class some D can need */   \
    if (per_lane <= NV)                                                    \
      return launch_adaln<T, V, NV>(x, shift, scale, gate, residual, out,  \
                                    rows, n, d, variant, stream);
  if constexpr (V == 1) {  // the scalar path: D up to 256, 1024, 4096
    GFDIT_NV(8)
    GFDIT_NV(32)
    GFDIT_NV(128)
  } else {
    GFDIT_NV(1)
    GFDIT_NV(2)
    GFDIT_NV(4)
    GFDIT_NV(6)
    GFDIT_NV(8)
    GFDIT_NV(12)
    GFDIT_NV(16)
    GFDIT_NV(24)
    GFDIT_NV(32)
  }
#undef GFDIT_NV
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <typename T>
cudaError_t dispatch_adaln(const void* x, const void* shift, const void* scale,
                           const void* gate, const void* residual, void* out,
                           int rows, int n, int d, int variant,
                           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && aligned16(x) && aligned16(out) &&
                   (shift == nullptr ||
                    (aligned16(shift) && aligned16(scale))) &&
                   (gate == nullptr ||
                    (aligned16(gate) && aligned16(residual)));
  if (vec)
    return dispatch_nv<T, V>(x, shift, scale, gate, residual, out, rows, n,
                             d, variant, stream);
  return dispatch_nv<T, 1>(x, shift, scale, gate, residual, out, rows, n, d,
                           variant, stream);
}

}  // namespace gfdit

// x/residual/out: (rows = B*N, d) contiguous; shift/scale/gate: (B, d)
// contiguous, all of one dtype.  Absent operands are null.
extern "C" int gfdit_adaln(const void* x, const void* shift, const void* scale,
                           const void* gate, const void* residual, void* out,
                           int rows, int n, int d, int ln, int dtype,
                           int device, void* stream) {
  using namespace gfdit;
  if (d <= 0 || d > kAdaMaxDim || rows <= 0 || n <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const int variant =
      (ln ? 1 : 0) | (shift != nullptr ? 2 : 0) | (gate != nullptr ? 4 : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_adaln<float>(x, shift, scale, gate, residual, out, rows, n,
                                 d, variant, s);
  if (dtype == kBFloat16)
    return dispatch_adaln<__nv_bfloat16>(x, shift, scale, gate, residual, out,
                                         rows, n, d, variant, s);
  return cudaErrorInvalidValue;
}
