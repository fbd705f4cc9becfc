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
//
// Backward (adaln_bwd_kernel + adaln_bwd_reduce_kernel).  The TPU kernel
// has no backward (the JAX package trains through its jnp LN/modulate);
// the port's training path needs one for every variant above.  With
// x^ = LN(x) (or x), y = x^ (1 + scale) + shift (or x^) and dy' =
// dy * gate (or dy): dresidual = dy, dgate = sum_n dy * y, dshift =
// sum_n dy', dscale = sum_n dy' * x^, and dx = rstd (dx^ - mean(dx^) -
// x^ mean(dx^ x^)) with dx^ = dy' (1 + scale) (dx = dx^ without LN); the
// sums run over the N tokens of a batch row, the means over D
// (ref.adaln_bwd_ref).  Bound on the card: bytes (x and dy read, dx and
// dresidual written).  One 256-thread block a tile of kAdaBwdRows token
// rows of one batch row: first a warp a row recomputes mean and rstd
// from x and the two row means of the dx formula; then each thread owns
// columns (tid + 256 j) and walks the tile's rows, writing dx and
// dresidual (x and dy again, now from L1/L2) and summing its columns'
// dshift/dscale/dgate terms in registers, which it stores as the tile's
// partial.  A second launch sums the partials of each (batch row,
// column) over the tiles in order: deterministic, no float atomics.
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

constexpr int kAdaBwdRows = 16;       // token rows a backward block
constexpr int kAdaBwdThreads = 256;

template <typename T, int NJ, bool LN, bool MOD, bool GATE>
__global__ void __launch_bounds__(kAdaBwdThreads)
    adaln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                     const T* __restrict__ scale, const T* __restrict__ gate,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     T* __restrict__ dres, float* __restrict__ partial, int n,
                     int d, float eps) {
  __shared__ float stats[kAdaBwdRows][4];  // mu, rstd, mean dx^, mean dx^x^
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = tile * kAdaBwdRows, nrows = min(n - r0, kAdaBwdRows);
  const long long mrow = static_cast<long long>(b) * d;
  const long long xrow0 = (static_cast<long long>(b) * n + r0) * d;

  if (LN) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < nrows; r += kAdaBwdThreads / 32) {
      const T* xr = x + xrow0 + static_cast<long long>(r) * d;
      const T* gr = dy + xrow0 + static_cast<long long>(r) * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += to_float(xr[c]);
      const float mu = warp_sum(s) / d;
      float q = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float u = to_float(xr[c]) - mu;
        q += u * u;
      }
      const float rstd = rsqrtf(warp_sum(q) / d + eps);
      float c1 = 0.f, c2 = 0.f;
      for (int c = lane; c < d; c += 32) {
        float g = to_float(gr[c]);
        if (GATE) g *= to_float(gate[mrow + c]);
        if (MOD) g *= 1.f + to_float(scale[mrow + c]);
        c1 += g;
        c2 = fmaf(g, (to_float(xr[c]) - mu) * rstd, c2);
      }
      c1 = warp_sum(c1) / d;
      c2 = warp_sum(c2) / d;
      if (lane == 0) {
        stats[r][0] = mu;
        stats[r][1] = rstd;
        stats[r][2] = c1;
        stats[r][3] = c2;
      }
    }
    __syncthreads();
  }

  float sh[NJ], sc[NJ], gt[NJ], ash[NJ], asc[NJ], ag[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = min(static_cast<int>(threadIdx.x) + kAdaBwdThreads * j,
                      d - 1);
    sh[j] = MOD ? to_float(shift[mrow + c]) : 0.f;
    sc[j] = MOD ? 1.f + to_float(scale[mrow + c]) : 1.f;
    gt[j] = GATE ? to_float(gate[mrow + c]) : 1.f;
    ash[j] = asc[j] = ag[j] = 0.f;
  }
  for (int r = 0; r < nrows; ++r) {
    const long long row = xrow0 + static_cast<long long>(r) * d;
    float mu = 0.f, rstd = 1.f, c1 = 0.f, c2 = 0.f;
    if (LN) {
      mu = stats[r][0];
      rstd = stats[r][1];
      c1 = stats[r][2];
      c2 = stats[r][3];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = threadIdx.x + kAdaBwdThreads * j;
      if (c < d) {
        const float xv = to_float(x[row + c]);
        const float xh = LN ? (xv - mu) * rstd : xv;
        float g = to_float(dy[row + c]);
        if (GATE) {
          ag[j] = fmaf(g, MOD ? fmaf(xh, sc[j], sh[j]) : xh, ag[j]);
          dres[row + c] = dy[row + c];
          g *= gt[j];
        }
        if (MOD) {
          ash[j] += g;
          asc[j] = fmaf(g, xh, asc[j]);
          g *= sc[j];
        }
        dx[row + c] = from_float<T>(LN ? rstd * (g - c1 - xh * c2) : g);
      }
    }
  }
  if (MOD || GATE) {
    float* pb = partial + (mrow * gridDim.x + static_cast<long long>(tile)
                           * d) * 3;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = threadIdx.x + kAdaBwdThreads * j;
      if (c < d) {
        if (MOD) {
          pb[c] = ash[j];
          pb[d + c] = asc[j];
        }
        if (GATE) pb[2 * d + c] = ag[j];
      }
    }
  }
}

// dshift/dscale/dgate[b, c] = the sum over tiles, in order, of the
// partials of (batch row b, column c).
template <typename T>
__global__ void __launch_bounds__(kAdaBwdThreads)
    adaln_bwd_reduce_kernel(const float* __restrict__ partial,
                            T* __restrict__ dshift, T* __restrict__ dscale,
                            T* __restrict__ dgate, int tiles, int d) {
  const int c = blockIdx.x * kAdaBwdThreads + threadIdx.x, b = blockIdx.y;
  if (c >= d) return;
  const float* pb = partial + static_cast<long long>(b) * tiles * 3 * d;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float* pt = pb + static_cast<long long>(t) * 3 * d;
    if (dshift != nullptr) {
      s0 += pt[c];
      s1 += pt[d + c];
    }
    if (dgate != nullptr) s2 += pt[2 * d + c];
  }
  const long long o = static_cast<long long>(b) * d + c;
  if (dshift != nullptr) {
    dshift[o] = from_float<T>(s0);
    dscale[o] = from_float<T>(s1);
  }
  if (dgate != nullptr) dgate[o] = from_float<T>(s2);
}

template <typename T, int NJ>
cudaError_t launch_adaln_bwd(const void* x, const void* shift,
                             const void* scale, const void* gate,
                             const void* dy, void* dx, void* dres,
                             float* partial, int B, int n, int d, int tiles,
                             int variant, cudaStream_t stream) {
  const dim3 grid(tiles, B);
#define GFDIT_ADALN_BWD(LN, MOD, GATE)                                       \
  adaln_bwd_kernel<T, NJ, LN, MOD, GATE><<<grid, kAdaBwdThreads, 0,         \
                                           stream>>>(                       \
      static_cast<const T*>(x), static_cast<const T*>(shift),               \
      static_cast<const T*>(scale), static_cast<const T*>(gate),            \
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(dres),\
      partial, n, d, 1e-6f);                                                \
  break;
  switch (variant) {  // bit 0: ln, bit 1: shift/scale, bit 2: gate/residual
    case 1: GFDIT_ADALN_BWD(true, false, false)
    case 2: GFDIT_ADALN_BWD(false, true, false)
    case 3: GFDIT_ADALN_BWD(true, true, false)
    case 4: GFDIT_ADALN_BWD(false, false, true)
    case 5: GFDIT_ADALN_BWD(true, false, true)
    case 6: GFDIT_ADALN_BWD(false, true, true)
    case 7: GFDIT_ADALN_BWD(true, true, true)
    default: return cudaErrorInvalidValue;
  }
#undef GFDIT_ADALN_BWD
  return cudaGetLastError();
}

}  // namespace gfdit

// x/dy/dx/dres: (B, n, d) contiguous; shift/scale/gate and their
// gradients: (B, d) contiguous, all of one dtype; absent operands null
// (dres and dgate with gate, dshift and dscale with shift).  partial:
// B * tiles * 3 * d fp32 scratch, tiles = ceil(n / 16), when shift or
// gate is given.
extern "C" int gfdit_adaln_bwd(const void* x, const void* shift,
                               const void* scale, const void* gate,
                               const void* dy, void* dx, void* dres,
                               void* dshift, void* dscale, void* dgate,
                               float* partial, int B, int n, int d, int tiles,
                               int ln, int dtype, int device, void* stream) {
  using namespace gfdit;
  const bool mod = shift != nullptr, gated = gate != nullptr;
  if (d <= 0 || d > kAdaMaxDim || B <= 0 || n <= 0 || B > 65535 ||
      tiles != (n + kAdaBwdRows - 1) / kAdaBwdRows ||
      mod != (scale != nullptr) || mod != (dshift != nullptr) ||
      mod != (dscale != nullptr) || gated != (dres != nullptr) ||
      gated != (dgate != nullptr) || ((mod || gated) && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const int variant = (ln ? 1 : 0) | (mod ? 2 : 0) | (gated ? 4 : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GFDIT_ADALN_BWD_NJ(T, NJ)                                           \
  if (d <= kAdaBwdThreads * NJ) {                                           \
    err = launch_adaln_bwd<T, NJ>(x, shift, scale, gate, dy, dx, dres,      \
                                  partial, B, n, d, tiles, variant, s);     \
    if (err == cudaSuccess && (mod || gated)) {                             \
      adaln_bwd_reduce_kernel<T>                                            \
          <<<dim3((d + kAdaBwdThreads - 1) / kAdaBwdThreads, B),            \
             kAdaBwdThreads, 0, s>>>(partial, static_cast<T*>(dshift),      \
                                     static_cast<T*>(dscale),               \
                                     static_cast<T*>(dgate), tiles, d);     \
      err = cudaGetLastError();                                             \
    }                                                                       \
    return err;                                                             \
  }
  if (dtype == kFloat32) {
    GFDIT_ADALN_BWD_NJ(float, 1)
    GFDIT_ADALN_BWD_NJ(float, 4)
    GFDIT_ADALN_BWD_NJ(float, 16)
  } else if (dtype == kBFloat16) {
    GFDIT_ADALN_BWD_NJ(__nv_bfloat16, 1)
    GFDIT_ADALN_BWD_NJ(__nv_bfloat16, 4)
    GFDIT_ADALN_BWD_NJ(__nv_bfloat16, 16)
  }
#undef GFDIT_ADALN_BWD_NJ
  return cudaErrorInvalidValue;
}

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
