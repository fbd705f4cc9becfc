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
// Backward (adaln_bwd_kernel + adaln_bwd_cols_kernel).  The TPU kernel
// has no backward (the JAX package trains through its jnp LN/modulate);
// the port's training path needs one for every variant above.  With
// x^ = LN(x) (or x), y = x^ (1 + scale) + shift (or x^) and dy' =
// dy * gate (or dy): dresidual = dy, dgate = sum_n dy * y, dshift =
// sum_n dy', dscale = sum_n dy' * x^, and dx = rstd (dx^ - mean(dx^) -
// x^ mean(dx^ x^)) with dx^ = dy' (1 + scale) (dx = dx^ without LN); the
// sums run over the N tokens of a batch row, the means over D
// (ref.adaln_bwd_ref).  dresidual is dy itself: nothing is written for
// it.  Bound on the card: bytes (x and dy read once, dx written once).
// Design: a team of 32 * tw threads works on one token row at a time;
// each lane holds NV 16-byte vectors of x and dy (at D=1536: 4 warps of
// 3 float4 a lane, or 6 warps of 8 bf16), converted to fp32 once, so the
// row is read from DRAM once.  mean, rstd and the two row means of the
// dx formula come from those registers: warp shuffles, then one
// shared-memory exchange across the team's warps under a barrier of the
// team's threads alone.  Rows reach a team through a ring of kBwdStages
// shared-memory stages filled by 16-byte cp.async (each thread copies
// the vectors it will read back, so no barrier guards the ring): two
// rows are in flight while it works on a third.  A block holds two
// teams (one when a row needs more than 8 warps or two would not fit in
// shared memory) and walks a contiguous run of rows of one
// batch row; each thread owns the same columns on every row and sums
// their dshift/dscale/dgate terms in registers, the modulation rows
// staged once in shared memory.  At the end the teams add their sums
// into shared memory in team order and the block writes one partial row
// a sum.  The rule bwd_rows picks the rows a block so the grid is
// kBwdBlocksPerSm blocks an SM; the wrapper sizes the partials' scratch
// by the same rule (gfdit_adaln_bwd_scratch).  A second launch sums each
// column's partials over the blocks of its batch row in a fixed order
// (deterministic, no float atomics).  When D is not a multiple of the
// vector or a pointer is not 16-byte aligned, the same template runs
// with V = 1 (plain copies into the ring).
#include <algorithm>

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

constexpr int kBwdMaxThreads = 512;    // two teams of 8 warps, or one of 16
constexpr int kBwdStages = 3;          // rows a team has staged or in work
constexpr int kBwdBlocksPerSm = 2;     // the grid the row rule aims at
constexpr int kBwdColGroups = 16;      // partial rows the column kernel
                                       // sums at once, a warp each
// dynamic shared bytes a block may ask for (a plan that would need more
// runs one team a block; the most any takes is 180 KB, fp32 at D=3072)
constexpr int kBwdMaxSmem = 200 * 1024;

// The barrier of one team's threads (named barrier team + 1; 0 is
// __syncthreads).
__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(threads)
               : "memory");
}

// Each v[k] summed over the team's lanes: shuffles, then the team's warp
// sums from shared memory in warp order (every lane gets the same bits).
// red holds a row per warp of the block; each reduction of a row uses its
// own red, so a warp that runs ahead cannot overwrite a value another
// warp has yet to read.
template <int K>
__device__ __forceinline__ void team_sum(float (&v)[K], float (*red)[2],
                                         int team, int tw) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (tw == 1) return;
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[w][k] = v[k];
  }
  team_sync(team, 32 * tw);
  const int w0 = team * tw;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int i = 0; i < tw; ++i) s += red[w0 + i][k];
    v[k] = s;
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One vector of a row into the team's stage: an asynchronous 16-byte copy
// (L2 only), or a plain copy on the scalar path.
template <typename T, int V>
__device__ __forceinline__ void stage_copy(Pack<T, V>* dst,
                                           const Pack<T, V>* src) {
  if constexpr (sizeof(T) * V == 16)
    cp_async16(dst, src, true);
  else
    *dst = *src;
}

// Shared bytes of a row-kernel block: each team's kBwdStages stages of x
// and dy (lanes * NV vectors each), then kSums rows of lanes * NV * V
// floats (the modulation rows, then the block's sums).
template <typename T, int V, int NV>
constexpr size_t bwd_smem(int tw, int teams, int sums) {
  return (sizeof(T) * V * kBwdStages * 2 * teams + sizeof(float) * V * sums) *
         32 * tw * NV;
}

// Rows [chunk * rows, +rows) of batch row b = blockIdx.x / chunks.  Each
// thread copies, and later reads back, only its own vectors of a stage,
// so the staging needs no barrier: a cp.async group a row, waited for
// kBwdStages - 2 rows ahead.  In the shared region slot c is column c.
template <typename T, int V, int NV, bool LN, bool MOD, bool GATE>
__global__ void __launch_bounds__(kBwdMaxThreads)
    adaln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                     const T* __restrict__ scale, const T* __restrict__ gate,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partial, int n, int d, int tw,
                     int rows, int chunks, float eps) {
  using P = Pack<T, V>;
  constexpr int E = NV * V;                 // elements a lane
  constexpr int S = kBwdStages;
  constexpr int kSums = (MOD ? 2 : 0) + (GATE ? 1 : 0);
  constexpr int kGate = MOD ? 2 : 0;        // the gate's row in the region
  extern __shared__ float4 smem4[];
  __shared__ float red[2][kBwdMaxThreads / 32][2];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lanes = 32 * tw, slots = lanes * E, vecs = lanes * NV;
  const int team = tid / lanes, t = tid % lanes, teams = nthreads / lanes;
  const int block = blockIdx.x, b = block / chunks, chunk = block % chunks;
  const int r1 = min(n, (chunk + 1) * rows);
  const int nvec = d / V;
  const long long brow = static_cast<long long>(b) * n;
  const long long mrow = static_cast<long long>(b) * d;
  P* ring = reinterpret_cast<P*>(smem4) + team * S * 2 * vecs;
  float* region = reinterpret_cast<float*>(reinterpret_cast<P*>(smem4) +
                                           teams * S * 2 * vecs);

  auto issue = [&](int r, int s) {          // row r into stage s
    const long long at = (brow + r) * d;
    const P* xr = reinterpret_cast<const P*>(x + at);
    const P* gr = reinterpret_cast<const P*>(dy + at);
    P* sx = ring + s * 2 * vecs;
#pragma unroll
    for (int j = 0; j < NV; ++j) {          // clamped: padding lanes copy too
      const int c = min(t + lanes * j, nvec - 1);
      stage_copy(sx + t + lanes * j, xr + c);
      stage_copy(sx + vecs + t + lanes * j, gr + c);
    }
  };
  const int first = chunk * rows + team;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {         // in flight while staging
    if (first + k * teams < r1) issue(first + k * teams, k);
    cp_async_commit();
  }

  if constexpr (kSums > 0) {
    // every load first (a thread stages at most E columns: slots = lanes
    // * E and a block has at least lanes threads), then the stores
    float m[E][kSums];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int c = tid + k * nthreads;
      const bool in = c < d;
      if (MOD) {
        m[k][0] = in ? to_float(shift[mrow + c]) : 0.f;
        m[k][1] = in ? 1.f + to_float(scale[mrow + c]) : 0.f;
      }
      if (GATE) m[k][kGate] = in ? to_float(gate[mrow + c]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int c = tid + k * nthreads;
      if (c < slots) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) region[q * slots + c] = m[k][q];
      }
    }
    __syncthreads();
  }

  float ash[E], asc[E], ag[E];
#pragma unroll
  for (int k = 0; k < E; ++k) ash[k] = asc[k] = ag[k] = 0.f;

  int s = 0;                                // this row's stage
  for (int r = first; r < r1; r += teams) {
    cp_async_wait<S - 2>();                 // this row has landed
    float xf[E], gf[E];
    const P* sx = ring + s * 2 * vecs;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const P xv = sx[t + lanes * j], gv = sx[vecs + t + lanes * j];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xf[j * V + e] = to_float(xv.v[e]);
        gf[j * V + e] = to_float(gv.v[e]);
      }
    }
    // the row S - 1 ahead into the stage read one row ago
    const int ahead = r + (S - 1) * teams;
    if (ahead < r1) issue(ahead, s == 0 ? S - 1 : s - 1);
    cp_async_commit();
    s = s == S - 1 ? 0 : s + 1;

    // dx^ = dy * gate * (1 + scale) of element e of vector j
    auto dxh = [&](int j, int e) {
      const int col = (t + lanes * j) * V + e;
      float g = gf[j * V + e];
      if (GATE) g *= region[kGate * slots + col];
      if (MOD) g *= region[slots + col];
      return g;
    };
    float mu = 0.f, rstd = 1.f, c1 = 0.f, c2 = 0.f;
    if (LN) {
      // sum x and sum dx^ (dx^ needs no statistic of the row), then
      // sum (x - mu)^2 and sum dx^ (x - mu): mean(dx^ x^) is rstd times
      // the mean of the second, so two reductions give all four
      float m1[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float u = 0.f, w = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          u += xf[j * V + e];
          w += dxh(j, e);
        }
        if (t + lanes * j < nvec) {
          m1[0] += u;
          m1[1] += w;
        }
      }
      team_sum(m1, red[0], team, tw);
      mu = m1[0] / d;
      c1 = m1[1] / d;
      float m2[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float u = 0.f, w = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xc = xf[j * V + e] - mu;
          u = fmaf(xc, xc, u);
          w = fmaf(dxh(j, e), xc, w);
        }
        if (t + lanes * j < nvec) {
          m2[0] += u;
          m2[1] += w;
        }
      }
      team_sum(m2, red[1], team, tw);
      rstd = rsqrtf(m2[0] / d + eps);
      c2 = rstd * m2[1] / d;
    }

#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = (t + lanes * j) * V;
      float sh[V], sc[V], gt[V];
      if (MOD) {
        load_vec<V>(region + col, sh);
        load_vec<V>(region + slots + col, sc);
      }
      if (GATE) load_vec<V>(region + kGate * slots + col, gt);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int k = j * V + e;
        const float xh = LN ? (xf[k] - mu) * rstd : xf[k];
        float g = gf[k];
        if (GATE) {
          ag[k] = fmaf(g, MOD ? fmaf(xh, sc[e], sh[e]) : xh, ag[k]);
          g *= gt[e];
        }
        if (MOD) {
          ash[k] += g;
          asc[k] = fmaf(g, xh, asc[k]);
          g *= sc[e];
        }
        gf[k] = LN ? rstd * (g - c1 - xh * c2) : g;
      }
    }
    P* dxr = reinterpret_cast<P*>(dx + (brow + r) * d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      P o;
#pragma unroll
      for (int e = 0; e < V; ++e) o.v[e] = from_float<T>(gf[j * V + e]);
      if (t + lanes * j < nvec) dxr[t + lanes * j] = o;
    }
  }

  if constexpr (kSums > 0) {
    // the teams' sums into the region in team order (team 0 overwrites
    // the modulation rows, which every team has finished reading)
    for (int tm = 0; tm < teams; ++tm) {
      __syncthreads();
      if (team == tm) {
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int k = j * V + e, col = (t + lanes * j) * V + e;
            if (MOD) {
              region[col] = (tm ? region[col] : 0.f) + ash[k];
              region[slots + col] = (tm ? region[slots + col] : 0.f) + asc[k];
            }
            if (GATE) {
              float* p = region + kGate * slots + col;
              *p = (tm ? *p : 0.f) + ag[k];
            }
          }
      }
    }
    __syncthreads();
    float* pb = partial + static_cast<long long>(block) * kSums * d;
    for (int s = 0; s < kSums; ++s)
      for (int c = tid; c < d; c += nthreads)
        pb[s * d + c] = region[s * slots + c];
  }
}

// dshift/dscale/dgate[b, c]: the sum over the chunks of batch row b, in
// order, of the partials of column c (each of kBwdColGroups warps sums
// every kBwdColGroups-th chunk, then one warp adds the groups in order).
// partial: (B, chunks, sums, d); out[s] the sums' outputs in that order.
template <typename T>
__global__ void __launch_bounds__(32 * kBwdColGroups)
    adaln_bwd_cols_kernel(const float* __restrict__ partial, T* out0,
                          T* out1, T* out2, int chunks, int sums, int d) {
  __shared__ float part[kBwdColGroups][32];
  const int c = blockIdx.x * 32 + threadIdx.x, s = blockIdx.y,
            b = blockIdx.z, g = threadIdx.y;
  float acc = 0.f;
  if (c < d) {
    const long long stride = static_cast<long long>(sums) * d;
    const float* p = partial + static_cast<long long>(b) * chunks * stride
                     + static_cast<long long>(s) * d + c;
#pragma unroll 8
    for (int k = g; k < chunks; k += kBwdColGroups) acc += p[k * stride];
  }
  part[g][threadIdx.x] = acc;
  __syncthreads();
  if (g == 0 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBwdColGroups; ++i) sum += part[i][threadIdx.x];
    T* out = s == 0 ? out0 : s == 1 ? out1 : out2;
    out[static_cast<long long>(b) * d + c] = from_float<T>(sum);
  }
}

// The row rule: rows a block, so that the B * chunks blocks come to
// kBwdBlocksPerSm an SM (fewer when the batch rows hold fewer tokens).
// It depends on (B, n) and the card alone, so the wrapper can size the
// partials' scratch (B * chunks * sums * d floats) before the launch.
inline bool bwd_rows(int B, int n, int device, int* rows, int* chunks) {
  const int sms = sm_count(device);
  if (sms <= 0 || B <= 0 || n <= 0) return false;
  const long long want = (static_cast<long long>(kBwdBlocksPerSm) * sms
                          + B - 1) / B;
  const int c0 = static_cast<int>(std::min<long long>(n, want));
  *rows = (n + c0 - 1) / c0;
  *chunks = (n + *rows - 1) / *rows;
  return true;
}

// Vectors a lane holds (the one instantiation a path has): 12 elements a
// lane in fp32 (3 float4) and on the scalar path, 8 (one vector) in
// bf16, so that x^, dx^ and three sums a column stay in registers.
template <typename T, int V>
constexpr int kBwdNV = V == 1 ? 12 : (sizeof(T) == 4 ? 3 : 1);

struct BwdPlan {
  int tw, nv, threads, teams, rows, chunks;
};

// The narrowest team (1 to 16 warps) whose lanes cover the row with NV
// vectors each (D=1536: 4 warps in fp32, 6 in bf16); two teams a block
// while they fit in kBwdMaxThreads and kBwdMaxSmem.
template <typename T, int V>
bool bwd_plan(int B, int n, int d, int sums, int device, BwdPlan* p) {
  constexpr int NV = kBwdNV<T, V>;
  const int nvec = d / V, tw = (nvec + 32 * NV - 1) / (32 * NV);
  if (tw > kBwdMaxThreads / 32) return false;
  p->tw = tw;
  p->nv = NV;
  p->teams = 64 * tw <= kBwdMaxThreads &&
                     bwd_smem<T, V, NV>(tw, 2, sums) <= kBwdMaxSmem
                 ? 2
                 : 1;
  p->threads = 32 * tw * p->teams;
  return bwd_rows(B, n, device, &p->rows, &p->chunks);
}

template <typename T, int V, int NV, bool LN, bool MOD, bool GATE>
cudaError_t launch_bwd(const void* x, const void* shift, const void* scale,
                       const void* gate, const void* dy, void* dx,
                       float* partial, int B, int n, int d,
                       const BwdPlan& p, int device, cudaStream_t stream,
                       int* blocks_per_sm) {
  constexpr auto kernel = adaln_bwd_kernel<T, V, NV, LN, MOD, GATE>;
  constexpr int kSums = (MOD ? 2 : 0) + (GATE ? 1 : 0);
  const size_t smem = bwd_smem<T, V, NV>(p.tw, p.teams, kSums);
  cudaError_t err = allow_smem_once<kernel>(kBwdMaxSmem, device);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)   // a query: occupancy, no launch
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, p.threads, smem);
  kernel<<<B * p.chunks, p.threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift),
      static_cast<const T*>(scale), static_cast<const T*>(gate),
      static_cast<const T*>(dy), static_cast<T*>(dx), partial, n, d, p.tw,
      p.rows, p.chunks, 1e-6f);
  return cudaGetLastError();
}

template <typename T, int V, int NV>
cudaError_t launch_bwd_variant(const void* x, const void* shift,
                               const void* scale, const void* gate,
                               const void* dy, void* dx, float* partial,
                               int B, int n, int d, int variant,
                               const BwdPlan& p, int device,
                               cudaStream_t stream, int* blocks_per_sm) {
#define GFDIT_ADALN_BWD(LN, MOD, GATE)                                    \
  return launch_bwd<T, V, NV, LN, MOD, GATE>(x, shift, scale, gate, dy,  \
                                             dx, partial, B, n, d, p,    \
                                             device, stream, blocks_per_sm);
  switch (variant) {  // bit 0: ln, bit 1: shift/scale, bit 2: gate
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
}

// Plans the launch (vector or scalar path), then launches the row kernel,
// or with blocks_per_sm only reports the plan and its occupancy.
template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* shift, const void* scale,
                         const void* gate, const void* dy, void* dx,
                         float* partial, int B, int n, int d, int variant,
                         bool vec, int device, cudaStream_t stream,
                         BwdPlan* plan, int* blocks_per_sm) {
  constexpr int kV = 16 / sizeof(T);
  BwdPlan p;
  const int sums = (variant & 2 ? 2 : 0) + (variant & 4 ? 1 : 0);
  if (vec ? !bwd_plan<T, kV>(B, n, d, sums, device, &p)
          : !bwd_plan<T, 1>(B, n, d, sums, device, &p))
    return cudaErrorInvalidValue;
  if (plan != nullptr) *plan = p;
  if (vec)
    return launch_bwd_variant<T, kV, kBwdNV<T, kV>>(
        x, shift, scale, gate, dy, dx, partial, B, n, d, variant, p, device,
        stream, blocks_per_sm);
  return launch_bwd_variant<T, 1, kBwdNV<T, 1>>(
      x, shift, scale, gate, dy, dx, partial, B, n, d, variant, p, device,
      stream, blocks_per_sm);
}

template <typename T>
cudaError_t launch_cols(const float* partial, void* dshift, void* dscale,
                        void* dgate, int B, int d, const BwdPlan& p,
                        cudaStream_t stream) {
  T* outs[3];
  int sums = 0;
  for (void* o : {dshift, dscale, dgate})
    if (o != nullptr) outs[sums++] = static_cast<T*>(o);
  if (sums == 0) return cudaSuccess;
  adaln_bwd_cols_kernel<T>
      <<<dim3((d + 31) / 32, sums, B), dim3(32, kBwdColGroups), 0, stream>>>(
          partial, outs[0], sums > 1 ? outs[1] : nullptr,
          sums > 2 ? outs[2] : nullptr, p.chunks, sums, d);
  return cudaGetLastError();
}

}  // namespace gfdit

// Floats of fp32 scratch gfdit_adaln_bwd needs for its partials at
// (B, n, d) with shift/scale (mod) and gate as given: B * chunks * sums *
// d by the kernel's row rule (0 when there is no column sum); -1 for a
// shape or device it cannot plan.
extern "C" long long gfdit_adaln_bwd_scratch(int B, int n, int d, int mod,
                                             int gated, int device) {
  using namespace gfdit;
  int rows, chunks;
  if (d <= 0 || !bwd_rows(B, n, device, &rows, &chunks)) return -1;
  return static_cast<long long>(B) * chunks * ((mod ? 2 : 0) + (gated ? 1 : 0))
         * d;
}

inline bool adaln_bwd_vec(const void* x, const void* dy, const void* dx,
                          int d, int dtype) {
  using gfdit::aligned16;
  return d % (dtype == gfdit::kFloat32 ? 4 : 8) == 0 && aligned16(x) &&
         aligned16(dy) && aligned16(dx);
}

// x/dy/dx: (B, n, d) contiguous; shift/scale/gate and their gradients:
// (B, d) contiguous, all of one dtype; absent operands null (dgate with
// gate, dshift and dscale with shift).  partial: scratch of
// partial_floats fp32, at least gfdit_adaln_bwd_scratch's, when shift or
// gate is given.  dresidual is dy: the caller hands dy on.
extern "C" int gfdit_adaln_bwd(const void* x, const void* shift,
                               const void* scale, const void* gate,
                               const void* dy, void* dx, void* dshift,
                               void* dscale, void* dgate, float* partial,
                               long long partial_floats, int B, int n, int d,
                               int ln, int dtype, int device, void* stream) {
  using namespace gfdit;
  const bool mod = shift != nullptr, gated = gate != nullptr;
  if (d <= 0 || d > kAdaMaxDim || B <= 0 || n <= 0 || B > 65535 ||
      (!ln && !mod && !gated) || mod != (scale != nullptr) ||
      mod != (dshift != nullptr) || mod != (dscale != nullptr) ||
      gated != (dgate != nullptr) ||
      ((mod || gated) &&
       (partial == nullptr ||
        partial_floats < gfdit_adaln_bwd_scratch(B, n, d, mod, gated,
                                                 device))))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const int variant = (ln ? 1 : 0) | (mod ? 2 : 0) | (gated ? 4 : 0);
  const bool vec = adaln_bwd_vec(x, dy, dx, d, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdPlan p;
  if (dtype == kFloat32) {
    err = dispatch_bwd<float>(x, shift, scale, gate, dy, dx, partial, B, n,
                              d, variant, vec, device, s, &p, nullptr);
    if (err == cudaSuccess)
      err = launch_cols<float>(partial, dshift, dscale, dgate, B, d, p, s);
    return err;
  }
  if (dtype == kBFloat16) {
    err = dispatch_bwd<__nv_bfloat16>(x, shift, scale, gate, dy, dx, partial,
                                      B, n, d, variant, vec, device, s, &p,
                                      nullptr);
    if (err == cudaSuccess)
      err = launch_cols<__nv_bfloat16>(partial, dshift, dscale, dgate, B, d,
                                       p, s);
    return err;
  }
  return cudaErrorInvalidValue;
}

// The row kernel's plan at (B, n, d) for the variant (ln, mod, gated) in
// dtype on the vector path (vec) or the scalar one: out = {warps a row,
// vectors a lane, threads a block, rows a block, blocks a batch row,
// resident blocks an SM (occupancy calculator), shared bytes a block}.
extern "C" int gfdit_adaln_bwd_plan(int B, int n, int d, int ln, int mod,
                                    int gated, int dtype, int vec,
                                    int device, int* out) {
  using namespace gfdit;
  const int v = vec ? (dtype == kFloat32 ? 4 : 8) : 1;
  if (d <= 0 || d > kAdaMaxDim || d % v || (!ln && !mod && !gated))
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const int variant = (ln ? 1 : 0) | (mod ? 2 : 0) | (gated ? 4 : 0);
  BwdPlan p;
  int blocks = 0;
  if (dtype == kFloat32)
    err = dispatch_bwd<float>(nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, B, n, d, variant, vec,
                              device, nullptr, &p, &blocks);
  else if (dtype == kBFloat16)
    err = dispatch_bwd<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, B, n, d,
                                      variant, vec, device, nullptr, &p,
                                      &blocks);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int sums = (mod ? 2 : 0) + (gated ? 1 : 0);
  const size_t smem =
      dtype == kFloat32
          ? (vec ? bwd_smem<float, 4, kBwdNV<float, 4>>(p.tw, p.teams, sums)
                 : bwd_smem<float, 1, kBwdNV<float, 1>>(p.tw, p.teams, sums))
          : (vec ? bwd_smem<__nv_bfloat16, 8, kBwdNV<__nv_bfloat16, 8>>(
                       p.tw, p.teams, sums)
                 : bwd_smem<__nv_bfloat16, 1, kBwdNV<__nv_bfloat16, 1>>(
                       p.tw, p.teams, sums));
  const int vals[7] = {p.tw, p.nv, p.threads, p.rows, p.chunks, blocks,
                       static_cast<int>(smem)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return cudaSuccess;
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
