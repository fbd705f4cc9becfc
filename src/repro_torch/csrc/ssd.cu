// Mamba2 SSD (state-space dual) chunked scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_scan (_ssd_kernel):
// for every (batch, head), walk the sequence in chunks of `chunk` rows,
// carrying the (p x n) fp32 state.  Within a chunk, with cum the in-chunk
// cumulative sum of dt*A and xb = x*dt,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xb_j
//         + exp(cum_i) (C_i . state)
//   state = exp(cum_last) state + sum_j exp(cum_last - cum_j) xb_j (x) B_j
// and the final state is returned.  B and C have one group: they are read
// from the shared (b, l, n) arrays by every head's block, never copied per
// head as the TPU wrapper's jnp.repeat does.  A ragged last chunk is masked
// here (rows past l load dt = x = B = C = 0, which leaves the state as it
// is, and are not written), so callers need not pad.
//
// Bound on the card: operations.  What the function needs, per (batch,
// chunk) of c rows: the causal C B^T once (B and C have one group),
// c(c+1)/2 n multiply-adds; and per head the causal scores . xb,
// c(c+1)/2 p, C . state, c p n (none in the first chunk, whose state is
// zero), and the state update, c p n.  At the full-width mamba2-1.3b
// prefill (b=4, l=2048, h=64, p=64, n=128, c=128) that is 21.1 GFLOP,
// 0.315 ms at the 67 TFLOP/s fp32 CUDA-core rate of an H100 SXM, against
// ~287 MB of x, y, dt, B, C and the state (0.086 ms at 3.35 TB/s).
// This kernel does more.  Per (chunk, head) it computes the C B^T and
// scores . xb of each row tile's blocks left of its last row (2.62 and
// 1.31 MFLOP at that shape), C . state (2.10) and the state update
// (2.10): 8.13 MFLOP, 33.3 GFLOP in all, 1.58x the need.  C B^T, the same
// for every head, is recomputed per head: 32% of the kernel's operations,
// where once per (batch, chunk) it would be under 1%.  Sharing it across heads,
// tensor cores (wgmma) and TMA loads are for a later redesign.
//
// Design (simple and right first): one 256-thread block (a 16 x 16 thread
// grid) per (batch, head), looping over its chunks in order; blocks of
// different (b, h) run in parallel (at b=4 that is 256 blocks on 132 SMs,
// one block an SM for shared memory; at b=1 only 64 SMs are busy).  Per
// chunk, xb (c x p), B (c x n), the state (p x n) and the cumulative decay
// live in shared memory as fp32; the chunk's rows are taken R = 32 at a
// time, staging those rows of C and their (R x c) score tile, which keeps
// the block at 163 KB at (64, 128, 128) where staging the whole chunk
// would take 256 KB.  Each thread owns rows ty + 16i and columns tx + 16j
// of every product it computes.  The in-chunk cumulative sum is a
// warp-shuffle scan plus the warps' totals.  The decay is masked to -1e30
// BEFORE the exp: the upper triangle's cum_i - cum_j is positive and its
// exp can overflow fp32 (inf * 0 = NaN).  Score columns wholly above the
// diagonal of a row tile are skipped.  Shared rows of width n and c are
// padded by one float against bank conflicts.
#include "common.cuh"

namespace gfdit {

constexpr int kSsdThreads = 256;
constexpr int kSsdRows = 32;
constexpr float kSsdMask = -1e30f;

// Shared-memory layout, in floats.
template <int P, int N, int CH>
struct SsdSmem {
  static constexpr int R = CH < kSsdRows ? CH : kSsdRows;
  static constexpr int xs = 0;                       // CH x P: x * dt
  static constexpr int bs = xs + CH * P;             // CH x (N + 1): B
  static constexpr int st = bs + CH * (N + 1);       // P x (N + 1): state
  static constexpr int cs = st + P * (N + 1);        // R x (N + 1): C rows
  static constexpr int ss = cs + R * (N + 1);        // R x (CH + 1): scores
  static constexpr int dts = ss + R * (CH + 1);      // CH: dt
  static constexpr int cum = dts + CH;               // CH: cumsum(dt * A)
  static constexpr int ecum = cum + CH;              // CH: exp(cum)
  static constexpr int wdec = ecum + CH;             // CH: exp(cum_last - cum)
  static constexpr int wsum = wdec + CH;             // warp totals of the scan
  static constexpr int total = wsum + 4;
  static constexpr size_t bytes = total * sizeof(float);
};

template <typename T, int P, int N, int CH>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y,
               float* __restrict__ state_out, int L, int H) {
  static_assert(P % 16 == 0 && N % 16 == 0 && CH % 16 == 0 && CH <= 128,
                "ssd_kernel: p, n and chunk must be multiples of 16, chunk "
                "at most 128");
  using S = SsdSmem<P, N, CH>;
  constexpr int R = S::R;
  extern __shared__ float smem[];
  float* xs = smem + S::xs;
  float* bs = smem + S::bs;
  float* st = smem + S::st;
  float* cs = smem + S::cs;
  float* ss = smem + S::ss;
  float* dts = smem + S::dts;
  float* cum = smem + S::cum;
  float* ecum = smem + S::ecum;
  float* wdec = smem + S::wdec;
  float* wsum = smem + S::wsum;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = A[h];

  for (int i = tid; i < P * (N + 1); i += kSsdThreads) st[i] = 0.f;

  const int nchunks = (L + CH - 1) / CH;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int l0 = ci * CH;
    __syncthreads();  // the previous chunk's readers are done

    // dt and the warp-level inclusive scan of dt * A; B's rows
    constexpr int kScanThreads = (CH + 31) / 32 * 32;
    if (tid < kScanThreads) {
      const int l = l0 + tid;
      const float d = (tid < CH && l < L) ? dt[((long long)b * L + l) * H + h]
                                          : 0.f;
      float v = d * a;
      const int lane = tid & 31;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (tid < CH) {
        dts[tid] = d;
        cum[tid] = v;
      }
      if (lane == 31) wsum[tid >> 5] = v;
    }
    for (int i = tid; i < CH * N; i += kSsdThreads) {
      const int j = i / N, k = i % N, l = l0 + j;
      bs[j * (N + 1) + k] =
          l < L ? to_float(Bm[((long long)b * L + l) * N + k]) : 0.f;
    }
    __syncthreads();

    // the warps' offsets; xb = x * dt
    if (tid < CH) {
      float off = 0.f;
      for (int w = 0; w < (tid >> 5); ++w) off += wsum[w];
      cum[tid] += off;
    }
    for (int i = tid; i < CH * P; i += kSsdThreads) {
      const int j = i / P, pp = i % P, l = l0 + j;
      const float xv =
          l < L ? to_float(x[(((long long)b * L + l) * H + h) * P + pp]) : 0.f;
      xs[i] = xv * dts[j];
    }
    __syncthreads();
    if (tid < CH) {
      ecum[tid] = expf(cum[tid]);
      wdec[tid] = expf(cum[CH - 1] - cum[tid]);
    }

    for (int r0 = 0; r0 < CH; r0 += R) {
      for (int i = tid; i < R * N; i += kSsdThreads) {
        const int r = i / N, k = i % N, l = l0 + r0 + r;
        cs[r * (N + 1) + k] =
            l < L ? to_float(Cm[((long long)b * L + l) * N + k]) : 0.f;
      }
      __syncthreads();  // C rows staged (and ecum / wdec written)

      // scores (R x CH) = C_rows B^T, times the masked decay
      {
        constexpr int MI = R / 16, MJ = CH / 16;
        float acc[MI][MJ];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[MI], bv[MJ];
#pragma unroll
          for (int i = 0; i < MI; ++i) cv[i] = cs[(ty + 16 * i) * (N + 1) + k];
#pragma unroll
          for (int j = 0; j < MJ; ++j) {
            // columns >= 16j; all above the tile's last row when 16j >= r0+R
            if (16 * j < r0 + R) {
              bv[j] = bs[(tx + 16 * j) * (N + 1) + k];
#pragma unroll
              for (int i = 0; i < MI; ++i)
                acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int row = r0 + ty + 16 * i;
          const float crow = cum[row];
#pragma unroll
          for (int j = 0; j < MJ; ++j) {
            const int col = tx + 16 * j;
            const float seg = col <= row ? crow - cum[col] : kSsdMask;
            ss[(ty + 16 * i) * (CH + 1) + col] = acc[i][j] * expf(seg);
          }
        }
      }
      __syncthreads();

      // y rows: scores . xb + exp(cum_i) * (C_i . state)
      {
        constexpr int MI = R / 16, MP = P / 16;
        float yi[MI][MP], yo[MI][MP];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int q = 0; q < MP; ++q) yi[i][q] = yo[i][q] = 0.f;
        const int jmax = r0 + R;  // scores past the tile's last row are 0
#pragma unroll 4
        for (int j = 0; j < jmax; ++j) {
          float sv[MI], xv[MP];
#pragma unroll
          for (int i = 0; i < MI; ++i) sv[i] = ss[(ty + 16 * i) * (CH + 1) + j];
#pragma unroll
          for (int q = 0; q < MP; ++q) xv[q] = xs[j * P + tx + 16 * q];
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int q = 0; q < MP; ++q) yi[i][q] = fmaf(sv[i], xv[q], yi[i][q]);
        }
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[MI], sv[MP];
#pragma unroll
          for (int i = 0; i < MI; ++i) cv[i] = cs[(ty + 16 * i) * (N + 1) + k];
#pragma unroll
          for (int q = 0; q < MP; ++q) sv[q] = st[(tx + 16 * q) * (N + 1) + k];
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int q = 0; q < MP; ++q) yo[i][q] = fmaf(cv[i], sv[q], yo[i][q]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int row = r0 + ty + 16 * i, l = l0 + row;
          if (l >= L) continue;
          const float e = ecum[row];
          T* out = y + (((long long)b * L + l) * H + h) * P;
#pragma unroll
          for (int q = 0; q < MP; ++q)
            out[tx + 16 * q] = from_float<T>(fmaf(e, yo[i][q], yi[i][q]));
        }
      }
      __syncthreads();  // cs / ss are restaged by the next row tile
    }

    // state = exp(cum_last) * state + sum_j exp(cum_last - cum_j) xb_j B_j;
    // each thread rewrites only the entries it owns, and every reader of
    // the old state passed the barrier above
    {
      constexpr int MP = P / 16, MN = N / 16;
      float acc[MP][MN];
#pragma unroll
      for (int q = 0; q < MP; ++q)
#pragma unroll
        for (int m = 0; m < MN; ++m) acc[q][m] = 0.f;
#pragma unroll 4
      for (int j = 0; j < CH; ++j) {
        const float w = wdec[j];
        float xv[MP], bv[MN];
#pragma unroll
        for (int q = 0; q < MP; ++q) xv[q] = xs[j * P + ty + 16 * q] * w;
#pragma unroll
        for (int m = 0; m < MN; ++m) bv[m] = bs[j * (N + 1) + tx + 16 * m];
#pragma unroll
        for (int q = 0; q < MP; ++q)
#pragma unroll
          for (int m = 0; m < MN; ++m) acc[q][m] = fmaf(xv[q], bv[m], acc[q][m]);
      }
      const float dec = ecum[CH - 1];
#pragma unroll
      for (int q = 0; q < MP; ++q)
#pragma unroll
        for (int m = 0; m < MN; ++m) {
          float* e = st + (ty + 16 * q) * (N + 1) + tx + 16 * m;
          *e = fmaf(*e, dec, acc[q][m]);
        }
    }
  }
  __syncthreads();
  float* out = state_out + ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kSsdThreads)
    out[i] = st[(i / N) * (N + 1) + i % N];
}

template <typename T, int P, int N, int CH>
cudaError_t launch_ssd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* state,
                       int batch, int L, int H, int device,
                       cudaStream_t stream) {
  constexpr size_t smem = SsdSmem<P, N, CH>::bytes;
  cudaError_t err = allow_smem_once<ssd_kernel<T, P, N, CH>>(smem, device);
  if (err != cudaSuccess) return err;
  ssd_kernel<T, P, N, CH><<<batch * H, kSsdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(state), L, H);
  return cudaGetLastError();
}

// The (p, n, chunk) shapes instantiated; keep in step with SSD_SHAPES in
// repro_torch/kernels/ops.py.  X(p, n, chunk) is expanded once per shape.
#define GFDIT_SSD_SHAPES(X) \
  X(64, 128, 128) /* mamba2-1.3b at full width */ \
  X(16, 16, 16)   /* mamba2-1.3b.reduced() */ \
  X(16, 16, 32)   /* the JAX package's kernel sweep */ \
  X(32, 16, 64) \
  X(64, 32, 128)

template <typename T>
cudaError_t dispatch_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* state,
                         int batch, int L, int H, int P, int N, int chunk,
                         int device, cudaStream_t s) {
#define GFDIT_SSD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) \
    return launch_ssd<T, p, n, c>(x, dt, A, B, C, y, state, batch, L, H, \
                                  device, s);
  GFDIT_SSD_SHAPES(GFDIT_SSD_CASE)
#undef GFDIT_SSD_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int P, int N, int CH>
cudaError_t occupancy_ssd(int device, int* blocks_per_sm, int* smem_bytes) {
  constexpr size_t smem = SsdSmem<P, N, CH>::bytes;
  cudaError_t err = allow_smem_once<ssd_kernel<T, P, N, CH>>(smem, device);
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssd_kernel<T, P, N, CH>, kSsdThreads, smem);
}

template <typename T>
cudaError_t dispatch_occupancy(int P, int N, int chunk, int device,
                               int* blocks_per_sm, int* smem_bytes) {
#define GFDIT_SSD_CASE(p, n, c) \
  if (P == p && N == n && chunk == c) \
    return occupancy_ssd<T, p, n, c>(device, blocks_per_sm, smem_bytes);
  GFDIT_SSD_SHAPES(GFDIT_SSD_CASE)
#undef GFDIT_SSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace gfdit

// x/y: (batch, L, H, P) and B/C: (batch, L, N), all of one dtype; dt:
// (batch, L, H) and A: (H,) fp32; state: (batch, H, P, N) fp32 output.
extern "C" int gfdit_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* state,
                         int batch, int L, int H, int P, int N, int chunk,
                         int dtype, int device, void* stream) {
  using namespace gfdit;
  if (batch <= 0 || L <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_ssd<float>(x, dt, A, B, C, y, state, batch, L, H, P, N,
                               chunk, device, s);
  if (dtype == kBFloat16)
    return dispatch_ssd<__nv_bfloat16>(x, dt, A, B, C, y, state, batch, L, H,
                                       P, N, chunk, device, s);
  return cudaErrorInvalidValue;
}

// Resident blocks per SM and dynamic shared memory of the (P, N, chunk)
// instantiation: the occupancy a launch of gfdit_ssd gets.
extern "C" int gfdit_ssd_occupancy(int P, int N, int chunk, int dtype,
                                   int device, int* blocks_per_sm,
                                   int* smem_bytes) {
  using namespace gfdit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (dtype == kFloat32)
    return dispatch_occupancy<float>(P, N, chunk, device, blocks_per_sm,
                                    smem_bytes);
  if (dtype == kBFloat16)
    return dispatch_occupancy<__nv_bfloat16>(P, N, chunk, device,
                                             blocks_per_sm, smem_bytes);
  return cudaErrorInvalidValue;
}
