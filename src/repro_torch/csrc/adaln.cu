// Fused adaLN-Zero modulate: (LN ->) shift/scale (-> gate -> residual add).
//
// Replaces the TPU kernel src/repro/kernels/adaln.py::adaln_modulate
// (_adaln_kernel): per token row, an fp32 LayerNorm (eps 1e-6), then
// x*(1+scale)+shift, then residual + gate*x, with the stages chosen
// statically.  The variants the DiT uses are the modulated norm (bare LN
// when shift/scale are absent), the gated residual with ln=False, and
// the full fusion.
//
// Bound on the card: bytes.  A row of D=1536 does ~10 flops per element
// against 8-12 bytes moved per element, far below the H100's ~20 flops
// per fp32 byte, so the floor is reading x (and residual) once and
// writing out once at 3.35 TB/s.
//
// Design: one 256-thread block per token row.  The row is read once into
// registers (up to kPer values a thread, D <= 4096), the mean and the
// variance come from two block reductions over those registers
// (two-pass, as the reference computes them), and the output is written
// once, so each byte crosses device memory exactly once.  Neighbouring
// threads touch neighbouring elements, so every load and store coalesces.
#include "common.cuh"

namespace gfdit {

constexpr int kAdaThreads = 256;
constexpr int kPer = 16;  // elements a thread holds: D <= 256 * 16

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kAdaThreads / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

template <typename T, bool LN, bool MOD, bool GATE>
__global__ void __launch_bounds__(kAdaThreads)
    adaln_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                 const T* __restrict__ scale, const T* __restrict__ gate,
                 const T* __restrict__ residual, T* __restrict__ out, int n,
                 int d, float eps) {
  __shared__ float red[33];
  const long long row = blockIdx.x;  // token row in [0, B*N)
  const long long base = row * d;
  const long long mrow = (row / n) * d;  // this row's (B, D) modulation row
  float vals[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kAdaThreads;
    vals[k] = i < d ? to_float(x[base + i]) : 0.f;
  }
  float mu = 0.f, rstd = 1.f;
  if (LN) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) s += vals[k];
    mu = block_sum(s, red) / d;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kAdaThreads;
      const float t = i < d ? vals[k] - mu : 0.f;
      q += t * t;
    }
    rstd = rsqrtf(block_sum(q, red) / d + eps);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kAdaThreads;
    if (i >= d) break;
    float v = vals[k];
    if (LN) v = (v - mu) * rstd;
    if (MOD)
      v = v * (1.f + to_float(scale[mrow + i])) + to_float(shift[mrow + i]);
    if (GATE) v = to_float(residual[base + i]) + to_float(gate[mrow + i]) * v;
    out[base + i] = from_float<T>(v);
  }
}

template <typename T, bool LN, bool MOD, bool GATE>
void launch_adaln(const void* x, const void* shift, const void* scale,
                  const void* gate, const void* residual, void* out, int rows,
                  int n, int d, cudaStream_t stream) {
  adaln_kernel<T, LN, MOD, GATE><<<rows, kAdaThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift),
      static_cast<const T*>(scale), static_cast<const T*>(gate),
      static_cast<const T*>(residual), static_cast<T*>(out), n, d, 1e-6f);
}

template <typename T>
cudaError_t dispatch_adaln(const void* x, const void* shift, const void* scale,
                           const void* gate, const void* residual, void* out,
                           int rows, int n, int d, int variant,
                           cudaStream_t stream) {
#define GFDIT_ADALN(LN, MOD, GATE)                                          \
  launch_adaln<T, LN, MOD, GATE>(x, shift, scale, gate, residual, out, rows, \
                                 n, d, stream);                              \
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

}  // namespace gfdit

// x/residual/out: (rows = B*N, d) contiguous; shift/scale/gate: (B, d)
// contiguous, all of one dtype.  Absent operands are null.
extern "C" int gfdit_adaln(const void* x, const void* shift, const void* scale,
                           const void* gate, const void* residual, void* out,
                           int rows, int n, int d, int ln, int dtype,
                           int device, void* stream) {
  using namespace gfdit;
  if (d <= 0 || d > kAdaThreads * kPer || rows <= 0 || n <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
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
