// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel computes in fp32 whatever its I/O dtype (fp32 or bf16),
// as the TPU kernels do, and every C entry point returns
// cudaGetLastError() right after its launch so the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstring>
#include <type_traits>

namespace gfdit {

constexpr int kMaxDevices = 64;

template <typename V>
constexpr V cmax(V a, V b) { return a > b ? a : b; }
template <typename V>
constexpr V cmin(V a, V b) { return a < b ? a : b; }

// Makes `device` current; only a query when it already is (the wrappers
// are called thousands of times a request).
inline cudaError_t use_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device)
    return cudaSuccess;
  return cudaSetDevice(device);
}

// The SM count of `device`, asked once (0 if it cannot be had).
inline int sm_count(int device) {
  static std::atomic<int> cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  int v = cached[device].load(std::memory_order_relaxed);
  if (v == 0 && cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount,
                                       device) == cudaSuccess)
    cached[device].store(v, std::memory_order_relaxed);
  return v;
}

// Raises Kernel's dynamic shared-memory limit to `bytes` once per device,
// so launches do not pay for the call and none is made while a CUDA graph
// is being captured.  `device` must be current.
template <auto Kernel>
cudaError_t allow_smem_once(size_t bytes, int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

// Resident blocks of `threads` threads an SM and the dynamic shared bytes
// of Kernel at `smem` bytes (its limit raised first), from the occupancy
// calculator.
template <auto Kernel>
cudaError_t occupancy_of(size_t smem, int threads, int device,
                         int* blocks_per_sm, int* smem_bytes) {
  cudaError_t err = allow_smem_once<Kernel>(smem, device);
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, Kernel,
                                                       threads, smem);
}

// dtype codes shared with repro_torch/kernels/ops.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// 16-byte asynchronous copy global -> shared (cp.async.cg, L2 only);
// fill = false zero-fills the 16 bytes and reads nothing.  Both
// addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = fill ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits for all but the most recent cp.async group.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 4 (or 2) consecutive elements of a shared row as floats
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// VW = 1, 2, 4 or 8 consecutive elements as floats, in one load (two
// for 8); p aligned to the load's width
template <int VW, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  static_assert(VW == 1 || VW == 2 || VW == 4 || VW == 8, "load_vec");
  if constexpr (VW == 8) {
    load_vec<4>(p, v);
    load_vec<4>(p + 4, v + 4);
  } else if constexpr (VW == 4) {
    const float4 f = ld4(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (VW == 2) {
    const float2 f = ld2(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = to_float(*p);
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  static_assert(VW == 1 || VW == 2 || VW == 4, "store_vec");
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (VW == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  unsigned bits;
  memcpy(&bits, &h, sizeof(bits));
  return bits;
}
template <int VW>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  static_assert(VW == 1 || VW == 2 || VW == 4, "store_vec");
  if constexpr (VW == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]));
  else if constexpr (VW == 2)
    *reinterpret_cast<unsigned*>(p) = bf16x2_bits(v[0], v[1]);
  else
    *p = __float2bfloat16(v[0]);
}

// ROWS x COLS consecutive fp32 values at `src` (global memory) into a
// ROWS x PITCH shared tile of bf16, rounded to nearest even; NTH threads
// (threadIdx.x < NTH), one float4 each per NTH of them.  Every load of a
// thread is issued before its first store, so they are in flight
// together.  The caller synchronises before the tile is read.
template <int ROWS, int COLS, int PITCH, int NTH>
__device__ __forceinline__ void stage_rounded(__nv_bfloat16* dst,
                                              const float* src) {
  constexpr int Q = ROWS * COLS / 4, U = Q / NTH;
  static_assert(COLS % 4 == 0 && Q % NTH == 0,
                "stage_rounded: whole float4 units for every thread");
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = ld4(src + 4 * (threadIdx.x + u * NTH));
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = threadIdx.x + u * NTH;
    const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    store_vec<4>(dst + (q / (COLS / 4)) * PITCH + 4 * (q % (COLS / 4)), f);
  }
}

// Rows [l0, l0 + ROWS) of a row-strided matrix of T (row l at src + l *
// stride, COLS elements from a 16-byte boundary) into a ROWS x PITCH
// shared tile by 16-byte cp.async; rows at or past L are zero-filled.
// The caller commits and waits.
template <int ROWS, int COLS, int PITCH, int NTH, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           long long stride, int l0, int L) {
  constexpr int EPC = 16 / sizeof(T), CPR = COLS / EPC;
  for (int q = threadIdx.x; q < ROWS * CPR; q += NTH) {
    const int r = q / CPR, c = EPC * (q % CPR), l = l0 + r;
    cp_async16(dst + r * PITCH + c, src + min(l, L - 1) * stride + c,
               l < L);
  }
}

// ROWS x COLS consecutive fp32 values (a state or state gradient's rows)
// into a ROWS x PITCH shared tile of T: by cp.async for fp32, rounded to
// bf16 by plain loads for bf16 (stage_rounded).  The caller commits and
// waits.
template <int ROWS, int COLS, int PITCH, int NTH, typename T>
__device__ __forceinline__ void stage_state(T* dst,
                                            const float* __restrict__ src) {
  if constexpr (std::is_same_v<T, float>) {
    stage_tile<ROWS, COLS, PITCH, NTH>(dst, src, COLS, 0, ROWS);
  } else {
    stage_rounded<ROWS, COLS, PITCH, NTH>(dst, src);
  }
}

}  // namespace gfdit
