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

namespace gfdit {

constexpr int kMaxDevices = 64;

// Makes `device` current; only a query when it already is (the wrappers
// are called thousands of times a request).
inline cudaError_t use_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device)
    return cudaSuccess;
  return cudaSetDevice(device);
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

}  // namespace gfdit
