// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel computes in fp32 whatever its I/O dtype (fp32 or bf16),
// as the TPU kernels do, and every C entry point returns
// cudaGetLastError() right after its launch so the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gfdit {

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
