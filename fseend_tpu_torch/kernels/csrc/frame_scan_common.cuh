// Float32 device helpers shared by the port's kernels: a warp's sum, the
// sigmoid and silu.
#pragma once

#include <cuda_runtime.h>

namespace fs {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

}  // namespace fs

extern "C" const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
