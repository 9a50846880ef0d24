// Device helpers shared by the port's kernels: a warp's sum, the sigmoid
// and silu, and the element types a kernel may store its data in (float32,
// or bf16 for the bf16 forms built with FS_BF16): reads to float, writes
// rounded to nearest, and `rnd<T>`, a rounding point of the bf16 form (the
// identity in float32, so a float32 build computes what it computed before).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fs {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }

// As<T>::from(x): x stored as a T (rounded to nearest)
template <typename T>
struct As;
template <>
struct As<float> {
  __device__ __forceinline__ static float from(float x) { return x; }
};
template <>
struct As<bf16> {
  __device__ __forceinline__ static bf16 from(float x) { return __float2bfloat16_rn(x); }
};

// a read-only element to float: __ldg for float32; a plain load for bf16.
// cuda_bf16.hpp's __ldg(const __nv_bfloat16*) is an asm statement that is
// not volatile and names no memory, so nvcc takes it for a pure function of
// the pointer and may run it outside the branch that guards it: in the
// encoder scan's add_ln_kernel at D 64 it hoisted the second LN's weight
// loads above `if (s2)` into the kernel's prologue, and a null s2 faulted.
// A plain load stays under its guard.
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16* p) { return __bfloat162float(*p); }

// x rounded to T and read back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return f32(As<T>::from(x));
}

// four consecutive elements (16-byte aligned floats, 8-byte aligned bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// two consecutive elements (8-byte aligned floats, 4-byte aligned bf16)
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

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
