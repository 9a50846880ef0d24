// Float32 matrix products on the FMA pipe, for retention_layer.cu (B4).
//
// linear_kernel: C = A W^T + bias, the product of a
//   row-major activation A (M, K) with a weight W (N, K) in torch's (out, in)
//   layout: both operands are contiguous along the summed index.
// Shared-memory tiled: a 128 x 128 output tile per block of 256 threads, 8 x 8
// values per thread, 16 along the summed index per step.
#pragma once

#include <cuda_runtime.h>

namespace lin {

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int LDS = BM + 4;

// the 8 x 8 register tile of a thread: As[k][m], Bs[k][n], k-major
__device__ __forceinline__ void tile_fma(const float* As, const float* Bs, int tx, int ty,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDS + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(As + kk * LDS + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LDS + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * LDS + 64 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// row (or column) of the tile that a thread's i-th accumulator row maps to
__device__ __forceinline__ int tile_row(int t, int i) { return i < 4 ? t * 4 + i : 64 + t * 4 + i - 4; }

// C[m][n] = (bias[n] + sum_k A[m][k] W[n][k]) * (s if s_lo <= n < s_hi else 1).
// A (M, K) with row stride lda, W (N, K) contiguous, C
// row stride ldc, bias may be null.  K % 16 == 0, N % 4 == 0, every row start
// 16-byte aligned.
__global__ void __launch_bounds__(256)
linear_kernel(const float* __restrict__ A, int lda, const float* __restrict__ W,
              const float* __restrict__ bias, float* __restrict__ C, int ldc, int M,
              int N, int K, int s_lo, int s_hi, float s) {
  __shared__ __align__(16) float As[BK * LDS];  // k-major: As[k][m]
  __shared__ __align__(16) float Bs[BK * LDS];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256, r = idx >> 2, k4 = (idx & 3) * 4;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (m0 + r < M)
        va = *reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * lda + k0 + k4);
      if (n0 + r < N)
        vb = *reinterpret_cast<const float4*>(W + (size_t)(n0 + r) * K + k0 + k4);
      As[(k4 + 0) * LDS + r] = va.x;
      As[(k4 + 1) * LDS + r] = va.y;
      As[(k4 + 2) * LDS + r] = va.z;
      As[(k4 + 3) * LDS + r] = va.w;
      Bs[(k4 + 0) * LDS + r] = vb.x;
      Bs[(k4 + 1) * LDS + r] = vb.y;
      Bs[(k4 + 2) * LDS + r] = vb.z;
      Bs[(k4 + 3) * LDS + r] = vb.w;
    }
    __syncthreads();
    tile_fma(As, Bs, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_row(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + jh * 64 + tx * 4;
      if (n >= N) continue;  // N % 4 == 0: a group of four is in or out as a whole
      float4* out = reinterpret_cast<float4*>(C + (size_t)m * ldc + n);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = acc[i][jh * 4 + j] + (bias ? __ldg(bias + n + j) : 0.f);
        if (n + j >= s_lo && n + j < s_hi) o[j] *= s;
      }
      *out = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

inline int launch_linear(const float* A, int lda, const float* W, const float* bias, float* C,
                         int ldc, int M, int N, int K, cudaStream_t stream, int s_lo = 0,
                         int s_hi = 0, float s = 1.f) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_kernel<<<grid, 256, 0, stream>>>(A, lda, W, bias, C, ldc, M, N, K, s_lo, s_hi, s);
  return cudaGetLastError();
}

}  // namespace lin
