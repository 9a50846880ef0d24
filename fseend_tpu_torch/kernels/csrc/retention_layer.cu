// A whole retention layer with carried chunk state on Hopper, float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/retention_layer_pallas.py
// (_forward and its _kernel; fused_retention_layer): the q/k/v/g projections
// (+bias, k scaled by dk^-1/2), the chunkwise core per head with per-head
// decay, the per-head group norm (eps 1e-6, non-affine), the silu(g) gate and
// the out projection (+bias).  x (B, T, D) and the state in, y (B, T, D) and
// the new state out.
//
// What bounds it on the card: operations.  Per frame 2 D (2D + 2F) + 2 F D
// for the projections (10 D^2 at F = D) and H ((L + 1)(dk + dv) + 4 dk dv)
// for the core, against 8 D bytes of x and y.
//
// The TPU kernel is one call that keeps q, k, v, g and the core's output in
// its 100 MB of VMEM.  A Hopper block has 227 KB, and the projections want
// many rows per weight tile while the core wants one (batch, head) row per
// block, so one launch of this file is three kernels on the caller's stream
// around one workspace ws (B*T, 2D + 2F) = q | k | v | g:
//   1. linear_kernel: ws = x Wqkvg^T + b, the k columns scaled;
//   2. cr::core_kernel<FINISH>: the chunkwise core (chunk_retention_core.cuh)
//      reading q, k, v from ws, with the group norm and the gate in its
//      epilogue, written over the head's g columns;
//   3. linear_kernel: y = ws[g columns] Wo^T + bo.
// So q, k, v and g make one round trip through device memory (L2 for the
// encoder's sizes); the core's output and the gated output make none beyond
// the g columns.  linear_kernel is a shared-memory tiled product, 128 x 128
// output tile and 8 x 8 values per thread, weights in torch's (out, in)
// layout (both operands contiguous along the summed index).
#include "chunk_retention_core.cuh"

#ifndef CR_DK
#error "define CR_DK and CR_DV (the key and value dims of a head)"
#endif

namespace {

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int LDS = BM + 4;

// C[m][n] = (bias[n] + sum_k A[m][k] W[n][k]) * (s if s_lo <= n < s_hi else 1)
// A (M, K) with row stride lda, W (N, K) contiguous, C row stride ldc.
// K % 16 == 0, N % 4 == 0, every row start 16-byte aligned.
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
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + jh * 64 + tx * 4;
      if (n >= N) continue;  // N % 4 == 0: a group of four is in or out as a whole
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = acc[i][jh * 4 + j] + __ldg(bias + n + j);
        if (n + j >= s_lo && n + j < s_hi) o[j] *= s;
      }
      *reinterpret_cast<float4*>(C + (size_t)m * ldc + n) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

int launch_linear(const float* A, int lda, const float* W, const float* bias, float* C,
                  int ldc, int M, int N, int K, int s_lo, int s_hi, float s,
                  cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_kernel<<<grid, 256, 0, stream>>>(A, lda, W, bias, C, ldc, M, N, K, s_lo, s_hi, s);
  return cudaGetLastError();
}

}  // namespace

// gamma (H); x, y (B, T, D) with D = H * CR_DK; wqkvg (2D + 2F, D) = q | k | v |
// g rows and wo (D, F) in torch's (out, in) layout, F = H * CR_DV; ws (B*T,
// 2D + 2F) scratch; kv0, kvf (B, H, CR_DK, CR_DV); s0, sf (B, H).  T % L == 0,
// B*T <= 128 * 65535.  Returns the first CUDA error of the three launches.
extern "C" int retention_layer_launch(const float* gamma, const float* x,
                                      const float* wqkvg, const float* bqkvg,
                                      const float* wo, const float* bo, float* ws,
                                      float* y, const float* kv0, const float* s0,
                                      float* kvf, float* sf, int B, int T, int L, int H,
                                      float kscale, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int D = H * CR_DK, F = H * CR_DV, W = 2 * D + 2 * F, M = B * T;
  int err = launch_linear(x, D, wqkvg, bqkvg, ws, W, M, W, D, D, 2 * D, kscale, stream);
  if (err != 0) return err;
  float* g = ws + 2 * D + F;
  cr::CoreArgs a{ws, ws + D, ws + 2 * D, W, W, W, g, W, gamma, H,
                 kv0, s0, kvf, sf, H, T, L};
  err = cr::launch_core<CR_DK, CR_DV, true>(a, B * H, stream);
  if (err != 0) return err;
  return launch_linear(g, W, wo, bo, y, D, M, D, F, 0, 0, 1.f, stream);
}
