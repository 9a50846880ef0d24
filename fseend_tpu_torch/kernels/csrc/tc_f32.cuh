// Float32-exact matrix products on Hopper's tensor cores ("3xTF32"), shared
// by dec_frame_scan.cu (every linear layer of the decoder block) and
// cached_attention.cu (q k^T and p v of the shared-head kernel).
//
// Pipe: the tensor cores, through the warp-level
// `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` (float32
// accumulator).  Peak on an H100 SXM: 495 TFLOP/s TF32 dense, so about 165
// TFLOP/s of float32-exact work at three passes; the FMA pipe's float32 peak
// is 67 TFLOP/s.  (wgmma would reach further; mma.sync is the simple form.)
//
// The split: a float32 x is cut into big, x rounded to 11 significant bits
// (to nearest, ties away, by an integer add and mask), and small = x - big
// (exact in float32), handed to the tensor core as it is: the core reads
// the top 19 bits of a TF32 register, so it truncates small to its 11
// significant bits, |small - small'| < 2^-21 |x|.  No cvt: the conversion
// pipe runs at a quarter of the FMA pipe's rate and would set the pace.  A
// product a b is taken as a_big b_small + a_small b_big + a_big b_big,
// accumulated in float32 (small terms first).  The dropped a_small b_small
// (<= 2^-22 |a b|) and the two truncations leave at most about 1.2e-6 of
// |a b| per product, against float32's own 2^-24 rounding: a dot product
// comes out within about 1e-6 of sum |a_i b_i| of the float32 result, where
// one TF32 pass would be within about 1e-3.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tc {

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b for one 16 x 8 x 8 tile, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operand fragments, split.  With g = lane / 4 and t = lane % 4, the A
// fragment of a 16 x 8 tile holds (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); the B fragment of an 8 x 8 tile (k, n) holds (t, g),
// (t + 4, g); the accumulator of a 16 x 8 tile holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

__device__ __forceinline__ void set_a(FragA& f, float v0, float v1, float v2, float v3) {
  split(v0, f.big[0], f.small[0]);
  split(v1, f.big[1], f.small[1]);
  split(v2, f.big[2], f.small[2]);
  split(v3, f.big[3], f.small[3]);
}

// A fragment of the row-major 16 x 8 tile at p (row stride ld)
__device__ __forceinline__ void load_a(FragA& f, const float* p, int ld) {
  const int g = lane_g(), t = lane_t();
  set_a(f, p[g * ld + t], p[(g + 8) * ld + t], p[g * ld + t + 4], p[(g + 8) * ld + t + 4]);
}

// B fragment of the 8 x 8 tile whose element (k, n) is p[k * ldk + n * ldn]
__device__ __forceinline__ void load_b(FragB& f, const float* p, int ldk, int ldn) {
  const int g = lane_g(), t = lane_t();
  split(p[t * ldk + g * ldn], f.big[0], f.small[0]);
  split(p[(t + 4) * ldk + g * ldn], f.big[1], f.small[1]);
}

// d += a b, float32-exact (three TF32 passes, small terms first)
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.big);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

// 4-byte form for rows that are not 16-byte multiples
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// linear_kernel: C[m][n] = act((bias[n] + sum_k A[m][k] W[k][n]) * sc(n)),
// sc(n) = s for s_lo <= n < s_hi, else 1.  A (M, K) row stride lda, W (K, N)
// in the (in, out) layout with row stride ldw, C row stride ldc, bias may be
// null.  K % 4 == 0, N % 4 == 0, lda, ldw % 4 == 0, ldc % 2 == 0, 16-byte
// aligned bases.
//
// A 128 x 128 output tile per block of 256 threads (8 warps as 2 x 4, a
// 64 x 32 warp tile of 4 x 4 mma tiles), 32 along k per stage, three
// stages of cp.async copies in flight, so the next tiles' loads overlap the
// current tile's products.  Shared rows are padded (A by 4, W by 8 words) so
// that the fragment loads of a warp hit 32 distinct banks.
//
// A product of few output tiles (few rows: the decoder's step() has B*C)
// and a long k is split along k over gridDim.z blocks when the caller gives
// scratch: each writes its raw partial sums, and splitk_reduce_kernel adds
// them in a fixed order, adds the bias and applies the scale and the
// activation, so the result does not depend on the order the blocks ran in.
// ---------------------------------------------------------------------------

enum Act { kNone = 0, kRelu = 1 };

constexpr int BM = 128, BN = 128, BK = 32, kStages = 3;
constexpr int LDA = BK + 4, LDW = BN + 8;
constexpr int kStageFloats = BM * LDA + BK * LDW;
constexpr int linear_smem_bytes() { return (int)sizeof(float) * kStages * kStageFloats; }

constexpr int kMaxSplit = 8;
constexpr int kSMs = 132;  // an H100 SXM's
// the scratch a split needs at most: a product splits only while it has
// fewer output tiles than the card has SMs, into at most kSplitBlocks
// (tile, split) blocks
constexpr int kSplitBlocks = 2 * kSMs;
constexpr size_t kSplitFloats = (size_t)kSplitBlocks * BM * BN;

// PART: write the raw sums of k tiles [z * per, (z + 1) * per) to
// C + z * M * ldc (no bias, scale or activation)
template <int ACT, bool PART>
__global__ void __launch_bounds__(256)
linear_kernel(const float* __restrict__ A, int lda, const float* __restrict__ W, int ldw,
              const float* __restrict__ bias, float* __restrict__ C, int ldc, int M, int N,
              int K, int s_lo, int s_hi, float s, int per) {
  extern __shared__ __align__(16) float lsm[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = PART ? blockIdx.z * per : 0;
  const int ktiles = (K + BK - 1) / BK;
  const int ntiles = PART ? min(per, ktiles - kt0) : ktiles;
  if (PART) C += (size_t)blockIdx.z * M * ldc;

  auto load_stage = [&](int stage, int kt) {
    float* As = lsm + stage * kStageFloats;
    float* Ws = As + BM * LDA;
    const int k0 = (kt0 + kt) * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // A: 128 rows x 8 chunks of 4
      const int idx = tid + i * 256, r = idx >> 3, c4 = (idx & 7) * 4;
      const bool ok = m0 + r < M && k0 + c4 < K;
      cp_async16(As + r * LDA + c4, ok ? A + (size_t)(m0 + r) * lda + k0 + c4 : A, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // W: 32 rows x 32 chunks of 4
      const int idx = tid + i * 256, r = idx >> 5, c4 = (idx & 31) * 4;
      const bool ok = k0 + r < K && n0 + c4 < N;
      cp_async16(Ws + r * LDW + c4, ok ? W + (size_t)(k0 + r) * ldw + n0 + c4 : W, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < ntiles) load_stage(nxt % kStages, nxt);
    cp_async_commit();
    const float* As = lsm + (kt % kStages) * kStageFloats + wm * 64 * LDA;
    const float* Ws = lsm + (kt % kStages) * kStageFloats + BM * LDA + wn * 32;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      FragA fa[4];
      FragB fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a(fa[i], As + i * 16 * LDA + ks * 8, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_b(fb[j], Ws + ks * 8 * LDW + j * 8, LDW, 1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(acc[i][j], fa[i], fb[j]);
    }
  }

  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + 2 * t;
    if (n >= N) continue;  // N % 4 == 0: n and n + 1 are in or out together
    const float b0 = bias && !PART ? __ldg(bias + n) : 0.f;
    const float b1 = bias && !PART ? __ldg(bias + n + 1) : 0.f;
    const float s0 = !PART && n >= s_lo && n < s_hi ? s : 1.f;
    const float s1 = !PART && n + 1 >= s_lo && n + 1 < s_hi ? s : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        float v0 = (acc[i][j][2 * h] + b0) * s0, v1 = (acc[i][j][2 * h + 1] + b1) * s1;
        if (ACT == kRelu && !PART) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
        *reinterpret_cast<float2*>(C + (size_t)m * ldc + n) = make_float2(v0, v1);
      }
    }
  }
}

// C[m][n] = act((bias[n] + sum_{z < S} P[z][m][n]) * sc(n)), P (S, M, N)
template <int ACT>
__global__ void splitk_reduce_kernel(const float* __restrict__ P, int S,
                                     const float* __restrict__ bias, float* __restrict__ C,
                                     int ldc, int M, int N, int s_lo, int s_hi, float s) {
  const long long total = (long long)M * N;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(e / N), n = (int)(e % N);
    float v = bias ? __ldg(bias + n) : 0.f;
    for (int z = 0; z < S; ++z) v += P[(size_t)z * total + e];
    if (n >= s_lo && n < s_hi) v *= s;
    if (ACT == kRelu) v = fmaxf(v, 0.f);
    C[(size_t)m * ldc + n] = v;
  }
}

// returns the first CUDA error of the launches.  `part` (kSplitFloats
// floats, or null) is the scratch of a split along k.
template <int ACT = kNone>
inline int launch_linear(const float* A, int lda, const float* W, int ldw, const float* bias,
                         float* C, int ldc, int M, int N, int K, cudaStream_t stream,
                         int s_lo = 0, int s_hi = 0, float s = 1.f, float* part = nullptr) {
  const int smem = linear_smem_bytes();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int tiles = (int)(grid.x * grid.y), ktiles = (K + BK - 1) / BK;
  int split = 1;
  if (part && tiles < kSMs) {  // at least 4 k tiles (128 deep) per split
    split = min(min(kMaxSplit, ktiles / 4), kSplitBlocks / tiles);
    if (split < 1) split = 1;
  }
  if (split == 1) {
    cudaError_t err = cudaFuncSetAttribute(linear_kernel<ACT, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    linear_kernel<ACT, false><<<grid, 256, smem, stream>>>(A, lda, W, ldw, bias, C, ldc, M, N,
                                                           K, s_lo, s_hi, s, ktiles);
    return cudaGetLastError();
  }
  const int per = (ktiles + split - 1) / split;
  split = (ktiles + per - 1) / per;
  cudaError_t err = cudaFuncSetAttribute(linear_kernel<kNone, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  linear_kernel<kNone, true><<<dim3(grid.x, grid.y, split), 256, smem, stream>>>(
      A, lda, W, ldw, nullptr, part, N, M, N, K, 0, 0, 1.f, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < kSMs * 8 ? (total + 255) / 256 : kSMs * 8);
  splitk_reduce_kernel<ACT><<<blocks, 256, 0, stream>>>(part, split, bias, C, ldc, M, N, s_lo,
                                                        s_hi, s);
  return cudaGetLastError();
}

}  // namespace tc
