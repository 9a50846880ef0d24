// Float32-exact matrix products on Hopper's tensor cores ("3xTF32"), shared
// by the two frame scans (every linear layer of the block: dec_frame_scan.cu,
// enc_frame_scan.cu), cached_attention.cu (q k^T and p v of the shared-head
// kernel), the fusion layer's forward and backward (dec_train_fusion_seq.cuh,
// dec_train_fusion_bwd.cu: its products, input gradients and weight
// gradients), the retention layer's projections (retention_layer.cu) and the
// chunkwise core's products (chunk_retention_tc.cuh).
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

// The precise form (linear_kernel's PRECISE): small rounded to nearest as
// well, |small - small'| <= 2^-23 |x| (half the truncation's error).
__device__ __forceinline__ void split_rn(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
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

template <bool RN = false>
__device__ __forceinline__ void split_to(float x, uint32_t& big, uint32_t& small) {
  if (RN)
    split_rn(x, big, small);
  else
    split(x, big, small);
}

template <bool RN = false>
__device__ __forceinline__ void set_a(FragA& f, float v0, float v1, float v2, float v3) {
  split_to<RN>(v0, f.big[0], f.small[0]);
  split_to<RN>(v1, f.big[1], f.small[1]);
  split_to<RN>(v2, f.big[2], f.small[2]);
  split_to<RN>(v3, f.big[3], f.small[3]);
}

// A fragment of the row-major 16 x 8 tile at p (row stride ld)
template <bool RN = false>
__device__ __forceinline__ void load_a(FragA& f, const float* p, int ld) {
  const int g = lane_g(), t = lane_t();
  set_a<RN>(f, p[g * ld + t], p[(g + 8) * ld + t], p[g * ld + t + 4], p[(g + 8) * ld + t + 4]);
}

// A fragment of the 16 x 8 tile whose element (m, k) is p[k * ld + m] (the
// transpose of a row-major 8 x 16 tile)
__device__ __forceinline__ void load_a_t(FragA& f, const float* p, int ld) {
  const int g = lane_g(), t = lane_t();
  set_a(f, p[t * ld + g], p[t * ld + g + 8], p[(t + 4) * ld + g], p[(t + 4) * ld + g + 8]);
}

// B fragment of the 8 x 8 tile whose element (k, n) is p[k * ldk + n * ldn]
template <bool RN = false>
__device__ __forceinline__ void load_b(FragB& f, const float* p, int ldk, int ldn) {
  const int g = lane_g(), t = lane_t();
  split_to<RN>(p[t * ldk + g * ldn], f.big[0], f.small[0]);
  split_to<RN>(p[(t + 4) * ldk + g * ldn], f.big[1], f.small[1]);
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
// sc(n) = s for s_lo <= n < s_hi, else 1, added to C[m][n] when ACC (after
// the activation).  A (M, K) row stride lda, W (K, N)
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
// PRECISE: the tensor core's float32 accumulation does not round to
// nearest, and the small passes' terms land in a large accumulator, so a
// long sum (k of 1024-2048) loses accuracy: the fusion layer's backward,
// whose dx (of O(4), with cancellation) is held within 1e-4 of float32,
// missed that with the plain form.  The precise form takes each 32-deep k
// tile's three passes into a fresh accumulator and adds that to the
// running sum on the FMA pipe (rounded to nearest), with `small` rounded
// to nearest too (split_rn), at 64 more registers a thread.  The backward
// uses it; the frame scans and the cached attention keep the plain form.
//
// A product of few output tiles (few rows: the decoder's step() has B*C)
// and a long k is split along k over gridDim.z blocks when the caller gives
// scratch: each writes its raw partial sums, and splitk_reduce_kernel adds
// them in a fixed order, adds the bias and applies the scale and the
// activation, so the result does not depend on the order the blocks ran in.
// ---------------------------------------------------------------------------

enum Act { kNone = 0, kRelu = 1, kSilu = 2 };

__device__ __forceinline__ float act_silu(float v) { return v * (1.f / (1.f + expf(-v))); }

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
// d += a warp's 64 x 32 share of one 32-deep k tile: A rows at As (stride
// LDA), W columns at Ws (stride LDW); RN: split_rn
template <bool RN>
__device__ __forceinline__ void tile_mma(float (&d)[4][4][4], const float* As, const float* Ws) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    FragA fa[4];
    FragB fb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_a<RN>(fa[i], As + i * 16 * LDA + ks * 8, LDA);
#pragma unroll
    for (int j = 0; j < 4; ++j) load_b<RN>(fb[j], Ws + ks * 8 * LDW + j * 8, LDW, 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma3(d[i][j], fa[i], fb[j]);
  }
}

template <int ACT, bool PART, bool ACC = false, bool PRECISE = false>
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
    if (PRECISE) {
      float part[4][4][4];  // this k tile's sums
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      tile_mma<true>(part, As, Ws);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    } else {
      tile_mma<false>(acc, As, Ws);
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
        if (ACT == kSilu && !PART) v0 = act_silu(v0), v1 = act_silu(v1);
        float2* out = reinterpret_cast<float2*>(C + (size_t)m * ldc + n);
        if (ACC && !PART) {
          const float2 c = *out;
          v0 += c.x, v1 += c.y;
        }
        *out = make_float2(v0, v1);
      }
    }
  }
}

// C[m][n] = act((bias[n] + sum_{z < S} P[z][m][n]) * sc(n)), P (S, M, N),
// added to C[m][n] when ACC; the partials are added in the order of z
template <int ACT, bool ACC = false>
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
    if (ACT == kSilu) v = act_silu(v);
    if (ACC) v += C[(size_t)m * ldc + n];
    C[(size_t)m * ldc + n] = v;
  }
}

// returns the first CUDA error of the launches.  `part` (kSplitFloats
// floats, or null) is the scratch of a split along k.
template <int ACT = kNone, bool ACC = false, bool PRECISE = false>
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
    cudaError_t err = cudaFuncSetAttribute(linear_kernel<ACT, false, ACC, PRECISE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    linear_kernel<ACT, false, ACC, PRECISE><<<grid, 256, smem, stream>>>(
        A, lda, W, ldw, bias, C, ldc, M, N, K, s_lo, s_hi, s, ktiles);
    return cudaGetLastError();
  }
  const int per = (ktiles + split - 1) / split;
  split = (ktiles + per - 1) / per;
  cudaError_t err = cudaFuncSetAttribute(linear_kernel<kNone, true, false, PRECISE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  linear_kernel<kNone, true, false, PRECISE><<<dim3(grid.x, grid.y, split), 256, smem, stream>>>(
      A, lda, W, ldw, nullptr, part, N, M, N, K, 0, 0, 1.f, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < kSMs * 8 ? (total + 255) / 256 : kSMs * 8);
  splitk_reduce_kernel<ACT, ACC><<<blocks, 256, 0, stream>>>(part, split, bias, C, ldc, M, N,
                                                             s_lo, s_hi, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad_kernel: G[n][k] = sum_m A[m][n] X[m][k], the weight gradient of a
// linear layer over many rows: A (M, N) the output gradient (row stride
// lda), X (M, K) the input (row stride ldx), G (N, K) in torch's (out, in)
// layout.  The rows are cut into gridDim.z slices of `per` rows; each block
// writes its slice's raw sums of one 128 x 128 tile of G to P + z * N * K (G
// itself when there is one slice), and splitk_reduce_kernel adds the slices
// in the order of z.  So no element is added to by two blocks and the result
// is the same to the bit from run to run (no atomics).  N, K % 4 == 0, lda,
// ldx % 4 == 0, 16-byte aligned bases.
//
// The same tiles and pipeline as linear_kernel, with both operands read as
// row-major 32 x 128 tiles (rows of the slice by columns of A or X): the A
// fragment is the transpose of its tile (load_a_t).
// ---------------------------------------------------------------------------

constexpr int LDG = BN + 8;  // row stride of both tiles (32 distinct banks for either fragment)
constexpr int kGradStageFloats = 2 * BK * LDG;
constexpr int wgrad_smem_bytes() { return (int)sizeof(float) * kStages * kGradStageFloats; }

__global__ void __launch_bounds__(256)
wgrad_kernel(const float* __restrict__ A, int lda, const float* __restrict__ X, int ldx,
             float* __restrict__ P, int M, int N, int K, int per) {
  extern __shared__ __align__(16) float gsm[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.y * BM, k0 = blockIdx.x * BN;
  const int r0 = blockIdx.z * per, r1 = min(M, r0 + per);
  const int ntiles = (r1 - r0 + BK - 1) / BK;
  P += (size_t)blockIdx.z * N * K;

  auto load_stage = [&](int stage, int kt) {
    float* As = gsm + stage * kGradStageFloats;
    float* Xs = As + BK * LDG;
    const int m0 = r0 + kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // each: 32 rows x 32 chunks of 4
      const int idx = tid + i * 256, r = idx >> 5, c4 = (idx & 31) * 4;
      const bool in = m0 + r < r1;
      const bool oka = in && n0 + c4 < N, okx = in && k0 + c4 < K;
      cp_async16(As + r * LDG + c4, oka ? A + (size_t)(m0 + r) * lda + n0 + c4 : A, oka);
      cp_async16(Xs + r * LDG + c4, okx ? X + (size_t)(m0 + r) * ldx + k0 + c4 : X, okx);
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
    const float* As = gsm + (kt % kStages) * kGradStageFloats + wm * 64;
    const float* Xs = gsm + (kt % kStages) * kGradStageFloats + BK * LDG + wn * 32;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      FragA fa[4];
      FragB fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a_t(fa[i], As + ks * 8 * LDG + i * 16, LDG);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_b(fb[j], Xs + ks * 8 * LDG + j * 8, LDG, 1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(acc[i][j], fa[i], fb[j]);
    }
  }

  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + wn * 32 + j * 8 + 2 * t;
    if (k >= K) continue;  // K % 4 == 0: k and k + 1 are in or out together
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * 64 + i * 16 + g + 8 * h;
        if (n < N)
          *reinterpret_cast<float2*>(P + (size_t)n * K + k) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// Row slices so that the (tile, slice) blocks about fill two blocks per SM
// (kSplitBlocks), at least 512 rows a slice; `part` (kSplitFloats floats)
// holds the slices' partials.  Returns the first CUDA error of the launches.
inline int launch_wgrad(const float* A, int lda, const float* X, int ldx, float* G, int M, int N,
                        int K, cudaStream_t stream, float* part) {
  const int smem = wgrad_smem_bytes();
  const int tiles = ((N + BM - 1) / BM) * ((K + BN - 1) / BN);
  int slices = kSplitBlocks / tiles;
  if (slices > (M + 511) / 512) slices = (M + 511) / 512;
  if (slices < 1) slices = 1;
  const int per = ((M + slices - 1) / slices + BK - 1) / BK * BK;
  slices = (M + per - 1) / per;
  cudaError_t err =
      cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + BN - 1) / BN, (N + BM - 1) / BM, slices);
  wgrad_kernel<<<grid, 256, smem, stream>>>(A, lda, X, ldx, slices == 1 ? G : part, M, N, K, per);
  if ((err = cudaGetLastError()) != cudaSuccess || slices == 1) return err;
  const long long total = (long long)N * K;
  const int blocks = (int)((total + 255) / 256 < kSMs * 8 ? (total + 255) / 256 : kSMs * 8);
  splitk_reduce_kernel<kNone><<<blocks, 256, 0, stream>>>(part, slices, nullptr, G, K, N, K, 0, 0,
                                                          1.f);
  return cudaGetLastError();
}

// P[z][n] = sum of A[m][n] over the rows m of slice z, in row order
__global__ void colsum_part_kernel(const float* __restrict__ A, int lda, float* __restrict__ P,
                                   int M, int N, int per) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * per, r1 = min(M, r0 + per);
  float s = 0.f;
  for (int m = r0; m < r1; ++m) s += A[(size_t)m * lda + n];
  P[(size_t)blockIdx.y * N + n] = s;
}

// g[n] = sum_m A[m][n] (a bias gradient): slices of at least 256 rows, then
// the slices added in order (splitk_reduce_kernel), so the same to the bit
// from run to run.  `part` holds kSplitFloats floats.
inline int launch_colsum(const float* A, int lda, float* g, int M, int N, cudaStream_t stream,
                         float* part) {
  int per = 256;
  const long long most = (long long)kSplitFloats / N;  // slices the scratch holds
  if ((M + per - 1) / per > most) per = (int)((M + most - 1) / most);
  const int slices = (M + per - 1) / per;
  colsum_part_kernel<<<dim3((N + 255) / 256, slices), 256, 0, stream>>>(A, lda, part, M, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  splitk_reduce_kernel<kNone><<<(N + 255) / 256, 256, 0, stream>>>(part, slices, nullptr, g, N,
                                                                   1, N, 0, 0, 1.f);
  return cudaGetLastError();
}

}  // namespace tc
