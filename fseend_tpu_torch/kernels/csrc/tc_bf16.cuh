// bf16 matrix products with float32 accumulation on Hopper's tensor cores,
// one pass: the bf16 forms of the frame scans (dec_frame_scan.cu,
// enc_frame_scan.cu), of the retention layer (retention_layer.cu and the
// q k^T scores of chunk_retention_tc.cuh) and of the fusion layer's forward
// and backward (dec_train_fusion_{fwd,bwd}.cu, whose weight gradients run
// wgrad_bf16_kernel below), built with FS_BF16.
//
// Pipe: the tensor cores, through the warp-level
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`.  A product of two
// bf16 values is exact in float32 and the sums run in the float32
// accumulator: JAX's `dot_general(..., preferred_element_type=float32)` on
// bf16 operands (fseend_tpu/kernels/_common.py:mm), up to the order of the
// sums.  Peak on an H100 SXM: 989 TFLOP/s dense, twice TF32's and six times
// the 3xTF32 products of tc_f32.cuh.
//
// The same tile and launch interface as tc_f32.cuh's float32 products
// (tc::launch_linear, its 128 x 128 block tile, the split along k for
// products of few rows), so that a kernel picks its product by element
// type at compile time: launch_linear with bf16 operands resolves here.
#pragma once

#include <cstdint>

#include "frame_scan_common.cuh"
#include "tc_f32.cuh"

namespace tc {

using fs::bf16;

// d += a b for one 16 x 8 x 16 tile, bf16 operands, float32 accumulator.
// With g = lane / 4 and t = lane % 4 (each register two bf16, the lower
// half first): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] = (g,
// 2t+8..), a[3] = (g + 8, 2t+8..) of the 16 x 16 A tile; b[0] = (k 2t..2t+1,
// n g), b[1] = (k 2t+8.., n g) of the 16 x 8 B tile; the accumulator as in
// tc_f32.cuh: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The A fragment of the row-major 16 x 16 tile at p (row stride ld
// elements, a multiple of 8)
__device__ __forceinline__ void load_a16(uint32_t (&a)[4], const bf16* p, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, p + (l & 15) * ld + (l >> 4) * 8);
}

// The B fragments of two 16 x 8 tiles side by side, from the row-major
// (k, n) tile at p (row stride ld): b0 for columns 0..7, b1 for 8..15
__device__ __forceinline__ void load_b16x2(uint32_t (&b0)[2], uint32_t (&b1)[2], const bf16* p,
                                           int ld) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4_t(r, p + (l & 15) * ld + (l >> 4) * 8);
  b0[0] = r[0], b0[1] = r[1], b1[0] = r[2], b1[1] = r[3];
}

// ---------------------------------------------------------------------------
// linear_bf16_kernel: C[m][n] = act((bias[n] + sum_k A[m][k] W[k][n]) *
// sc(n)) rounded to TO (float, or bf16 where the TPU kernel rounds the
// product to its data type), sc(n) = s for s_lo <= n < s_hi, else 1; a
// scaled bf16 column is rounded before it is scaled and after, as the TPU
// kernel scales the rounded k by a bf16 dk^-1/2 (the caller passes s
// rounded to bf16; exact when it is a power of 2).  A (M,
// K) bf16, row stride lda; W (K, N) bf16 in the (in, out) layout, row stride
// ldw; bias (N) bf16 or null.  K % 8 == 0, N % 8 == 0, lda, ldw % 8 == 0,
// ldc % 2 == 0, 16-byte aligned bases.
//
// The float32 kernel's tiles: 128 x 128 outputs per block of 256 threads (8
// warps as 2 x 4, a 64 x 32 warp tile of 4 x 4 mma tiles), 32 along k per
// stage, three stages of 16-byte cp.async copies in flight.  Shared rows are
// padded by 8 elements (16 bytes) so that the ldmatrix rows of a phase hit
// distinct banks.  PART: the raw sums of k tiles [z * per, (z + 1) * per) in
// float32 to P + z * M * N, added in the order of z by
// splitk_reduce_bf16_kernel (the same bits whatever order the blocks ran in).
// ACC (TO = float): the result is added to C (an input gradient gathering
// into a float32 residual stream).  PRECISE: tc_f32.cuh's precise form for
// bf16 operands (each 32-deep k tile's sum taken in a fresh accumulator and
// added to the running sum on the FMA pipe, rounded to nearest), because
// the tensor core's accumulator truncates and, over the fusion layer's
// 256-2048-deep sums, the drift moves the bf16 roundings downstream of a
// product away from the plain version's (the fusion layer's bf16 forms use
// it; the frame scans and the retention layer keep the plain form).
// ---------------------------------------------------------------------------

constexpr int LDAB = BK + 8, LDWB = BN + 8;
constexpr int kStageB16 = BM * LDAB + BK * LDWB;  // bf16 elements of a stage
constexpr int linear_bf16_smem_bytes() { return (int)sizeof(bf16) * kStages * kStageB16; }

template <int ACT>
__device__ __forceinline__ float apply_act(float v) {
  if (ACT == kRelu) v = fmaxf(v, 0.f);
  if (ACT == kSilu) v = act_silu(v);
  return v;
}

// d += a warp's 64 x 32 share of one 32-deep k tile: A rows at As (stride
// LDAB), W columns at Ws (stride LDWB)
__device__ __forceinline__ void tile_mma_bf16(float (&d)[4][4][4], const bf16* As,
                                              const bf16* Ws) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t fa[4][4], fb[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_a16(fa[i], As + i * 16 * LDAB + ks * 16, LDAB);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      load_b16x2(fb[2 * j], fb[2 * j + 1], Ws + ks * 16 * LDWB + j * 16, LDWB);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(d[i][j], fa[i], fb[j]);
  }
}

// acc += part, element by element, on the FMA pipe
__device__ __forceinline__ void add_tile(float (&acc)[4][4][4], const float (&part)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

template <int ACT, bool PART, typename TO, bool ACC = false, bool PRECISE = false>
__global__ void __launch_bounds__(256)
linear_bf16_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ W, int ldw,
                   const bf16* __restrict__ bias, TO* __restrict__ C, float* __restrict__ P,
                   int ldc, int M, int N, int K, int s_lo, int s_hi, float s, int per) {
  extern __shared__ __align__(16) bf16 bsm[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = PART ? blockIdx.z * per : 0;
  const int ktiles = (K + BK - 1) / BK;
  const int ntiles = PART ? min(per, ktiles - kt0) : ktiles;
  if (PART) P += (size_t)blockIdx.z * M * N;

  auto load_stage = [&](int stage, int kt) {
    bf16* As = bsm + stage * kStageB16;
    bf16* Ws = As + BM * LDAB;
    const int k0 = (kt0 + kt) * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 chunks of 8
      const int idx = tid + i * 256, r = idx >> 2, c8 = (idx & 3) * 8;
      const bool ok = m0 + r < M && k0 + c8 < K;
      cp_async16(As + r * LDAB + c8, ok ? A + (size_t)(m0 + r) * lda + k0 + c8 : A, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // W: 32 rows x 16 chunks of 8
      const int idx = tid + i * 256, r = idx >> 4, c8 = (idx & 15) * 8;
      const bool ok = k0 + r < K && n0 + c8 < N;
      cp_async16(Ws + r * LDWB + c8, ok ? W + (size_t)(k0 + r) * ldw + n0 + c8 : W, ok);
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
    const bf16* As = bsm + (kt % kStages) * kStageB16 + wm * 64 * LDAB;
    const bf16* Ws = bsm + (kt % kStages) * kStageB16 + BM * LDAB + wn * 32;
    if (PRECISE) {
      float part[4][4][4];  // this k tile's sums
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      tile_mma_bf16(part, As, Ws);
      add_tile(acc, part);
    } else {
      tile_mma_bf16(acc, As, Ws);
    }
  }

  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: n and n + 1 are in or out together
    const float b0 = bias && !PART ? fs::f32(bias[n]) : 0.f;
    const float b1 = bias && !PART ? fs::f32(bias[n + 1]) : 0.f;
    const bool in0 = n >= s_lo && n < s_hi, in1 = n + 1 >= s_lo && n + 1 < s_hi;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        if (PART) {
          *reinterpret_cast<float2*>(P + (size_t)m * N + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          float v0 = acc[i][j][2 * h] + b0, v1 = acc[i][j][2 * h + 1] + b1;
          if (in0) v0 = fs::rnd<TO>(v0) * s;
          if (in1) v1 = fs::rnd<TO>(v1) * s;
          v0 = apply_act<ACT>(v0), v1 = apply_act<ACT>(v1);
          if (ACC) {
            const float2 c = fs::load2(C + (size_t)m * ldc + n);
            v0 += c.x, v1 += c.y;
          }
          fs::store2(C + (size_t)m * ldc + n, v0, v1);
        }
      }
    }
  }
}

// C[m][n] = act((bias[n] + sum_{z < S} P[z][m][n]) * sc(n)) rounded to TO
// (added to C[m][n] when ACC); the partials are added in the order of z
template <int ACT, typename TO, bool ACC = false>
__global__ void splitk_reduce_bf16_kernel(const float* __restrict__ P, int S,
                                          const bf16* __restrict__ bias, TO* __restrict__ C,
                                          int ldc, int M, int N, int s_lo, int s_hi, float s) {
  const long long total = (long long)M * N;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(e / N), n = (int)(e % N);
    float v = bias ? fs::f32(bias[n]) : 0.f;
    for (int z = 0; z < S; ++z) v += P[(size_t)z * total + e];
    if (n >= s_lo && n < s_hi) v = fs::rnd<TO>(v) * s;
    v = apply_act<ACT>(v);
    if (ACC) v += fs::f32(C[(size_t)m * ldc + n]);
    C[(size_t)m * ldc + n] = fs::As<TO>::from(v);
  }
}

// The bf16 launch_linear: bf16 A, W and bias, C in TO (float or bf16;
// C += with ACC; PRECISE as above).  `part` (kSplitFloats floats, or null)
// is the scratch of a split along k, taken as the float32 form takes it.
// Returns the first CUDA error of the launches.
template <int ACT = kNone, bool ACC = false, bool PRECISE = false, typename TO>
inline int launch_linear(const bf16* A, int lda, const bf16* W, int ldw, const bf16* bias, TO* C,
                         int ldc, int M, int N, int K, cudaStream_t stream, int s_lo = 0,
                         int s_hi = 0, float s = 1.f, float* part = nullptr) {
  const int smem = linear_bf16_smem_bytes();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int tiles = (int)(grid.x * grid.y), ktiles = (K + BK - 1) / BK;
  int split = 1;
  if (part && tiles < kSMs) {  // at least 4 k tiles (128 deep) per split
    split = min(min(kMaxSplit, ktiles / 4), kSplitBlocks / tiles);
    if (split < 1) split = 1;
  }
  if (split == 1) {
    cudaError_t err = cudaFuncSetAttribute(linear_bf16_kernel<ACT, false, TO, ACC, PRECISE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    linear_bf16_kernel<ACT, false, TO, ACC, PRECISE><<<grid, 256, smem, stream>>>(
        A, lda, W, ldw, bias, C, nullptr, ldc, M, N, K, s_lo, s_hi, s, ktiles);
    return cudaGetLastError();
  }
  const int per = (ktiles + split - 1) / split;
  split = (ktiles + per - 1) / per;
  cudaError_t err = cudaFuncSetAttribute(linear_bf16_kernel<kNone, true, TO, false, PRECISE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  linear_bf16_kernel<kNone, true, TO, false, PRECISE>
      <<<dim3(grid.x, grid.y, split), 256, smem, stream>>>(
      A, lda, W, ldw, nullptr, nullptr, part, N, M, N, K, 0, 0, 1.f, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < kSMs * 8 ? (total + 255) / 256 : kSMs * 8);
  splitk_reduce_bf16_kernel<ACT, TO, ACC><<<blocks, 256, 0, stream>>>(part, split, bias, C, ldc,
                                                                      M, N, s_lo, s_hi, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad_bf16_kernel: G[n][k] = sum_m A[m][n] X[m][k] in float32, the weight
// gradient of a linear layer over many rows from bf16 operands (the TPU
// kernel's `wgrad`: the gradient rounded to bf16, the input in bf16, float32
// accumulation, dec_train_fusion_pallas.py:387-390): A (M, N) the rounded
// output gradient (row stride lda), X (M, K) the input (row stride ldx), G
// (N, K) in torch's (out, in) layout.  As tc_f32.cuh's wgrad_kernel: the
// rows cut into gridDim.z slices, each block writing its slice's raw sums of
// one 128 x 128 tile of G to P + z * N * K (G itself for one slice), the
// slices added in the order of z by splitk_reduce_kernel, so the same bits
// from run to run.  N, K % 8 == 0, lda, ldx % 8 == 0, 16-byte aligned bases.
//
// Both operands are staged as row-major 32 x 128 tiles (rows of the slice by
// columns of A or X), three stages of cp.async copies in flight; the A
// fragment is the transpose of its tile (ldmatrix .trans), the B fragment
// the tile as it is (load_b16x2).  Always in the precise form (each 32-row
// tile's sums added to the running sum on the FMA pipe): its sums run over
// thousands of rows.
// ---------------------------------------------------------------------------

constexpr int LDGB = BN + 8;  // bf16 row stride of both tiles
constexpr int kGradStageB16 = 2 * BK * LDGB;
constexpr int wgrad_bf16_smem_bytes() { return (int)sizeof(bf16) * kStages * kGradStageB16; }

// The A fragment of the 16 (n) x 16 (m) tile whose transpose is stored
// row-major at p (rows m, columns n, row stride ld elements)
__device__ __forceinline__ void load_a16_t(uint32_t (&a)[4], const bf16* p, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, p + ((l & 7) + ((l >> 4) << 3)) * ld + ((l >> 3) & 1) * 8);
}

__global__ void __launch_bounds__(256)
wgrad_bf16_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ X, int ldx,
                  float* __restrict__ P, int M, int N, int K, int per) {
  extern __shared__ __align__(16) bf16 gbsm[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.y * BM, k0 = blockIdx.x * BN;
  const int r0 = blockIdx.z * per, r1 = min(M, r0 + per);
  const int ntiles = (r1 - r0 + BK - 1) / BK;
  P += (size_t)blockIdx.z * N * K;

  auto load_stage = [&](int stage, int kt) {
    bf16* As = gbsm + stage * kGradStageB16;
    bf16* Xs = As + BK * LDGB;
    const int m0 = r0 + kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // each: 32 rows x 16 chunks of 8
      const int idx = tid + i * 256, r = idx >> 4, c8 = (idx & 15) * 8;
      const bool in = m0 + r < r1;
      const bool oka = in && n0 + c8 < N, okx = in && k0 + c8 < K;
      cp_async16(As + r * LDGB + c8, oka ? A + (size_t)(m0 + r) * lda + n0 + c8 : A, oka);
      cp_async16(Xs + r * LDGB + c8, okx ? X + (size_t)(m0 + r) * ldx + k0 + c8 : X, okx);
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
    const bf16* As = gbsm + (kt % kStages) * kGradStageB16 + wm * 64;
    const bf16* Xs = gbsm + (kt % kStages) * kGradStageB16 + BK * LDGB + wn * 32;
    float part[4][4][4];  // this tile's sums
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a16_t(fa[i], As + ks * 16 * LDGB + i * 16, LDGB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        load_b16x2(fb[2 * j], fb[2 * j + 1], Xs + ks * 16 * LDGB + j * 16, LDGB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], fa[i], fb[j]);
    }
    add_tile(acc, part);
  }

  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + wn * 32 + j * 8 + 2 * t;
    if (k >= K) continue;  // K % 8 == 0: k and k + 1 are in or out together
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

// The bf16 launch_wgrad: the slices of tc_f32.cuh's (about two blocks per SM,
// at least 512 rows a slice), `part` (kSplitFloats floats) holding their
// partials.  Returns the first CUDA error of the launches.
inline int launch_wgrad(const bf16* A, int lda, const bf16* X, int ldx, float* G, int M, int N,
                        int K, cudaStream_t stream, float* part) {
  const int smem = wgrad_bf16_smem_bytes();
  const int tiles = ((N + BM - 1) / BM) * ((K + BN - 1) / BN);
  int slices = kSplitBlocks / tiles;
  if (slices > (M + 511) / 512) slices = (M + 511) / 512;
  if (slices < 1) slices = 1;
  const int per = ((M + slices - 1) / slices + BK - 1) / BK * BK;
  slices = (M + per - 1) / per;
  cudaError_t err =
      cudaFuncSetAttribute(wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + BN - 1) / BN, (N + BM - 1) / BM, slices);
  wgrad_bf16_kernel<<<grid, 256, smem, stream>>>(A, lda, X, ldx, slices == 1 ? G : part, M, N, K,
                                                 per);
  if ((err = cudaGetLastError()) != cudaSuccess || slices == 1) return err;
  const long long total = (long long)N * K;
  const int blocks = (int)((total + 255) / 256 < kSMs * 8 ? (total + 255) / 256 : kSMs * 8);
  splitk_reduce_kernel<kNone><<<blocks, 256, 0, stream>>>(part, slices, nullptr, G, K, N, K, 0, 0,
                                                          1.f);
  return cudaGetLastError();
}

}  // namespace tc
