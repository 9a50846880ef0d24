// The bf16 form of the decoder frame scan's layer at the production width
// D = 256 (dec_frame_scan.cu built with FS_BF16, over a block of many rows).
// Run as dec_frame_scan.cu's sequence of kernels (tc_bf16.cuh's products,
// float32 products written out for a row kernel's residual add and
// LayerNorm, the recurrence on the FMA pipe, the group norm and gate in a
// pass of their own), a 128-lane x 128-frame block takes 10.8 ms on an
// H100, 5.5 of it in the products at a fifth of the bf16 peak.  Here, from
// scan16.cuh's tools (shared with the encoder scan's bf16 layer):
//   wg16_kernel     the products whose inner dimension is D on wgmma, with
//                   kRound (q | k | v | g, the slot attention's q | k | v)
//                   or kLn (the out projections: add_drop_ln fused away);
//   ffn16_kernel    the relu FFN pair and its LayerNorm (kLn);
//   ret_tc_kernel   the recurrence on the tensor cores with the group norm
//                   and gate in its epilogue;
// and, here:
//   slot_attn16_kernel  the slot attention of one (lane, frame, head) per
//                   warp on bf16 pairs (a rounded product is one bf16x2
//                   multiply), its rows read four bytes a lane into shared
//                   rows of DK / 2 + 1 words (no bank conflicts); with its
//                   dropout, the fusion layer's training forward's too
//                   (dtf_tc16.cuh).
// The rounding points are the sequence's (dec_frame_scan.cu's list), at
// the same places of the same arithmetic; only float32 summation orders
// differ.  What bounds the layer: the products' operations
// (1.1 TFLOP a 128-lane x 128-frame block, 1.1 ms of the bf16 tensor
// cores); the slot attention runs on the FMA pipe.
#pragma once

#include "scan16.cuh"

namespace d16 {


// ---------------------------------------------------------------------------
// slot_attn16_kernel: dec_train_fusion_common.cuh's slot_attn_fwd_kernel<bf16>
// on bf16 pairs, one warp per (lane or batch row, frame, head), the same
// bits: each product q k rounded to bf16 before the float32 sum, the
// softmax weights rounded, times their dropout multipliers rounded (site
// kAttnW + 16 h; the fusion layer's training forward, dtf_tc16.cuh: at
// dropout 0, the frame scan's, the multiplier is 1 and round(round(w) * 1)
// = round(w)), rounded, each product w v rounded, the sum rounded where it
// is written (dec_frame_scan_pallas.py:149-157,
// dec_train_fusion_pallas.py:255-266).  A product of two bf16 values
// rounded to bf16 is one bf16x2 multiply (mul.rn: one rounding of the
// exact product) for two of them.  q, k and v of the C slots stay bf16
// pairs in shared rows of DK / 2 + 1 words, read a pair a lane (a row of
// DK = 64 is one 128-byte read of the warp), so the (query, key) pairs of
// a warp, which read different key rows at one column, hit different
// banks.  Rows ((b C + c) T + t) of qkv (stride 3D) and attn (stride D).
// ---------------------------------------------------------------------------

constexpr int kSlotWarps = 4;     // warps a block
constexpr int kSW = DK / 2 + 1;   // 32-bit words a shared row

__host__ __device__ constexpr int slot16_smem_words(int C) {
  return kSlotWarps * (3 * C * kSW + C * C);
}

__global__ void __launch_bounds__(32 * kSlotWarps)
slot_attn16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ attn, int B, Drop dp) {
  extern __shared__ __align__(16) uint32_t wsm32[];
  const int C = dp.C, T = dp.T;
  const int gw = blockIdx.x * kSlotWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (gw >= B * T * H) return;
  const int h = gw % H, t = (gw / H) % T, b = gw / (H * T);
  uint32_t* qs = wsm32 + (threadIdx.x >> 5) * (3 * C * kSW + C * C);
  uint32_t *ks = qs + C * kSW, *vs = ks + C * kSW;
  float* W = reinterpret_cast<float*>(vs + C * kSW);
  for (int c = 0; c < C; ++c) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(qkv + (((size_t)b * C + c) * T + t) * 3 * D + h * DK);
    for (int i = lane; i < DK / 2; i += 32) {
      qs[c * kSW + i] = row[i];
      ks[c * kSW + i] = row[D / 2 + i];
      vs[c * kSW + i] = row[D + i];
    }
  }
  __syncwarp();
  const float inv = (float)(1.0 / sqrt((double)DK));
  auto pair = [](uint32_t u) { return *reinterpret_cast<const __nv_bfloat162*>(&u); };
  for (int p = lane; p < C * C; p += 32) {
    const int c = p / C, j = p % C;
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < DK / 2; ++i) {
      const float2 f = __bfloat1622float2(__hmul2(pair(qs[c * kSW + i]), pair(ks[j * kSW + i])));
      s += f.x;
      s += f.y;
    }
    W[p] = s * inv;
  }
  __syncwarp();
  if (lane < C) {  // softmax of row c = lane; the weights rounded, times their mask, rounded
    const unsigned base = hash_base(dp, b, t / dp.L, kAttnW + 16 * h);
    float m = W[lane * C];
    for (int j = 1; j < C; ++j) m = fmaxf(m, W[lane * C + j]);
    float sum = 0.f;
    for (int j = 0; j < C; ++j) {
      const float e = expf(W[lane * C + j] - m);
      W[lane * C + j] = e;
      sum += e;
    }
    for (int j = 0; j < C; ++j) {
      const float w = fs::rnd<bf16>(W[lane * C + j] / sum);
      W[lane * C + j] =
          dp.thr ? fs::rnd<bf16>(
                       w * fs::rnd<bf16>(keep(dp, base, (unsigned)((lane * dp.L + t % dp.L) * C + j))))
                 : w;
    }
  }
  __syncwarp();
  for (int c = 0; c < C; ++c) {
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>(attn + (((size_t)b * C + c) * T + t) * D + h * DK);
    for (int i = lane; i < DK / 2; i += 32) {
      float o0 = 0.f, o1 = 0.f;
      for (int j = 0; j < C; ++j) {
        const float2 f = __bfloat1622float2(
            __hmul2(__float2bfloat162_rn(W[c * C + j]), pair(vs[j * kSW + i])));
        o0 += f.x;
        o1 += f.y;
      }
      out[i] = __floats2bfloat162_rn(o0, o1);
    }
  }
}

// B batch rows (or lanes) of dp.T frames and dp.C slots; dropout off: dp.thr 0
inline int slot_attn16(const bf16* qkv, bf16* attn, int B, const Drop& dp, cudaStream_t st) {
  const int smem = (int)sizeof(uint32_t) * slot16_smem_words(dp.C);
  cudaError_t e = cudaFuncSetAttribute(slot_attn16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int grid = (B * dp.T * H + kSlotWarps - 1) / kSlotWarps;
  slot_attn16_kernel<<<grid, 32 * kSlotWarps, smem, st>>>(qkv, attn, B, dp);
  return cudaGetLastError();
}

}  // namespace d16
