// The bf16 frame scans' tools at the production width D = 256, shared by
// the decoder scan's layer (dec_scan16.cuh, included by dec_frame_scan.cu
// built with FS_BF16) and the encoder scan's (enc_frame_scan.cu built with
// FS_BF16), each over a block of many rows and, for the encoder, any rows:
//   wg16_kernel     (wg16.cuh) the products whose inner dimension is D on
//                   wgmma, with the epilogue of its place in the layer:
//                   bias (and the k columns' scale) rounded to bf16
//                   (kRound); bias, the residual add and the LayerNorm,
//                   rounded (kLn, the decoder's post-LN: the float32 product
//                   never stored); the residual add rounded and written,
//                   and its LayerNorm (kAddLn, the encoder's pre-LN, once or
//                   twice); the GLU of interleaved columns (kGlu); written
//                   out through shared memory in 16-byte chunks;
//   ffn16_kernel    the FFN pair and its epilogue (kLn, relu: the decoder;
//                   kAddLn, silu: the encoder's half FF), the hidden layer
//                   kept in shared memory 64 units at a time;
//   kPart           (wg16, ffn16) few rows (a step()'s): the k tiles or the
//                   hidden slices split over many blocks, each writing its
//                   float32 partial sum (a row kernel adds them in order);
//   transpose16     (wg16.cuh) the weights transposed once (both wgmma
//                   operands K-major; pw1's a and b columns interleaved for
//                   kGlu);
//   ret_tc_kernel   the exact gamma = 1 recurrence of frame_ret.cuh on the
//                   tensor cores (the float32 operands as three bf16 terms),
//                   with the group norm and the silu gate in its epilogue,
//                   writing the gated value in bf16.
// The rounding points are the plain versions', at the same places of the
// same arithmetic; only float32 summation orders differ.
#pragma once

#include "frame_ret.cuh"
#include "tc_bf16.cuh"
#include "wg16.cuh"

namespace d16 {

using namespace dtf;
using fs::bf16;

// ---------------------------------------------------------------------------
// ffn16_kernel: the layer's feed-forward pair and its epilogue in one kernel,
// for D = 256 (ffn16 refuses other widths): y = epi(round(act(x W1 + b1)) W2)
// with act relu (the decoder: kLn, y = round(LN(x + (out + b2))) or silu
// (the encoder's half FF: kAddLn with s = its factor and res = the residual
// stream, x being its LayerNorm), 128 rows a block (two warpgroups of 64).
// The block's x rows stay in shared memory; the hidden layer is taken kFS =
// 64 units at a time: each warpgroup computes its 64 x 64 slice on the
// tensor cores (16 m64n64k16 steps against W1's slice), adds b1, applies the
// activation, rounds to bf16 and writes it to its own swizzled tile, then
// adds that slice times W2's slice to its 64 x 256 output (four 16-deep
// steps of two m64n128k16).  W1^T's and W2^T's slices (32 KB each) are
// double-buffered in shared memory, the next slice's copies in flight while
// one is multiplied.  So the hidden layer never reaches device memory (0.67
// GB each way a decoder layer at 128 lanes x 128 frames).  The hidden values
// are rounded where the plain version rounds them, and the second product
// sums over the slices in order.  With kPart, block (i, z) takes the z-th
// of gridDim.y equal runs of slices and writes its float32 sum over them
// (without b2) to ep.part + z M D: a step()'s 128 rows are one block of the
// full kernel, whose weights (1 MB a half FF) one SM reads slowly; a row
// kernel then adds the runs in the order of z.
// ---------------------------------------------------------------------------

constexpr int kFS = 64;
constexpr int kFX = kWBM * D;             // x rows: D / 64 swizzled 128 x 64 tiles
constexpr int kFW = 2 * kFS * D;          // a stage: W1^T's slice (4 tiles of 64 x 64), W2^T's (256 x 64)
constexpr int kFH = 64 * kFS;             // a warpgroup's hidden slice
constexpr int kFBytes = (int)sizeof(bf16) * (kFX + 2 * kFW + 2 * kFH) + 1024;

template <bool SILU, int EPI>
__global__ void __launch_bounds__(256, 1)
ffn16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t, const bf16* __restrict__ b1,
             const bf16* __restrict__ w2t, Epi16 ep, bf16* __restrict__ y, int M, int F) {
  extern __shared__ __align__(16) bf16 fsm_raw[];
  bf16* xs = align1k(fsm_raw);
  bf16* ws = xs + kFX;              // 2 stages
  bf16* hs = ws + 2 * kFW;          // 2 warpgroups
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int m0 = blockIdx.x * kWBM;
  const int per = F / kFS / gridDim.y, c0 = blockIdx.y * per, c1 = c0 + per;  // the block's slices

  auto load_slice = [&](int c) {
    bf16* w1s = ws + ((c - c0) & 1) * kFW;
    bf16* w2s = w1s + kFS * D;
#pragma unroll
    for (int idx = tid; idx < kFS * (D / 8); idx += 256) {  // W1^T rows c*64 .., all D
      const int r = idx / (D / 8), ch = idx % (D / 8);
      tc::cp_async16(w1s + (ch >> 3) * (kFS * 64) + sw_off(r, ch & 7),
                     w1t + (size_t)(c * kFS + r) * D + 8 * ch, true);
    }
#pragma unroll
    for (int idx = tid; idx < D * 8; idx += 256) {          // W2^T rows n, columns c*64 ..
      const int r = idx >> 3, ch = idx & 7;
      tc::cp_async16(w2s + sw_off(r, ch), w2t + (size_t)r * F + c * kFS + 8 * ch, true);
    }
  };
#pragma unroll
  for (int idx = tid; idx < kWBM * (D / 8); idx += 256) {   // the block's x rows
    const int r = idx / (D / 8), ch = idx % (D / 8);
    const bool ok = m0 + r < M;
    tc::cp_async16(xs + (ch >> 3) * (kWBM * 64) + sw_off(r, ch & 7),
                   ok ? x + (size_t)(m0 + r) * D + 8 * ch : x, ok);
  }
  load_slice(c0);
  tc::cp_async_commit();

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    fence_acc(acc[h]);
  }
  bf16* hw = hs + wgi * kFH;
  for (int c = c0; c < c1; ++c) {
    tc::cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // slice c (and x) landed; both warpgroups are done with slice c - 1
    if (c + 1 < c1) load_slice(c + 1);
    tc::cp_async_commit();
    const bf16* w1s = ws + ((c - c0) & 1) * kFW;
    const bf16* w2s = w1s + kFS * D;
    // the hidden slice: 64 rows x 64 units, over D in 16-deep steps
    float hacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
    fence_acc(hacc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      const int kt = s >> 2, ko = (s & 3) * 16;
      wgmma64(hacc, wg_desc(xs + kt * (kWBM * 64) + wgi * 64 * 64 + ko),
              wg_desc(w1s + kt * (kFS * 64) + ko));
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(hacc);
    // act(h + b1) rounded to bf16, into the warpgroup's swizzled tile
#pragma unroll
    for (int j = 0; j < kFS / 8; ++j) {
      const int u = 8 * j + 2 * t;
      const float e0 = fs::ldg(b1 + c * kFS + u), e1 = fs::ldg(b1 + c * kFS + u + 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + g + 8 * hh;
        const float h0 = hacc[4 * j + 2 * hh] + e0, h1 = hacc[4 * j + 2 * hh + 1] + e1;
        const __nv_bfloat162 v = SILU ? __floats2bfloat162_rn(silu_rn(h0), silu_rn(h1))
                                      : __floats2bfloat162_rn(fmaxf(h0, 0.f), fmaxf(h1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(hw + r * 64 + ((j ^ (r & 7)) << 3) + 2 * t) = v;
      }
    }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");  // the warpgroup's tile is written
    // out += hidden slice . W2's slice
    wg_fence();
#pragma unroll
    for (int s = 0; s < kFS / 16; ++s) {
      const uint64_t da = wg_desc(hw + 16 * s);
#pragma unroll
      for (int h = 0; h < 2; ++h) wgmma128(acc[h], da, wg_desc(w2s + h * 128 * 64 + 16 * s));
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) fence_acc(acc[h]);
  }
  tc::cp_async_wait<0>();

  if constexpr (EPI == kPart)  // the run's float32 sum
    part_out<2>(acc, ep.part + (size_t)blockIdx.y * M * D, M, D, m0, 0);
  else  // y = epi(x + (out + b2)), through the weight stages
    staged_epilogue<EPI, 2>(acc, ep, y, M, D, m0, 0, ws);
}

template <bool SILU, int EPI>
inline int ffn16_launch(const bf16* x, const bf16* w1t, const bf16* b1, const bf16* w2t,
                        const Epi16& ep, bf16* y, int M, int F, int splits, cudaStream_t st) {
  if (D != 256 || F % (kFS * splits)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffn16_kernel<SILU, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kFBytes);
  if (err != cudaSuccess) return err;
  ffn16_kernel<SILU, EPI><<<dim3((M + kWBM - 1) / kWBM, splits), 256, kFBytes, st>>>(
      x, w1t, b1, w2t, ep, y, M, F);
  return cudaGetLastError();
}

// y = LN(x + round(relu(x W1 + b1)) W2 + b2) from W1^T (F, D), W2^T (D, F)
inline int ffn16(const bf16* x, const bf16* w1t, const bf16* b1, const bf16* w2t, const bf16* b2,
                 const bf16* lns, const bf16* lnb, bf16* y, int M, int F, cudaStream_t st) {
  const Epi16 ep{b2, 0, 0, 1.f, x, lns, lnb};
  return ffn16_launch<false, kLn>(x, w1t, b1, w2t, ep, y, M, F, 1, st);
}

// the encoder's half FF: v = round(res + s (round(silu(t W1 + b1)) W2 + b2)),
// then kAddLn's norms (ep: b2, s, res, lns, lnb, out2, lns2, lnb2, dbl); or,
// with `splits` > 1, kPart's partial sums into ep.part (splits, M, D)
inline int ffn16_enc(const bf16* t, const bf16* w1t, const bf16* b1, const bf16* w2t,
                     const Epi16& ep, bf16* y, int M, int F, int splits, cudaStream_t st) {
  return splits > 1 ? ffn16_launch<true, kPart>(t, w1t, b1, w2t, ep, y, M, F, splits, st)
                    : ffn16_launch<true, kAddLn>(t, w1t, b1, w2t, ep, y, M, F, 1, st);
}

// C = round((A W + bias) sc), A (M, D), W^T given (N, D), N % 128 == 0
inline int linear16(const bf16* A, const bf16* Wt, const bf16* bias, bf16* C, int M, int N,
                    cudaStream_t st, int s_lo = 0, int s_hi = 0, float s = 1.f) {
  return wg16<kRound>(A, Wt, C, M, N, D, Epi16{bias, s_lo, s_hi, s, nullptr, nullptr, nullptr},
                      st);
}

// y = round(LN(res + (A W + bias))), A (M, D), W^T given (D, D)
inline int linear16_ln(const bf16* A, const bf16* Wt, const bf16* bias, const bf16* res,
                       const bf16* lns, const bf16* lnb, bf16* y, int M, cudaStream_t st) {
  return wg16<kLn>(A, Wt, y, M, D, D, Epi16{bias, 0, 0, 1.f, res, lns, lnb}, st);
}

// x = round(x + (A W + bias)) in place and t = round(LN(x)), A (M, D), W^T
// given (D, D): the encoder's out projections and pw2
inline int linear16_addln(const bf16* A, const bf16* Wt, const bf16* bias, bf16* x,
                          const bf16* lns, const bf16* lnb, bf16* t, int M, cudaStream_t st) {
  Epi16 ep{bias, 0, 0, 1.f, x, lns, lnb};
  ep.out2 = t;
  return wg16<kAddLn>(A, Wt, x, M, D, D, ep, st);
}

// the float32 sums of A W over `splits` equal runs of the k tiles to part
// (splits, M, N): the encoder's out projections and pw2 over few rows,
// whose 256-wide row tiles are too few blocks (a step()'s 128 rows, one)
inline int linear16_part(const bf16* A, const bf16* Wt, float* part, int M, int N, int splits,
                         cudaStream_t st) {
  Epi16 ep{};
  ep.part = part;
  ep.splits = splits;
  return wg16<kPart>(A, Wt, nullptr, M, N, D, ep, st);
}

// C (M, N / 2) = round(a sigmoid(b)), (a | b) = A W + bias, A (M, D), W^T
// given (N, D) in transpose16<true>'s order: the conv module's pw1 and GLU
inline int linear16_glu(const bf16* A, const bf16* Wt, const bf16* bias, bf16* C, int M, int N,
                        cudaStream_t st) {
  return wg16<kGlu>(A, Wt, C, M, N, D, Epi16{bias}, st);
}

// ---------------------------------------------------------------------------
// ret_tc_kernel: the exact gamma = 1 recurrence of frame_ret.cuh's
// ret_block_kernel (its chunks of kT frames, its gates and counts, the state
// carried in float32 within the call and stored in bf16) on the tensor
// cores, with gate_fwd's group norm (eps 1e-6, non-affine) and silu gate in
// its epilogue: gated = silu(g) * round(norm), rounded where it is written.
// One block of 4 warps per (lane, slot, head); warp w takes the chunk's
// frames 16w .. 16w + 15 and, for w < DK / 16, the state's rows 16w ..
// 16w + 15.  Per chunk, with the q, k~ and v rows in bf16 tiles:
//   S = q k~^T                      one bf16 pass (exact products)
//   S *= (j < i: g_j, j == i: 1, j > i: 0)
//   out = (q KV^T + S v) ns          KV and S in float32, each taken as
//                                    three bf16 terms hi + mid + lo (to
//                                    float32's 2^-24): three bf16 passes a
//                                    product, small terms first
//   KV += (g v)^T k~                 one pass (g is 0 or 1: g v is v's
//                                    fragment with the gated frames'
//                                    halves cleared), into the float32
//                                    accumulator that holds KV for the
//                                    whole slice
// where the FMA form's four 64 x 64 x 64 float32 products took 2.3 ms of a
// 128-lane block on the FMA pipe.  Tiles past a warp's last frame are
// skipped (S is causal).  The group norm of frame i sums the DK columns its
// four lanes hold (shuffles).
// ---------------------------------------------------------------------------

constexpr int kRT = frs::kT;       // frames a chunk: 4 warps x 16
constexpr int kRLd = DK + 8;       // bf16 row stride of the tiles (ldmatrix phases hit 32 banks)
constexpr int kDN = DK / 8;        // 8-column accumulator tiles across a head
static_assert(kRT == 64 && DK % 16 == 0 && DK <= 64, "4 warps x 16 frames; DK a multiple of 16");

constexpr int ret_tc_smem_bytes() {
  return (int)sizeof(bf16) * (3 * kRT + 3 * DK) * kRLd + (int)sizeof(float) * kRT;
}

// rows r = bc * Kc + k of qkvg (stride 4D: q | k~ | v | g) and gated (stride
// D); the state's layout, gates and counts as ret_block_kernel's.  MINB
// blocks an SM: 3 (170 registers a thread at most) for the decoder's many
// sequences, 4 (one wave of 512) for the encoder's 128 lanes x 4 heads
template <int MINB>
__global__ void __launch_bounds__(128, MINB)
ret_tc_kernel(const bf16* __restrict__ qkvg, const float* __restrict__ valid,
              bf16* __restrict__ gated, bf16* __restrict__ kv, bf16* __restrict__ s,
              const float* __restrict__ s0, int C, int Kc, int Kt, int k0) {
  extern __shared__ __align__(16) bf16 rsm[];
  bf16* Qs = rsm;                  // (kRT, kRLd)
  bf16* Ks = Qs + kRT * kRLd;      // k~
  bf16* Vs = Ks + kRT * kRLd;
  bf16* KVh = Vs + kRT * kRLd;     // (DK, kRLd) the state [v][k], hi
  bf16* KVm = KVh + DK * kRLd;     // mid
  bf16* KVl = KVm + DK * kRLd;     // lo
  float* gs = reinterpret_cast<float*>(KVl + DK * kRLd);  // (kRT) the chunk's gates

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int seq = blockIdx.x, bc = seq / H, h = seq % H, b = bc / C;
  const bool owns_state = warp < DK / 16;  // the state's rows 16 warp .. 16 warp + 15
  float srun = s0[bc];
  float kva[kDN][4];  // KV[v][k], v = 16 warp + g (+ 8), k = 8n + 2t (+ 1)
  auto put_state = [&]() {  // KVh, KVm, KVl from kva
#pragma unroll
    for (int n = 0; n < kDN; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int v = 16 * warp + g + 4 * e, k = 8 * n + 2 * t;
        uint32_t hi, mid, lo;
        split3(kva[n][e], kva[n][e + 1], hi, mid, lo);
        *reinterpret_cast<uint32_t*>(KVh + v * kRLd + k) = hi;
        *reinterpret_cast<uint32_t*>(KVm + v * kRLd + k) = mid;
        *reinterpret_cast<uint32_t*>(KVl + v * kRLd + k) = lo;
      }
  };
  bf16* kvs = kv + (size_t)seq * DK * DK;
  if (owns_state) {
    const float sc = sqrtf(srun);
#pragma unroll
    for (int n = 0; n < kDN; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int v = 16 * warp + g + 4 * e, k = 8 * n + 2 * t;
        const float2 x = fs::load2(kvs + v * DK + k);
        kva[n][e] = x.x * sc, kva[n][e + 1] = x.y * sc;
      }
    put_state();
  }
  const int r0 = 16 * warp;  // the warp's first frame of a chunk
  for (int n0 = 0; n0 < Kc; n0 += kRT) {
    const int nr = min(kRT, Kc - n0);
    __syncthreads();  // the previous chunk is done with the tiles; KVh, KVm, KVl are written
    const bf16* rows = qkvg + ((size_t)bc * Kc + n0) * 4 * D + h * DK;
    const float* vrow = valid + (size_t)b * Kt + k0 + n0;
    for (int idx = tid; idx < kRT * (DK / 8); idx += 128) {
      const int i = idx / (DK / 8), c = (idx % (DK / 8)) * 8;
      const bool in = i < nr;
      const bf16* p = rows + (size_t)(in ? i : 0) * 4 * D + c;
      tc::cp_async16(Qs + i * kRLd + c, p, in);
      tc::cp_async16(Ks + i * kRLd + c, p + D, in);
      tc::cp_async16(Vs + i * kRLd + c, p + 2 * D, in);
    }
    tc::cp_async_commit();
    if (tid < kRT) gs[tid] = tid < nr ? vrow[tid] : 0.f;
    tc::cp_async_wait<0>();
    __syncthreads();
    // the counts frames 16 warp + g and + 8 divide by, summed in frame order
    const int i0 = r0 + g, i1 = i0 + 8;
    float run = srun, ns0 = 0.f, gsum = 0.f;
    for (int j = 0; j < nr; ++j) {
      if (j == i0) ns0 = rsqrtf(run + 1.f);
      if (j == i1) break;
      run += gs[j];
    }
    const float ns1 = rsqrtf(run + 1.f);
    for (int j = 0; j < nr; ++j) gsum += gs[j];
    if (r0 < nr) {
      // S = q k~^T over the causal tiles, masked by the gates
      const int nS = 2 * warp + 2;  // 8-frame tiles at or before the warp's last frame
      float sa[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t fa[4];
        tc::load_a16(fa, Qs + r0 * kRLd + kk * 16, kRLd);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          if (n >= nS) break;
          uint32_t b0[2], b1[2];
          load_bt16x2(b0, b1, Ks + n * 8 * kRLd + kk * 16, kRLd);
          tc::mma_bf16(sa[n], fa, b0);
          tc::mma_bf16(sa[n + 1], fa, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1, j = 8 * n + 2 * t + (e & 1);
          sa[n][e] *= j < i ? gs[j] : (j == i ? 1.f : 0.f);
        }
      // out = q KV^T (KV as hi + mid + lo) + S v (S as hi + mid + lo)
      float o[kDN][4];
#pragma unroll
      for (int n = 0; n < kDN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t fa[4];
        tc::load_a16(fa, Qs + r0 * kRLd + kk * 16, kRLd);
#pragma unroll
        for (int n = 0; n < kDN; n += 2) {
          uint32_t b0[2], b1[2];
          load_bt16x2(b0, b1, KVl + n * 8 * kRLd + kk * 16, kRLd);
          tc::mma_bf16(o[n], fa, b0);
          tc::mma_bf16(o[n + 1], fa, b1);
          load_bt16x2(b0, b1, KVm + n * 8 * kRLd + kk * 16, kRLd);
          tc::mma_bf16(o[n], fa, b0);
          tc::mma_bf16(o[n + 1], fa, b1);
          load_bt16x2(b0, b1, KVh + n * 8 * kRLd + kk * 16, kRLd);
          tc::mma_bf16(o[n], fa, b0);
          tc::mma_bf16(o[n + 1], fa, b1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp) break;  // frames past the warp's last
        uint32_t ah[4], am[4], al[4];
        split3(sa[2 * kk][0], sa[2 * kk][1], ah[0], am[0], al[0]);
        split3(sa[2 * kk][2], sa[2 * kk][3], ah[1], am[1], al[1]);
        split3(sa[2 * kk + 1][0], sa[2 * kk + 1][1], ah[2], am[2], al[2]);
        split3(sa[2 * kk + 1][2], sa[2 * kk + 1][3], ah[3], am[3], al[3]);
#pragma unroll
        for (int n = 0; n < kDN; n += 2) {
          uint32_t b0[2], b1[2];
          tc::load_b16x2(b0, b1, Vs + kk * 16 * kRLd + n * 8, kRLd);
          tc::mma_bf16(o[n], al, b0);
          tc::mma_bf16(o[n + 1], al, b1);
          tc::mma_bf16(o[n], am, b0);
          tc::mma_bf16(o[n + 1], am, b1);
          tc::mma_bf16(o[n], ah, b0);
          tc::mma_bf16(o[n + 1], ah, b1);
        }
      }
      // ns, then the group norm of each frame over its head's DK columns and the gate
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        o[n][0] *= ns0, o[n][1] *= ns0, o[n][2] *= ns1, o[n][3] *= ns1;
        sum0 += o[n][0] + o[n][1];
        sum1 += o[n][2] + o[n][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      const float mu0 = sum0 / DK, mu1 = sum1 / DK;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        d0 += (o[n][0] - mu0) * (o[n][0] - mu0) + (o[n][1] - mu0) * (o[n][1] - mu0);
        d1 += (o[n][2] - mu1) * (o[n][2] - mu1) + (o[n][3] - mu1) * (o[n][3] - mu1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, off);
        d1 += __shfl_xor_sync(0xffffffffu, d1, off);
      }
      const float rs0 = rsqrtf(d0 / DK + 1e-6f), rs1 = rsqrtf(d1 / DK + 1e-6f);
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        const int v = 8 * n + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = hh ? i1 : i0;
          if (i >= nr) continue;
          const float mu = hh ? mu1 : mu0, rs = hh ? rs1 : rs0;
          const size_t r = (size_t)bc * Kc + n0 + i;
          const float2 gv = fs::load2(qkvg + r * 4 * D + 3 * D + h * DK + v);
          fs::store2(gated + r * D + h * DK + v,
                     fs::silu(gv.x) * fs::rnd<bf16>((o[n][2 * hh] - mu) * rs),
                     fs::silu(gv.y) * fs::rnd<bf16>((o[n][2 * hh + 1] - mu) * rs));
        }
      }
    }
    // the carry: KV[v][k] += sum_j (g v)[j][v] k~[j][k] over the chunk
    if (owns_state) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= nr) break;
        uint32_t fa[4];  // (g v)^T: v^T's fragment, frames 16 kk + 2t (+ 1) and + 8 (+ 9)
        tc::load_a16_t(fa, Vs + kk * 16 * kRLd + r0, kRLd);
        const int f = 16 * kk + 2 * t;
        const uint32_t m0 = (gs[f] != 0.f ? 0xFFFFu : 0u) | (gs[f + 1] != 0.f ? 0xFFFF0000u : 0u);
        const uint32_t m1 =
            (gs[f + 8] != 0.f ? 0xFFFFu : 0u) | (gs[f + 9] != 0.f ? 0xFFFF0000u : 0u);
        fa[0] &= m0, fa[1] &= m0, fa[2] &= m1, fa[3] &= m1;
#pragma unroll
        for (int n = 0; n < kDN; n += 2) {
          uint32_t b0[2], b1[2];
          tc::load_b16x2(b0, b1, Ks + kk * 16 * kRLd + n * 8, kRLd);
          tc::mma_bf16(kva[n], fa, b0);
          tc::mma_bf16(kva[n + 1], fa, b1);
        }
      }
    }
    __syncthreads();  // every warp is done reading KVh, KVm and KVl
    if (owns_state) put_state();
    srun += gsum;
  }
  if (owns_state) {
    const float norm = rsqrtf(fmaxf(srun, 1.f));
#pragma unroll
    for (int n = 0; n < kDN; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int v = 16 * warp + g + 4 * e, k = 8 * n + 2 * t;
        fs::store2(kvs + v * DK + k, kva[n][e] * norm, kva[n][e + 1] * norm);
      }
  }
  if (tid == 0) s[seq] = __float2bfloat16_rn(srun);
}

}  // namespace d16
