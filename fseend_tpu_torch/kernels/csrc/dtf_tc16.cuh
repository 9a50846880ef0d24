// The fusion layer's bf16 training forms at the production width (D 256,
// head dim 64, F a multiple of 128): dec_train_fusion_fwd.cu and
// dec_train_fusion_bwd.cu built with FS_BF16 run this file's sequences
// there, and dec_train_fusion_seq.cuh's forward_seq16 (the mma.sync
// products, the one-block-per-row FMA core) at every other width.
//
// The rounding points are dec_train_fusion_pallas.py's (_chunk_fwd :150-297,
// _bwd_kernel :337-535), at the same places of the same arithmetic; only
// float32 summation orders differ.  Every sum keeps a fixed order (no
// atomics): two calls give the same bits.
//
//   mm16_kernel     every product of the layer on wgmma (m64n128k16, both
//                   operands K-major in 128-byte-swizzled shared tiles, the
//                   mainloop of scan16.cuh's wg16_kernel), with the epilogue
//                   of its place: q | k | v rounded (k scaled, rounded again)
//                   and g in float32 (kRnd); dropout on the product plus
//                   bias, the residual (bf16 x or the float32 stream), the
//                   pre-norm sum and the LayerNorm, float32 and a bf16 copy
//                   (kResLn, 256-wide tiles); relu and the FF-hidden dropout
//                   rounded, with relu' kept as one bit an element (kRelu,
//                   the backward's recompute); a float32 product (kF32); an
//                   input gradient added into the float32 residual stream,
//                   or, for the last one, rounded into dx (kAdd);
//   ffn16t_kernel   an FFN pair with its hidden slices on chip: the forward
//                   call's FF1 and FF2 (kResLn's epilogue); the backward's
//                   FF2 and FF1 input gradients, the slice through the mask
//                   and relu' (the bits), rounded, written for dW1 and
//                   summed for the bias gradient (kAdd's epilogue);
//   wgrad16_kernel  a weight gradient G = A^T X over row slices on wgmma,
//                   both operands read MN-major (the rows are the sum's k):
//                   each slice's float32 tile to a partial, the slices added
//                   in order and rounded by splitk_reduce_bf16_kernel;
//   core_state16    the retention state: per (sequence, head) each chunk's
//                   summary k~^T v / sqrt(L) on bf16 mma.sync, added to the
//                   carried state in chunk order (the kernel's adds in its
//                   order), its checkpoint and scale written before each
//                   chunk;
//   core_out16      one block per (sequence, head, chunk, 64 queries): the
//                   chunk's masked scores on the tensor cores, the row sums,
//                   S / inner rounded before it multiplies v, the cross read
//                   q (KV / c) with KV / c as three bf16 terms, the group norm
//                   and the silu gate in the epilogue;
//   core_bwd_ds16   the state cotangent: per (sequence, head) each chunk's
//                   q_id^T dcross / c, added in reverse chunk order (dS_n
//                   written before chunk n's is added);
//   core_bwd_chunk16 one block per (sequence, head, chunk, 64-row tile and
//                   role): dk and dv of a key tile, or dq of a query tile,
//                   with dS_n read, on bf16 tiles in shared memory (ldmatrix);
//   slot_attn_bwd16 the attention across the C slots backward on bf16
//                   pairs (forward: dec_scan16.cuh's slot_attn16, B1's);
//   ln_bwd16        the LayerNorm backward writing the residual stream's
//                   gradient, the branch gradient rounded, and per-block
//                   column sums of the scale, bias and branch gradients.
#pragma once

#include "dec_train_fusion_common.cuh"
#include "dec_scan16.cuh"

namespace t16 {

using namespace dtf;
using fs::bf16;
using d16::align1k;
using d16::kSlotWarps;
using d16::kSW;
using d16::fence_acc;
using d16::fence_async_smem;
using d16::sw_off;
using d16::wg_commit;
using d16::wg_desc;
using d16::wg_fence;
using d16::wg_wait;
using d16::wgmma128;
using d16::write_tile;

static_assert(D == 256 && DK == 64, "the production width: D 256, head dim 64");

constexpr int kBM = d16::kWBM, kBK = d16::kWBK;  // 128 rows a block, 64-deep k tiles

// a product's dropout multiplier (dropout off: 1, no hash)
__device__ __forceinline__ float keep_or_1(const Drop& dp, unsigned base, unsigned idx) {
  return dp.thr ? keep(dp, base, idx) : 1.f;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mm16_kernel: epi(A W) over M rows, A (M, K) bf16 of row stride K, W given
// as Wt (N, K) (torch's (out, in) layout for a forward product, the (in,
// out) transpose for an input gradient), K % 64 == 0, N % (128 NH) == 0.
// ---------------------------------------------------------------------------

enum Epi { kRnd = 0, kResLn = 1, kRelu = 2, kF32 = 3, kAdd = 4 };

struct Ep {
  const bf16* bias;        // (N) or null
  int s_lo, s_hi;          // kRnd: columns [s_lo, s_hi) rounded, times s, rounded
  float s;
  int gcol;                // kRnd: columns from gcol on go unrounded to g32 (row stride D)
  float* g32;
  bf16* out16;             // kRnd, kRelu, kResLn, kAdd: the bf16 output
  int ld16;
  float* out32;            // kF32, kResLn: float32 output; kAdd: the float32 sum added to
                           // (row stride D)
  const float* res32;      // kResLn: the residual, float32 or bf16 (row stride D)
  const bf16* res16;
  float* rsum;             // kResLn: the pre-norm sum, or null
  const bf16 *lns, *lnb;   // kResLn
  int site;                // kResLn: the dropout site
  uint32_t* bits;          // kRelu (written when not null), ffn16t's backward: relu'
  float* colpart;          // ffn16t's backward: column sums of each warp's rows
  Drop dp;
};

template <int NH>
struct Geo {
  static constexpr int BN = 128 * NH, St = NH == 2 ? 4 : 3;
  static constexpr int StageA = kBM * kBK, StageB = BN * kBK;
  static constexpr int Bytes = (int)sizeof(bf16) * St * (StageA + StageB) + 1024;
};

// the thread's rows in a 128-row tile: warpgroup wgi's 64, the warp's 16,
// g and g + 8
__device__ __forceinline__ int tile_row() {
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + tc::lane_g();
}

template <int EPI, int NH>
__device__ __forceinline__ void epilogue(float (&acc)[NH][64], const Ep& ep, int M, int N,
                                         int m0, int n0, bf16* so) {
  constexpr int BN = 128 * NH, LDO = BN + 8;
  const int tid = threadIdx.x, t = tc::lane_t(), rb = tile_row();
  const int rows = min(kBM, M - m0);
  const Drop& dp = ep.dp;
  __syncthreads();  // both warpgroups are done with the stages
  if constexpr (EPI == kRnd) {
    if (n0 >= ep.gcol) {  // g: float32, unrounded
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + rb + 8 * hh;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + 2 * t, n = n0 + c;
          fs::store2(ep.g32 + (size_t)m * D + n - ep.gcol,
                     acc[0][4 * j + 2 * hh] + fs::ldg(ep.bias + n),
                     acc[0][4 * j + 2 * hh + 1] + fs::ldg(ep.bias + n + 1));
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t, n = n0 + c;
      const float b0 = fs::ldg(ep.bias + n), b1 = fs::ldg(ep.bias + n + 1);
      const bool in = n >= ep.s_lo && n < ep.s_hi;  // n and n + 1 lie in one 128-column tile
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v0 = acc[0][4 * j + 2 * hh] + b0, v1 = acc[0][4 * j + 2 * hh + 1] + b1;
        if (in) v0 = fs::rnd<bf16>(v0) * ep.s, v1 = fs::rnd<bf16>(v1) * ep.s;
        fs::store2(so + (rb + 8 * hh) * LDO + c, v0, v1);
      }
    }
  } else if constexpr (EPI == kRelu) {
    // the mask word of the thread's row hh in this tile: bit 2j + e for column 8j + 2t + e
    const size_t word = ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 256 + tid) * 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + rb + 8 * hh;
      const RowPos p = row_pos(dp, m < M ? m : 0);
      const unsigned base = hash_base(dp, p.b, p.n, kFfh);
      uint32_t bits = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t, n = n0 + c;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[0][4 * j + 2 * hh + e] + fs::ldg(ep.bias + n + e);
          if (x > 0.f) bits |= 1u << (2 * j + e);
          v[e] = fmaxf(x, 0.f) * keep_or_1(dp, base, (unsigned)(p.cl * N + n + e));
        }
        fs::store2(so + (rb + 8 * hh) * LDO + c, v[0], v[1]);
      }
      if (ep.bits) ep.bits[word + hh] = bits;
    }
  } else if constexpr (EPI == kResLn) {
    static_assert(NH == 2, "a row's 256 columns in one tile");
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + rb + 8 * hh, mr = m < M ? m : 0;
      const RowPos p = row_pos(dp, mr);
      const unsigned base = hash_base(dp, p.b, p.n, ep.site);
      float s = 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 128 * h + 8 * j + 2 * t;
          const float2 r = ep.res32 ? fs::load2(ep.res32 + (size_t)mr * D + c)
                                    : fs::load2(ep.res16 + (size_t)mr * D + c);
          float& v0 = acc[h][4 * j + 2 * hh];
          float& v1 = acc[h][4 * j + 2 * hh + 1];
          v0 = r.x + (v0 + fs::ldg(ep.bias + c)) * keep_or_1(dp, base, (unsigned)(p.cl * D + c));
          v1 = r.y +
               (v1 + fs::ldg(ep.bias + c + 1)) * keep_or_1(dp, base, (unsigned)(p.cl * D + c + 1));
          if (ep.rsum && m < M) fs::store2(ep.rsum + (size_t)m * D + c, v0, v1);
          s += v0 + v1;
        }
      if (!ep.out16 && !ep.out32) continue;
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float mu = s / D;
      float d2 = 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float a = acc[h][4 * j + 2 * hh] - mu, b = acc[h][4 * j + 2 * hh + 1] - mu;
          d2 += a * a + b * b;
        }
      d2 += __shfl_xor_sync(0xffffffffu, d2, 1);
      d2 += __shfl_xor_sync(0xffffffffu, d2, 2);
      const float rs = rsqrtf(d2 / D + 1e-5f);
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 128 * h + 8 * j + 2 * t;
          float& v0 = acc[h][4 * j + 2 * hh];
          float& v1 = acc[h][4 * j + 2 * hh + 1];
          v0 = (v0 - mu) * rs * fs::ldg(ep.lns + c) + fs::ldg(ep.lnb + c);
          v1 = (v1 - mu) * rs * fs::ldg(ep.lns + c + 1) + fs::ldg(ep.lnb + c + 1);
          if (ep.out32 && m < M) fs::store2(ep.out32 + (size_t)m * D + c, v0, v1);
          fs::store2(so + (rb + 8 * hh) * LDO + c, v0, v1);
        }
    }
    if (!ep.out16) return;
  } else {  // kF32, kAdd: straight from the accumulators
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + rb + 8 * hh;
      if (m >= M) continue;
#pragma unroll
      for (int jj = 0; jj < 16 * NH; ++jj) {
        const int h = jj >> 4, j = jj & 15, n = n0 + 128 * h + 8 * j + 2 * t;
        float v0 = acc[h][4 * j + 2 * hh], v1 = acc[h][4 * j + 2 * hh + 1];
        if constexpr (EPI == kAdd) {
          const float2 o = fs::load2(ep.out32 + (size_t)m * D + n);
          v0 += o.x, v1 += o.y;
          if (ep.out16) {
            fs::store2(ep.out16 + (size_t)m * ep.ld16 + n, v0, v1);
            continue;
          }
        }
        fs::store2(ep.out32 + (size_t)m * D + n, v0, v1);
      }
    }
    return;
  }
  __syncthreads();
  write_tile(so, LDO, ep.out16, ep.ld16, m0, n0, rows, BN);
}

template <int EPI, int NH>
__global__ void __launch_bounds__(256, 3 - NH)
mm16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt, int M, int N, int K, Ep ep) {
  using G = Geo<NH>;
  extern __shared__ __align__(16) bf16 msm_raw[];
  bf16* wsm = align1k(msm_raw);
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * G::BN;
  const int ntiles = K / kBK;

  auto load = [&](int stage, int kt) {
    bf16* As = wsm + stage * (G::StageA + G::StageB);
    bf16* Bs = As + G::StageA;
    const int k0 = kt * kBK;
#pragma unroll
    for (int idx = tid; idx < kBM * 8; idx += 256) {  // 16-byte chunks: (row, chunk)
      const int r = idx >> 3, c = idx & 7;
      const bool ok = m0 + r < M;
      tc::cp_async16(As + sw_off(r, c), ok ? A + (size_t)(m0 + r) * K + k0 + 8 * c : A, ok);
    }
#pragma unroll
    for (int idx = tid; idx < G::BN * 8; idx += 256) {
      const int r = idx >> 3, c = idx & 7;
      tc::cp_async16(Bs + sw_off(r, c), Wt + (size_t)(n0 + r) * K + k0 + 8 * c, true);
    }
  };

  float acc[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    fence_acc(acc[h]);
  }
#pragma unroll
  for (int st = 0; st < G::St - 2; ++st) {
    if (st < ntiles) load(st, st);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    tc::cp_async_wait<G::St - 3>();
    fence_async_smem();
    __syncthreads();  // tile kt has landed; tile kt - 2's products are done
    const int nxt = kt + G::St - 2;
    if (nxt < ntiles) load(nxt % G::St, nxt);
    tc::cp_async_commit();
    const bf16* As = wsm + (kt % G::St) * (G::StageA + G::StageB) + wgi * 64 * kBK;
    const bf16* Bs = wsm + (kt % G::St) * (G::StageA + G::StageB) + G::StageA;
    wg_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      const uint64_t da = wg_desc(As + 16 * s);
#pragma unroll
      for (int h = 0; h < NH; ++h) wgmma128(acc[h], da, wg_desc(Bs + h * 128 * kBK + 16 * s));
    }
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
  tc::cp_async_wait<0>();
  epilogue<EPI, NH>(acc, ep, M, N, m0, n0, wsm);
}

// kResLn on 256-wide tiles (a row's LayerNorm in the epilogue), the others
// on 128-wide ones, two blocks an SM (one block's epilogue beside the
// other's products: with 256-wide tiles the input gradients took 7 % longer)
template <int EPI>
inline int mm16(const bf16* A, const bf16* Wt, int M, int N, int K, const Ep& ep,
                cudaStream_t st) {
  constexpr int NH = EPI == kResLn ? 2 : 1;
  using G = Geo<NH>;
  constexpr bool kRowsD = EPI == kResLn || EPI == kF32 || EPI == kAdd;  // outputs of D columns
  if (N % G::BN || K % kBK || (kRowsD && N != D)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mm16_kernel<EPI, NH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::Bytes);
  if (err != cudaSuccess) return err;
  mm16_kernel<EPI, NH><<<dim3(N / G::BN, (M + kBM - 1) / kBM), 256, G::Bytes, st>>>(A, Wt, M, N,
                                                                                     K, ep);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ffn16t_kernel: an FFN pair in one kernel, scan16.cuh's ffn16_kernel with
// the fusion layer's arithmetic, 128 rows a block, 64 hidden units at a
// time, the hidden slice on chip between its two products.
//   forward (BWD false; the forward call): the slice x2 W1^T + b1, relu'd,
//     times its dropout multiplier (site kFfh), rounded, into FF2; then
//     kResLn's epilogue (dropout kFfo on FF2 + b2, the float32 residual x2,
//     LN3, y in bf16).  (The backward's recompute needs the hidden layer for
//     dW2: there FF1 runs alone, kRelu, writing it and relu' as bits.)
//   backward (BWD true): FF2's input gradient g2 W2 slice by slice, times
//     the mask and relu' (the bits kRelu wrote, which this thread holds: a
//     slice pair is one of kRelu's 128-wide tiles), rounded: written to
//     `hid` (the bf16 gFlo dW1 reads), its column sums over the warp's 16
//     rows to colpart (row 8 (block) + warp), and on into FF1's input
//     gradient, added into the float32 dxf (kAdd's epilogue).
// ---------------------------------------------------------------------------

template <bool BWD>
__global__ void __launch_bounds__(256, 1)
ffn16t_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2t, Ep ep,
              bf16* __restrict__ hid, int M, int F) {
  using namespace d16;
  extern __shared__ __align__(16) bf16 fsm_raw[];
  bf16* xs = align1k(fsm_raw);
  bf16* ws = xs + kFX;              // 2 stages
  bf16* hs = ws + 2 * kFW;          // 2 warpgroups
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int m0 = blockIdx.x * kWBM;
  const int c1 = F / kFS;
  const Drop& dp = ep.dp;
  unsigned base[2];
  int cl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the thread's rows' dropout keys
    const int m = m0 + wgi * 64 + warp * 16 + g + 8 * hh;
    const RowPos p = row_pos(dp, m < M ? m : 0);
    base[hh] = hash_base(dp, p.b, p.n, kFfh);
    cl[hh] = p.cl;
  }

  auto load_slice = [&](int c) {
    bf16* w1s = ws + (c & 1) * kFW;
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
  load_slice(0);
  tc::cp_async_commit();

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    fence_acc(acc[h]);
  }
  bf16* hw = hs + wgi * kFH;
  uint32_t bits[2] = {0u, 0u};
  for (int c = 0; c < c1; ++c) {
    tc::cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // slice c (and x) landed; both warpgroups are done with slice c - 1
    if (c + 1 < c1) load_slice(c + 1);
    tc::cp_async_commit();
    if (BWD && !(c & 1))  // the mask words of kRelu's tile (c / 2) for the thread's rows
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        bits[hh] = ep.bits[((size_t)(blockIdx.x * (F / 128) + c / 2) * 256 + tid) * 2 + hh];
    const bf16* w1s = ws + (c & 1) * kFW;
    const bf16* w2s = w1s + kFS * D;
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
    // forward: relu(h + b1) times its dropout multiplier; backward: the
    // gradient times the multiplier and relu'; rounded into the tile
    float cs[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) cs[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kFS / 8; ++j) {
      const int u = 8 * j + 2 * t, f = c * kFS + u;
      const float e0 = BWD ? 0.f : fs::ldg(b1 + f), e1 = BWD ? 0.f : fs::ldg(b1 + f + 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + g + 8 * hh;
        const unsigned idx = (unsigned)(cl[hh] * F + f);
        float h0 = hacc[4 * j + 2 * hh] + e0, h1 = hacc[4 * j + 2 * hh + 1] + e1;
        if constexpr (BWD) {
          const int bit = (c & 1) * 16 + 2 * j;
          h0 = (bits[hh] >> bit & 1u) ? h0 * keep_or_1(dp, base[hh], idx) : 0.f;
          h1 = (bits[hh] >> (bit + 1) & 1u) ? h1 * keep_or_1(dp, base[hh], idx + 1) : 0.f;
          if (m0 + wgi * 64 + r < M) cs[2 * j] += h0, cs[2 * j + 1] += h1;
        } else {
          h0 = fmaxf(h0, 0.f) * keep_or_1(dp, base[hh], idx);
          h1 = fmaxf(h1, 0.f) * keep_or_1(dp, base[hh], idx + 1);
        }
        *reinterpret_cast<__nv_bfloat162*>(hw + r * 64 + ((j ^ (r & 7)) << 3) + 2 * t) =
            __floats2bfloat162_rn(h0, h1);
      }
    }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");  // the warpgroup's tile is written
    if constexpr (BWD) {
      // the rounded slice out to gFlo in 16-byte chunks, its column sums over the warp's rows
      for (int i = tid & 127; i < 64 * 8; i += 128) {
        const int r = i >> 3, ch = i & 7, m = m0 + wgi * 64 + r;
        if (m < M)
          *reinterpret_cast<uint4*>(hid + (size_t)m * F + c * kFS + 8 * ch) =
              *reinterpret_cast<const uint4*>(hw + r * 64 + ((ch ^ (r & 7)) << 3));
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float v = cs[i];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        cs[i] = v;
      }
      if (g == 0) {
        float* row = ep.colpart + ((size_t)blockIdx.x * 8 + (tid >> 5)) * F + c * kFS;
#pragma unroll
        for (int j = 0; j < kFS / 8; ++j) fs::store2(row + 8 * j + 2 * t, cs[2 * j], cs[2 * j + 1]);
      }
    }
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
  epilogue<BWD ? kAdd : kResLn, 2>(acc, ep, M, D, m0, 0, ws);
}

template <bool BWD>
inline int ffn16t(const bf16* x, const bf16* w1t, const bf16* b1, const bf16* w2t, const Ep& ep,
                  bf16* hid, int M, int F, cudaStream_t st) {
  if (F % 128) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffn16t_kernel<BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, d16::kFBytes);
  if (err != cudaSuccess) return err;
  ffn16t_kernel<BWD><<<(M + kBM - 1) / kBM, 256, d16::kFBytes, st>>>(x, w1t, b1, w2t, ep, hid, M,
                                                                      F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad16_kernel: P_z (N1, N2) = sum over the rows m of slice z of A[m][n1]
// X[m][n2], A (M, N1) the rounded output gradient, X (M, N2) the bf16
// input, both N % 128 == 0.  A block of two warpgroups takes a 128 x 128
// tile of G, each warpgroup 64 of its rows, over the slice's rows in 64-row
// k tiles.  A k tile of A or X is copied as it lies in memory, row by row,
// into two 64-column halves in the 128-byte swizzle (row r's chunk c at c ^
// (r % 8)): that is the MN-major canonical layout wgmma reads with its
// transpose bits set, 8 k rows of 128 bytes an 8-row group (the stride byte
// offset, 1024), the halves 8 KB apart (the leading byte offset).
// ---------------------------------------------------------------------------

constexpr int kGSt = 4;                      // stages
constexpr int kGHalf = 64 * kBK;             // a 64-column half of a k tile, bf16 elements
constexpr int kGStage = 4 * kGHalf;          // A's two halves, X's two
constexpr int kGBytes = (int)sizeof(bf16) * kGSt * kGStage + 1024;

// the descriptor of an MN-major tile at p: 128-byte swizzle, 8-row groups
// 1024 bytes apart, 64-element MN blocks 8 KB apart
__device__ __forceinline__ uint64_t wg_desc_mn(const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((2 * kGHalf) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d += a b for a 64 x 128 x 16 step, both operands MN-major (transposed)
__device__ __forceinline__ void wgmma128_mn(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(256, 1)
wgrad16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ X, float* __restrict__ P,
               int M, int N1, int N2, int per) {
  extern __shared__ __align__(16) bf16 gsm_raw[];
  bf16* gsm = align1k(gsm_raw);
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int n1 = blockIdx.y * 128, n2 = blockIdx.x * 128;
  const int r0 = blockIdx.z * per, r1 = min(M, r0 + per);
  const int ntiles = (r1 - r0 + kBK - 1) / kBK;
  P += (size_t)blockIdx.z * N1 * N2;

  auto load = [&](int stage, int kt) {
    bf16* S = gsm + stage * kGStage;
    const int m0 = r0 + kt * kBK;
#pragma unroll
    for (int idx = tid; idx < kBK * 16; idx += 256) {  // a row's 16 chunks of 8
      const int r = idx >> 4, ch = idx & 15, half = ch >> 3, c = ch & 7;
      const bool ok = m0 + r < r1;
      const size_t row = ok ? (size_t)(m0 + r) : 0;
      tc::cp_async16(S + half * kGHalf + sw_off(r, c), A + row * N1 + n1 + 8 * ch, ok);
      tc::cp_async16(S + (2 + half) * kGHalf + sw_off(r, c), X + row * N2 + n2 + 8 * ch, ok);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
#pragma unroll
  for (int st = 0; st < kGSt - 2; ++st) {
    if (st < ntiles) load(st, st);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    tc::cp_async_wait<kGSt - 3>();
    fence_async_smem();
    __syncthreads();
    const int nxt = kt + kGSt - 2;
    if (nxt < ntiles) load(nxt % kGSt, nxt);
    tc::cp_async_commit();
    const bf16* S = gsm + (kt % kGSt) * kGStage;
    wg_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)  // 16 k rows: 16 * 128 bytes into the tiles
      wgmma128_mn(acc, wg_desc_mn(S + wgi * kGHalf + s * 16 * 64),
                  wg_desc_mn(S + 2 * kGHalf + s * 16 * 64));
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  fence_acc(acc);
  const int t = tc::lane_t(), rb = tile_row();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      fs::store2(P + (size_t)(n1 + rb + 8 * hh) * N2 + n2 + 8 * j + 2 * t, acc[4 * j + 2 * hh],
                 acc[4 * j + 2 * hh + 1]);
}

// G (N1, N2) bf16 = the rounded float32 sum over M rows of A^T X: row
// slices of multiples of 64 rows, as many as fill about two blocks an SM
// (tc::kSplitBlocks, at least 512 rows a slice), added in slice order
inline int wgrad16(const bf16* A, const bf16* X, bf16* G, int M, int N1, int N2, float* part,
                   cudaStream_t st) {
  if (N1 % 128 || N2 % 128) return cudaErrorInvalidValue;
  const int tiles = (N1 / 128) * (N2 / 128);
  int slices = tc::kSplitBlocks / tiles;
  if (slices > (M + 511) / 512) slices = (M + 511) / 512;
  if (slices < 1) slices = 1;
  const int per = ((M + slices - 1) / slices + kBK - 1) / kBK * kBK;
  slices = (M + per - 1) / per;
  cudaError_t err = cudaFuncSetAttribute(wgrad16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGBytes);
  if (err != cudaSuccess) return err;
  wgrad16_kernel<<<dim3(N2 / 128, N1 / 128, slices), 256, kGBytes, st>>>(A, X, part, M, N1, N2,
                                                                        per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)N1 * N2;
  const int blocks = (int)lmin((total + 255) / 256, tc::kSMs * 8);
  tc::splitk_reduce_bf16_kernel<tc::kNone, bf16><<<blocks, 256, 0, st>>>(
      part, slices, nullptr, G, N2, N1, N2, 0, 0, 1.f);
  return cudaGetLastError();
}

// g (N) bf16 = the rounded column sums of A (M, N) float32 (row stride lda):
// tc::launch_colsum's slices of rows (one thread a column in each), their
// sums added in slice order, then rounded
inline int colsum16(const float* A, int lda, bf16* g, int M, int N, float* part,
                    cudaStream_t st) {
  int per = 256;
  const long long most = (long long)tc::kSplitFloats / N;
  if ((M + per - 1) / per > most) per = (int)((M + most - 1) / most);
  const int slices = (M + per - 1) / per;
  tc::colsum_part_kernel<<<dim3((N + 255) / 256, slices), 256, 0, st>>>(A, lda, part, M, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tc::splitk_reduce_bf16_kernel<tc::kNone, bf16><<<(N + 255) / 256, 256, 0, st>>>(
      part, slices, nullptr, g, N, 1, N, 0, 0, 1.f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The retention core on bf16 mma.sync (m16n8k16), head dim 64.  Rows of
// the q | k | v matrix (stride 3D, k already scaled and rounded) of
// sequence bc = b C + c: bc T + t; frame t in chunk n = t / L at l = t % L.
// Shared tiles of 64 rows x 64 columns, rows padded to kLd (the ldmatrix
// rows of a phase on distinct banks); chunk rows at or past L are zeros.
// A warp owns 16 rows of a 64-row output, 8 accumulator tiles of 8 columns.
// ---------------------------------------------------------------------------

constexpr int kT = 64;
constexpr int kLd = DK + 8;
constexpr int kTileE = kT * kLd;  // bf16 elements of a tile

// rows [r0, r0 + 64) of a chunk (L rows from `src`, row stride ld) into a
// tile by cp.async, rows at or past L zero
__device__ __forceinline__ void load_chunk_tile(bf16* dst, const bf16* src, int ld, int r0, int L) {
  for (int idx = threadIdx.x; idx < kT * (DK / 8); idx += blockDim.x) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    const bool ok = r0 + r < L;
    tc::cp_async16(dst + r * kLd + c, ok ? src + (size_t)(r0 + r) * ld + c : src, ok);
  }
}

// the A fragment (rows 16 kk .. of the reduction) from a warp's two
// accumulator tiles 2 kk and 2 kk + 1, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[8][4], int kk) {
  a[0] = pack2(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack2(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

__device__ __forceinline__ void zero8(float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
}

// acc += (16 rows of A at a, row-major, stride kLd) (64 x 64 B):
// BT false: B row-major (k, n) at b; BT true: B^T row-major (n, k) at b
template <bool BT>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    uint32_t fa[4];
    tc::load_a16(fa, a + kk * 16, kLd);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b0[2], b1[2];
      if constexpr (BT)
        d16::load_bt16x2(b0, b1, b + n * 8 * kLd + kk * 16, kLd);
      else
        tc::load_b16x2(b0, b1, b + kk * 16 * kLd + n * 8, kLd);
      tc::mma_bf16(acc[n], fa, b0);
      tc::mma_bf16(acc[n + 1], fa, b1);
    }
  }
}

// acc += X (16 x 64, in accumulator tiles, rounded to bf16) B (64 x 64,
// row-major (k, n) at b)
__device__ __forceinline__ void mma_acc(float (&acc)[8][4], const float (&x)[8][4], const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[4];
    acc_to_a(fa, x, kk);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b0[2], b1[2];
      tc::load_b16x2(b0, b1, b + kk * 16 * kLd + n * 8, kLd);
      tc::mma_bf16(acc[n], fa, b0);
      tc::mma_bf16(acc[n + 1], fa, b1);
    }
  }
}

// acc += A^T B over the 64 rows of two tiles: A^T's 16 rows are columns
// 16 w .. of the row-major tile a, B row-major (k, n) at b
__device__ __forceinline__ void mma_tn(float (&acc)[8][4], const bf16* a, const bf16* b, int w) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    uint32_t fa[4];
    tc::load_a16_t(fa, a + kk * 16 * kLd + 16 * w, kLd);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b0[2], b1[2];
      tc::load_b16x2(b0, b1, b + kk * 16 * kLd + n * 8, kLd);
      tc::mma_bf16(acc[n], fa, b0);
      tc::mma_bf16(acc[n + 1], fa, b1);
    }
  }
}

// f(row m < 16, column n < 64, value) for each accumulator element of a warp
template <class F>
__device__ __forceinline__ void each8(const float (&x)[8][4], F f) {
  const int g = tc::lane_g(), t = tc::lane_t();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) f(g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1), x[n][e]);
}

// the slot of chunk n of sequence bc, head h in kvs (B, N, H, C, DK, DK)
__device__ __forceinline__ size_t ck_slot(int bc, int n, int h, int C, int N) {
  return (((size_t)(bc / C) * N + n) * H + h) * C + bc % C;
}

struct CoreArgs16 {
  const bf16* qkv;      // (R, 3D): q | k~ | v
  const float* g;       // (R, D): the gate's pre-activation
  float *kvs, *ss;      // the state each chunk reads, its scale
  bf16* gated;          // (R, D)
  float* oh;            // (R, D) the core's output before the norm, or null
  float* inr;           // (R, H) the row sums max(sum |S|, 1), or null
  int C, T, L;
};

// per (sequence, head): the chunks' summaries added in chunk order
__global__ void __launch_bounds__(128) core_state16_kernel(CoreArgs16 a) {
  __shared__ __align__(16) bf16 Ks[kTileE], Vs[kTileE];
  __shared__ float colw[4][DK];
  __shared__ float sc;
  const int tid = threadIdx.x, w = tid >> 5, g = tc::lane_g(), t = tc::lane_t();
  const int bc = blockIdx.x / H, h = blockIdx.x % H, L = a.L, N = a.T / L;
  const float wlast = (float)(1.0 / sqrt((double)L));
  float kv[8][4];  // KV[k][v], k = 16 w + g (+ 8), v = 8 n + 2 t (+ 1)
  zero8(kv);
  float s = 1.f;
  for (int n = 0; n < N; ++n) {
    const size_t slot = ck_slot(bc, n, h, a.C, N);
    float* ck = a.kvs + slot * DK * DK;
    each8(kv, [&](int m, int c, float x) { ck[(16 * w + m) * DK + c] = x; });
    if (tid == 0) a.ss[slot] = s;
    const bf16* rows = a.qkv + ((size_t)bc * a.T + (size_t)n * L) * 3 * D + h * DK;
    float kc[8][4];
    zero8(kc);
    for (int j0 = 0; j0 < L; j0 += kT) {
      __syncthreads();
      load_chunk_tile(Ks, rows + D, 3 * D, j0, L);
      load_chunk_tile(Vs, rows + 2 * D, 3 * D, j0, L);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      mma_tn(kc, Ks, Vs, w);
    }
    // KV += (k~^T v) / sqrt(L); then c = max(max_v sum_k |KV[k][v]|, 1)
    float cs[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[j][e] += kc[j][e] * wlast;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = fabsf(kv[j][e]) + fabsf(kv[j][e + 2]);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        cs[j][e] = v;
      }
    if (g == 0)
#pragma unroll
      for (int j = 0; j < 8; ++j) colw[w][8 * j + 2 * t] = cs[j][0], colw[w][8 * j + 2 * t + 1] = cs[j][1];
    __syncthreads();
    if (w == 0) {
      float m = 1.f;
      for (int v = tid; v < DK; v += 32)
        m = fmaxf(m, colw[0][v] + colw[1][v] + colw[2][v] + colw[3][v]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (tid == 0) sc = m;
    }
    __syncthreads();
    s = sc;
  }
}

// split x0, x1 into three bf16 pairs at dst + i (three tiles kTileE apart)
__device__ __forceinline__ void put3(bf16* dst, int i, float x0, float x1) {
  uint32_t hi, mid, lo;
  d16::split3(x0, x1, hi, mid, lo);
  *reinterpret_cast<uint32_t*>(dst + i) = hi;
  *reinterpret_cast<uint32_t*>(dst + kTileE + i) = mid;
  *reinterpret_cast<uint32_t*>(dst + 2 * kTileE + i) = lo;
}

constexpr int kOutBytes = (int)sizeof(bf16) * 6 * kTileE;

// one block per (sequence, head) x chunk x 64-query tile
__global__ void __launch_bounds__(128, 4) core_out16_kernel(CoreArgs16 a) {
  extern __shared__ __align__(16) bf16 csm[];
  bf16* Qs = csm;
  bf16* Ks = Qs + kTileE;
  bf16* Vs = Ks + kTileE;
  bf16* KVs = Vs + kTileE;  // KV / c [k][v]: hi, mid, lo
  const int tid = threadIdx.x, w = tid >> 5, g = tc::lane_g(), t = tc::lane_t();
  const int bc = blockIdx.x / H, h = blockIdx.x % H, n = blockIdx.y, I = blockIdx.z;
  const int L = a.L, N = a.T / L;
  const size_t row0 = (size_t)bc * a.T + (size_t)n * L;
  const bf16* rows = a.qkv + row0 * 3 * D + h * DK;
  const size_t slot = ck_slot(bc, n, h, a.C, N);
  const float c = a.ss[slot];
  load_chunk_tile(Qs, rows, 3 * D, I * kT, L);
  tc::cp_async_commit();
  const float* ck = a.kvs + slot * DK * DK;
  for (int i = tid; i < DK * DK / 2; i += 128) {
    const int k = (2 * i) / DK, v = (2 * i) % DK;
    const float2 x = fs::load2(ck + 2 * i);
    put3(KVs, k * kLd + v, x.x / c, x.y / c);
  }
  // the thread's two rows (chunk places), their 1 / sqrt(i + 1) and sqrt(L) / sqrt(i + 1)
  int ir[2];
  float rsq[2], idec[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ir[hh] = I * kT + 16 * w + g + 8 * hh;
    rsq[hh] = 1.f / sqrtf(ir[hh] + 1.f);
    idec[hh] = sqrtf((float)L) / sqrtf(ir[hh] + 1.f);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  const bf16* qw = Qs + 16 * w * kLd;
  float cr[8][4];  // the cross read q (KV / c), three bf16 terms, small first
  zero8(cr);
  mma_rows<false>(cr, qw, KVs + 2 * kTileE);
  mma_rows<false>(cr, qw, KVs + kTileE);
  mma_rows<false>(cr, qw, KVs);
  // S tile (I, J) masked: (q k~^T)(i, j) / sqrt(i + 1) for j <= i < L, else 0
  auto scores = [&](float (&sa)[8][4], int J) {
    zero8(sa);
    mma_rows<true>(sa, qw, Ks);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, jj = J * kT + 8 * j + 2 * t + (e & 1);
        sa[j][e] = jj <= ir[hh] && ir[hh] < L ? sa[j][e] * rsq[hh] : 0.f;
      }
  };
  float rowabs[2] = {0.f, 0.f};
  for (int J = 0; J <= I; ++J) {  // the row sums of |S|
    __syncthreads();
    load_chunk_tile(Ks, rows + D, 3 * D, J * kT, L);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    float sa[8][4];
    scores(sa, J);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      rowabs[0] += fabsf(sa[j][0]) + fabsf(sa[j][1]), rowabs[1] += fabsf(sa[j][2]) + fabsf(sa[j][3]);
  }
  float inner[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float s = rowabs[hh];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    inner[hh] = fmaxf(s, 1.f);
  }
  float o[8][4];  // (S / inner) rounded, times v
  zero8(o);
  for (int J = 0; J <= I; ++J) {
    __syncthreads();
    load_chunk_tile(Ks, rows + D, 3 * D, J * kT, L);
    load_chunk_tile(Vs, rows + 2 * D, 3 * D, J * kT, L);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    float sa[8][4];
    scores(sa, J);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = fs::rnd<bf16>(sa[j][e] / inner[e >> 1]);
    mma_acc(o, sa, Vs);
  }
  // out = inner-out (inner / all) + cross (c / all); the group norm; the gate
  float mu[2], rs[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float all = fmaxf(inner[hh], c), fi = inner[hh] / all, fc = c / all;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = o[j][2 * hh + e];
        x = x * fi + cr[j][2 * hh + e] * idec[hh] * fc;
        s += x;
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    mu[hh] = s / DK;
    float d2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) d2 += (o[j][2 * hh + e] - mu[hh]) * (o[j][2 * hh + e] - mu[hh]);
    d2 += __shfl_xor_sync(0xffffffffu, d2, 1);
    d2 += __shfl_xor_sync(0xffffffffu, d2, 2);
    rs[hh] = rsqrtf(d2 / DK + 1e-6f);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (ir[hh] >= L) continue;
    const size_t r = row0 + ir[hh];
    if (a.inr && t == 0) a.inr[r * H + h] = inner[hh];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h * DK + 8 * j + 2 * t;
      const float o0 = o[j][2 * hh], o1 = o[j][2 * hh + 1];
      if (a.oh) fs::store2(a.oh + r * D + col, o0, o1);
      const float2 gv = fs::load2(a.g + r * D + col);
      fs::store2(a.gated + r * D + col, fs::silu(gv.x) * ((o0 - mu[hh]) * rs[hh]),
                 fs::silu(gv.y) * ((o1 - mu[hh]) * rs[hh]));
    }
  }
}

inline int core_state16(const CoreArgs16& a, int BC, cudaStream_t st) {
  core_state16_kernel<<<BC * H, 128, 0, st>>>(a);
  return cudaGetLastError();
}

inline int core_out16(const CoreArgs16& a, int BC, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(core_out16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kOutBytes);
  if (e != cudaSuccess) return e;
  core_out16_kernel<<<dim3(BC * H, a.T / a.L, (a.L + kT - 1) / kT), 128, kOutBytes, st>>>(a);
  return cudaGetLastError();
}

// ---- the core's backward ----

struct CoreBwd16 {
  const bf16* qkv;          // (R, 3D) q | k~ | v
  const float* doh;         // (R, D) the group norm's input gradient
  const float* inr;         // (R, H) the forward's row sums
  const float *kvs, *ss;    // the checkpoints
  float* dS;                // (BC, H, N, DK, DK): the state cotangent after each chunk
  float* d32;               // (R, 4D): dq | dk | dv written at columns 0, D, 2D
  bf16* d16;                // (R, 4D): their bf16 copies
  int C, T, L;
  float kscale;
};

// rows [r0, r0 + 64) of a chunk, f(row l, column) -> a bf16 tile (zero at
// or past L); 8 columns a thread and step
template <class F>
__device__ __forceinline__ void make_tile(bf16* dst, int r0, int L, F f) {
  for (int idx = threadIdx.x; idx < kT * (DK / 8); idx += blockDim.x) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    uint32_t u[4] = {0u, 0u, 0u, 0u};
    if (r0 + r < L) {
      float x[8];
      f(r0 + r, c, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = pack2(x[2 * i], x[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// doh's 8 columns at (row l of the chunk, c), times a row factor, rounded
__device__ __forceinline__ void doh_times(const float* p, float f, float (&x)[8]) {
  const float4 a = fs::load4(p), b = fs::load4(p + 4);
  x[0] = a.x * f, x[1] = a.y * f, x[2] = a.z * f, x[3] = a.w * f;
  x[4] = b.x * f, x[5] = b.y * f, x[6] = b.z * f, x[7] = b.w * f;
}

// per (sequence, head): dS_n = sum over the chunks m > n of
// q_id(m)^T dcross(m) / c_m, added from the last chunk down
__global__ void __launch_bounds__(128) core_bwd_ds16_kernel(CoreBwd16 a) {
  __shared__ __align__(16) bf16 Qd[kTileE], Pc[kTileE];
  const int tid = threadIdx.x, w = tid >> 5;
  const int bc = blockIdx.x / H, h = blockIdx.x % H, L = a.L, N = a.T / L;
  const float sqL = sqrtf((float)L);
  float dS[8][4];
  zero8(dS);
  for (int n = N - 1; n >= 0; --n) {
    float* out = a.dS + (((size_t)bc * H + h) * N + n) * DK * DK;
    each8(dS, [&](int m, int col, float x) { out[(16 * w + m) * DK + col] = x; });
    const size_t row0 = (size_t)bc * a.T + (size_t)n * L;
    const float c = a.ss[ck_slot(bc, n, h, a.C, N)];
    float acc[8][4];
    zero8(acc);
    for (int i0 = 0; i0 < L; i0 += kT) {
      __syncthreads();
      make_tile(Qd, i0, L, [&](int l, int col, float (&x)[8]) {  // q_id = q sqrt(L) / sqrt(l + 1)
        const float f = sqL / sqrtf(l + 1.f);
        const bf16* q = a.qkv + (row0 + l) * 3 * D + h * DK + col;
        const float4 u = fs::load4(q), v = fs::load4(q + 4);
        x[0] = u.x * f, x[1] = u.y * f, x[2] = u.z * f, x[3] = u.w * f;
        x[4] = v.x * f, x[5] = v.y * f, x[6] = v.z * f, x[7] = v.w * f;
      });
      make_tile(Pc, i0, L, [&](int l, int col, float (&x)[8]) {  // dcross = doh (c / all)
        const float all = fmaxf(a.inr[(row0 + l) * H + h], c);
        doh_times(a.doh + (row0 + l) * D + h * DK + col, c / all, x);
      });
      __syncthreads();
      mma_tn(acc, Qd, Pc, w);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dS[j][e] += acc[j][e] / c;
  }
}

constexpr int kBwdBytes = (int)sizeof(bf16) * 5 * kTileE + (int)sizeof(float) * 2 * kT;

// one block per (sequence, head) x chunk x (key tile J: dk, dv; or query
// tile I: dq)
__global__ void __launch_bounds__(128, 3) core_bwd_chunk16_kernel(CoreBwd16 a) {
  extern __shared__ __align__(16) bf16 bsm[];
  bf16* T0 = bsm;
  bf16* T1 = T0 + kTileE;
  bf16* T2 = T1 + kTileE;
  bf16* T3 = T2 + kTileE;
  bf16* T4 = T3 + kTileE;
  float* vinr = reinterpret_cast<float*>(T4 + kTileE);  // (64) the tile's row sums
  float* vrsq = vinr + kT;                              // (64) 1 / sqrt(i + 1)
  const int tid = threadIdx.x, w = tid >> 5, g = tc::lane_g(), t = tc::lane_t();
  const int bc = blockIdx.x / H, h = blockIdx.x % H, n = blockIdx.y;
  const int L = a.L, N = a.T / L, nb = (L + kT - 1) / kT;
  const size_t row0 = (size_t)bc * a.T + (size_t)n * L;
  const bf16* rows = a.qkv + row0 * 3 * D + h * DK;
  const size_t slot = ck_slot(bc, n, h, a.C, N);
  const float c = a.ss[slot];
  const float* doh = a.doh + row0 * D + h * DK;
  const float* inr = a.inr + row0 * H + h;
  // din = doh (inner / all), dcross = doh (c / all), rounded
  auto din_tile = [&](bf16* dst, int i0) {
    make_tile(dst, i0, L, [&](int l, int col, float (&x)[8]) {
      const float in = inr[(size_t)l * H];
      doh_times(doh + (size_t)l * D + col, in / fmaxf(in, c), x);
    });
  };
  auto put_rows = [&](const float (&x)[8][4], int r0, int col0) {  // float32 and bf16 copies
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = r0 + 16 * w + g + 8 * hh;
      if (l >= L) continue;
      const size_t off = (row0 + l) * 4 * D + col0 + h * DK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 8 * j + 2 * t;
        fs::store2(a.d32 + off + cc, x[j][2 * hh], x[j][2 * hh + 1]);
        fs::store2(a.d16 + off + cc, x[j][2 * hh], x[j][2 * hh + 1]);
      }
    }
  };
  if ((int)blockIdx.z >= nb) {  // ---- dq of query tile I ----
    const int I = blockIdx.z - nb;
    bf16 *Ds = T0, *Cs = T1, *KVr = T2, *Ks = T3, *Vs = T4;
    din_tile(Ds, I * kT);
    make_tile(Cs, I * kT, L, [&](int l, int col, float (&x)[8]) {
      const float in = inr[(size_t)l * H];
      doh_times(doh + (size_t)l * D + col, c / fmaxf(in, c), x);
    });
    const float* ck = a.kvs + slot * DK * DK;
    for (int i = tid; i < DK * DK / 2; i += 128) {  // KV / c rounded, [k][v]
      const int k = (2 * i) / DK, v = (2 * i) % DK;
      const float2 x = fs::load2(ck + 2 * i);
      *reinterpret_cast<uint32_t*>(KVr + k * kLd + v) = pack2(x.x / c, x.y / c);
    }
    int ir[2];
    float rsq[2], idec[2], in[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ir[hh] = I * kT + 16 * w + g + 8 * hh;
      rsq[hh] = 1.f / sqrtf(ir[hh] + 1.f);
      idec[hh] = sqrtf((float)L) / sqrtf(ir[hh] + 1.f);
      in[hh] = ir[hh] < L ? inr[(size_t)ir[hh] * H] : 1.f;
    }
    __syncthreads();
    float dq[8][4];  // dcross KV_r^T sqrt(L) / sqrt(i + 1)
    zero8(dq);
    mma_rows<true>(dq, Cs + 16 * w * kLd, KVr);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] *= idec[e >> 1];
    for (int J = 0; J <= I; ++J) {
      __syncthreads();
      load_chunk_tile(Ks, rows + D, 3 * D, J * kT, L);
      load_chunk_tile(Vs, rows + 2 * D, 3 * D, J * kT, L);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      float dm[8][4];  // dqk = (din v^T) / inner * mask, rounded
      zero8(dm);
      mma_rows<true>(dm, Ds + 16 * w * kLd, Vs);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, jj = J * kT + 8 * j + 2 * t + (e & 1);
          dm[j][e] = jj <= ir[hh] && ir[hh] < L ? fs::rnd<bf16>(dm[j][e] / in[hh] * rsq[hh]) : 0.f;
        }
      mma_acc(dq, dm, Ks);
    }
    put_rows(dq, I * kT, 0);
    return;
  }
  // ---- dk and dv of key tile J ----
  const int J = blockIdx.z;
  bf16 *Ks = T0, *Vs = T1, *dSr = T2, *Qs = T3, *Ds = T4;
  load_chunk_tile(Ks, rows + D, 3 * D, J * kT, L);
  load_chunk_tile(Vs, rows + 2 * D, 3 * D, J * kT, L);
  tc::cp_async_commit();
  const float* dS = a.dS + (((size_t)bc * H + h) * N + n) * DK * DK;
  for (int i = tid; i < DK * DK / 2; i += 128) {  // dS_n rounded, [k][v]
    const int k = (2 * i) / DK, v = (2 * i) % DK;
    const float2 x = fs::load2(dS + 2 * i);
    *reinterpret_cast<uint32_t*>(dSr + k * kLd + v) = pack2(x.x, x.y);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  const int jr[2] = {J * kT + 16 * w + g, J * kT + 16 * w + g + 8};
  // the state's terms first, (k~ dS) / sqrt(L) and (v dS^T) / sqrt(L): the
  // accumulators the chunk's terms then add to
  const float wlast = (float)(1.0 / sqrt((double)L));
  float dv[8][4], dk[8][4];
  zero8(dv);
  zero8(dk);
  mma_rows<false>(dv, Ks + 16 * w * kLd, dSr);
  mma_rows<true>(dk, Vs + 16 * w * kLd, dSr);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] *= wlast, dk[j][e] *= wlast;
  for (int I = J; I < nb; ++I) {
    __syncthreads();
    load_chunk_tile(Qs, rows, 3 * D, I * kT, L);
    tc::cp_async_commit();
    din_tile(Ds, I * kT);
    if (tid < kT) {
      const int i = I * kT + tid;
      vinr[tid] = i < L ? inr[(size_t)i * H] : 1.f;
      vrsq[tid] = 1.f / sqrtf(i + 1.f);
    }
    tc::cp_async_wait<0>();
    __syncthreads();
    float st[8][4];  // innin^T: (k~ q^T)(j, i) / sqrt(i + 1) / inner_i, rounded
    zero8(st);
    mma_rows<true>(st, Ks + 16 * w * kLd, Qs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * j + 2 * t + (e & 1), i = I * kT + il;
        st[j][e] = jr[e >> 1] <= i && i < L ? fs::rnd<bf16>(st[j][e] * vrsq[il] / vinr[il]) : 0.f;
      }
    mma_acc(dv, st, Ds);
    zero8(st);  // dqk^T: (v din^T)(j, i) / inner_i / sqrt(i + 1), rounded
    mma_rows<true>(st, Vs + 16 * w * kLd, Ds);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * j + 2 * t + (e & 1), i = I * kT + il;
        st[j][e] = jr[e >> 1] <= i && i < L ? fs::rnd<bf16>(st[j][e] / vinr[il] * vrsq[il]) : 0.f;
      }
    mma_acc(dk, st, Qs);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] *= a.kscale;
  put_rows(dk, J * kT, D);
  put_rows(dv, J * kT, 2 * D);
}

inline int core_bwd16(const CoreBwd16& a, int BC, cudaStream_t st) {
  core_bwd_ds16_kernel<<<BC * H, 128, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(core_bwd_chunk16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kBwdBytes);
  if (e != cudaSuccess) return e;
  const int nb = (a.L + kT - 1) / kT;
  core_bwd_chunk16_kernel<<<dim3(BC * H, a.T / a.L, 2 * nb), 128, kBwdBytes, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ln_bwd16_kernel: the LayerNorm backward of one sublayer from dy (TD: bf16
// for the layer's output, float32 for the residual stream's gradient) and
// the pre-norm sum: dres (float32, may be dy) and the branch gradient dres *
// mask(site) rounded to bf16; the block's column sums of the scale, bias
// and branch gradients (3D floats) to part[blockIdx.x], in a fixed order
// ---------------------------------------------------------------------------

template <typename TD>
__global__ void __launch_bounds__(256)
ln_bwd16_kernel(const TD* dy, const float* __restrict__ rsum, const bf16* __restrict__ scale,
                float* dres, bf16* __restrict__ dlo, float* __restrict__ part, long long R, Drop dp,
                int site) {
  __shared__ float red[3][8][D];
  const int c0 = lane_id() * NV, warp = threadIdx.x >> 5;
  float ds[NV], db[NV], dbr[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) ds[i] = db[i] = dbr[i] = 0.f;
  DTF_FOR_ROWS(r, R) {
    const RowPos p = row_pos(dp, r);
    const unsigned base = hash_base(dp, p.b, p.n, site);
    float v[NV], g[NV], t[NV];
    load_row(rsum + r * D, v);
    load_row(dy + r * D, g);
    const float mu = row_sum(v) / D;
#pragma unroll
    for (int i = 0; i < NV; ++i) t[i] = (v[i] - mu) * (v[i] - mu);
    const float rs = rsqrtf(row_sum(t) / D + 1e-5f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      v[i] = fs::rnd<bf16>((v[i] - mu) * rs);  // xhat, as the TPU kernel stashes it
      ds[i] += g[i] * v[i];
      db[i] += g[i];
      g[i] *= fs::ldg(scale + c0 + i);
      t[i] = g[i] * v[i];
    }
    const float m1 = row_sum(g) / D, m2 = row_sum(t) / D;
#pragma unroll
    for (int i = 0; i < NV; ++i) g[i] = rs * (g[i] - m1 - v[i] * m2);
    store_row(dres + r * D, g);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      g[i] *= keep_or_1(dp, base, (unsigned)(p.cl * D + c0 + i));
      dbr[i] += g[i];
    }
    store_row(dlo + r * D, g);
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    red[0][warp][c0 + i] = ds[i], red[1][warp][c0 + i] = db[i], red[2][warp][c0 + i] = dbr[i];
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) {
    const int which = c / D, col = c % D;
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[which][w][col];
    part[(size_t)blockIdx.x * 3 * D + c] = s;
  }
}

// out[c] for c < 3D, the three gradients rounded: scale, bias (one row of
// the (3, D) LayerNorm gradients each) and the branch's bias gradient
__global__ void ln_bwd16_reduce_kernel(const float* __restrict__ part, int S, bf16* dscale,
                                       bf16* dbias, bf16* dbranch) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < 3 * D; c += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < S; ++z) s += part[(size_t)z * 3 * D + c];
    (c < D ? dscale : c < 2 * D ? dbias : dbranch)[c % D] = __float2bfloat16_rn(s);
  }
}

template <typename TD>
inline int ln_bwd16(const TD* dy, const float* rsum, const bf16* scale, float* dres, bf16* dlo,
                    bf16* dscale, bf16* dbias, bf16* dbranch, long long R, const Drop& dp,
                    int site, float* part, cudaStream_t st) {
  const int grid = (int)lmin((R + 7) / 8, kLnBwdBlocks);
  ln_bwd16_kernel<TD><<<grid, 256, 0, st>>>(dy, rsum, scale, dres, dlo, part, R, dp, site);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_bwd16_reduce_kernel<<<(3 * D + 255) / 256, 256, 0, st>>>(part, grid, dscale, dbias, dbranch);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// slot_attn_bwd16_kernel: dec_train_fusion_common.cuh's
// slot_attn_bwd_kernel<bf16> on bf16 pairs, one warp per (b, t, head): the
// scores as the forward's (dec_scan16.cuh's slot_attn16_kernel), the weights and their
// dropout multipliers rounded; d(w * mask) from the products of dattn
// rounded to bf16 and v, each rounded (one bf16x2 multiply); the softmax
// backward in float32; dq, dk and dv summed in float32 over the slots, a
// lane a column pair (dv from the unrounded dattn); dqkv float32 and its
// bf16 copy.  Shared per warp: q, k, v and rounded dattn as bf16 pairs in
// rows of DK / 2 + 1 words, dattn in float32, the weights (C x C: w, the
// weight times its multiplier, and the score gradient).
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int slot_bwd16_words(int C) {
  return kSlotWarps * (4 * C * kSW + C * DK + 3 * C * C);
}

__global__ void __launch_bounds__(32 * kSlotWarps)
slot_attn_bwd16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ dattn,
                       float* __restrict__ dqkv, bf16* __restrict__ dlo, int B, Drop dp) {
  extern __shared__ __align__(16) uint32_t bsm32[];
  const int C = dp.C, T = dp.T;
  const int gw = blockIdx.x * kSlotWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (gw >= B * T * H) return;
  const int h = gw % H, t = (gw / H) % T, b = gw / (H * T);
  uint32_t* qs = bsm32 + (threadIdx.x >> 5) * (slot_bwd16_words(C) / kSlotWarps);
  uint32_t *ks = qs + C * kSW, *vs = ks + C * kSW, *ds = vs + C * kSW;
  float* da = reinterpret_cast<float*>(ds + C * kSW);  // (C, DK)
  float* W = da + C * DK;                              // (C, C) rounded weights
  float* WM = W + C * C;                               // rounded weight x rounded multiplier
  float* S = WM + C * C;                               // the scores' gradient
  for (int c = 0; c < C; ++c) {
    const size_t r = ((size_t)b * C + c) * T + t;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(qkv + r * 3 * D + h * DK);
    const float2* drow = reinterpret_cast<const float2*>(dattn + r * D + h * DK);
    for (int i = lane; i < DK / 2; i += 32) {
      qs[c * kSW + i] = row[i];
      ks[c * kSW + i] = row[D / 2 + i];
      vs[c * kSW + i] = row[D + i];
      const float2 g = drow[i];
      da[c * DK + 2 * i] = g.x, da[c * DK + 2 * i + 1] = g.y;
      const __nv_bfloat162 g16 = __floats2bfloat162_rn(g.x, g.y);
      ds[c * kSW + i] = *reinterpret_cast<const uint32_t*>(&g16);
    }
  }
  __syncwarp();
  const float inv = (float)(1.0 / sqrt((double)DK));
  auto pair = [](uint32_t u) { return *reinterpret_cast<const __nv_bfloat162*>(&u); };
  for (int p = lane; p < C * C; p += 32) {  // the scores; d(w * mask) before the mask
    const int c = p / C, j = p % C;
    float s = 0.f, g = 0.f;
#pragma unroll 8
    for (int i = 0; i < DK / 2; ++i) {
      const float2 f = __bfloat1622float2(__hmul2(pair(qs[c * kSW + i]), pair(ks[j * kSW + i])));
      const float2 e = __bfloat1622float2(__hmul2(pair(ds[c * kSW + i]), pair(vs[j * kSW + i])));
      s += f.x;
      s += f.y;
      g += e.x;
      g += e.y;
    }
    W[p] = s * inv;
    S[p] = g;
  }
  __syncwarp();
  if (lane < C) {  // row c = lane: softmax, the rounded weights and multipliers, its backward
    const int c = lane;
    const unsigned base = hash_base(dp, b, t / dp.L, kAttnW + 16 * h);
    float m = W[c * C];
    for (int j = 1; j < C; ++j) m = fmaxf(m, W[c * C + j]);
    float sum = 0.f;
    for (int j = 0; j < C; ++j) {
      const float e = expf(W[c * C + j] - m);
      W[c * C + j] = e;
      sum += e;
    }
    float tsum = 0.f;
    for (int j = 0; j < C; ++j) {
      const float w = fs::rnd<bf16>(W[c * C + j] / sum);
      const float mk = fs::rnd<bf16>(keep(dp, base, (unsigned)((c * dp.L + t % dp.L) * C + j)));
      W[c * C + j] = w;
      WM[c * C + j] = w * mk;
      S[c * C + j] *= mk;
      tsum += S[c * C + j] * w;
    }
    for (int j = 0; j < C; ++j) S[c * C + j] = W[c * C + j] * (S[c * C + j] - tsum) * inv;
  }
  __syncwarp();
  for (int c = 0; c < C; ++c) {
    const size_t r = ((size_t)b * C + c) * T + t;
    float* out = dqkv + r * 3 * D + h * DK;
    bf16* lo = dlo + r * 3 * D + h * DK;
    for (int i = lane; i < DK / 2; i += 32) {
      float gq0 = 0.f, gq1 = 0.f, gk0 = 0.f, gk1 = 0.f, gv0 = 0.f, gv1 = 0.f;
      for (int j = 0; j < C; ++j) {
        const float2 kj = __bfloat1622float2(pair(ks[j * kSW + i]));
        const float2 qj = __bfloat1622float2(pair(qs[j * kSW + i]));
        const float scj = S[c * C + j], sjc = S[j * C + c], wjc = WM[j * C + c];
        gq0 += scj * kj.x, gq1 += scj * kj.y;
        gk0 += sjc * qj.x, gk1 += sjc * qj.y;
        gv0 += wjc * da[j * DK + 2 * i], gv1 += wjc * da[j * DK + 2 * i + 1];
      }
      fs::store2(out + 2 * i, gq0, gq1);
      fs::store2(out + D + 2 * i, gk0, gk1);
      fs::store2(out + 2 * D + 2 * i, gv0, gv1);
      fs::store2(lo + 2 * i, gq0, gq1);
      fs::store2(lo + D + 2 * i, gk0, gk1);
      fs::store2(lo + 2 * D + 2 * i, gv0, gv1);
    }
  }
}

inline int slot_attn_bwd16(const bf16* qkv, const float* dattn, float* dqkv, bf16* dlo, int B,
                           const Drop& dp, cudaStream_t st) {
  const int smem = (int)sizeof(uint32_t) * slot_bwd16_words(dp.C);
  cudaError_t e = cudaFuncSetAttribute(slot_attn_bwd16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int grid = (B * dp.T * H + kSlotWarps - 1) / kSlotWarps;
  slot_attn_bwd16_kernel<<<grid, 32 * kSlotWarps, smem, st>>>(qkv, dattn, dqkv, dlo, B, dp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The sequences
// ---------------------------------------------------------------------------

// the products' weights in the (out, in) layout (each the Wt of its
// forward product), the biases and the LayerNorms' (3, D)
struct W16 {
  const bf16 *wqkvg, *bqkvg, *wro, *bro, *wmi, *bmi, *wmo, *bmo, *wf1, *bf1, *wf2, *bf2;
  const bf16 *lns, *lnb;
};

// The forward's buffers.  kvs / ss: the checkpoints the chunks read;
// r1-r3, oh, inr, bits, hdrop and y may be null (the forward writes y, its
// FFN in one kernel without hdrop; the backward's recompute r1-r3, oh, inr,
// hdrop and bits).
struct Bufs16 {
  bf16 *qkv, *gated, *x1lo, *mqkv, *attn, *x2lo, *hdrop, *y;
  float *g, *x1, *x2, *r1, *r2, *r3, *oh, *inr, *kvs, *ss;
  uint32_t* bits;
};

// bufs holding the mask bits of an (R, F) hidden layer: a word per thread
// and row half of each 128 x 128 tile
inline size_t bits_words(long long R, int F) { return (size_t)((R + kBM - 1) / kBM) * (F / 128) * 512; }

// The forward (state = true: the chunk states too, else read from kvs / ss).
inline int forward_tc16(const bf16* x, const W16& w, const Bufs16& b, int B, int C, int T, int L,
                        int F, const Drop& dp, bool state, cudaStream_t st) {
  const int BC = B * C, R = BC * T;
  int err;
#define DTF_TRY(call) \
  if ((err = (call)) != 0) return err
  Ep e{};
  e.dp = dp;
  {  // q | k | v rounded (k scaled, rounded again), g float32
    Ep q = e;
    q.bias = w.bqkvg, q.s_lo = D, q.s_hi = 2 * D, q.s = kscale_bf16(), q.gcol = 3 * D;
    q.g32 = b.g, q.out16 = b.qkv, q.ld16 = 3 * D;
    DTF_TRY(mm16<kRnd>(x, w.wqkvg, R, 4 * D, D, q, st));
  }
  const CoreArgs16 ca{b.qkv, b.g, b.kvs, b.ss, b.gated, b.oh, b.inr, C, T, L};
  if (state) DTF_TRY(core_state16(ca, BC, st));
  DTF_TRY(core_out16(ca, BC, st));
  {  // out projection, dropout, + x, LN1
    Ep o = e;
    o.bias = w.bro, o.res16 = x, o.rsum = b.r1, o.out32 = b.x1, o.out16 = b.x1lo, o.ld16 = D;
    o.lns = w.lns, o.lnb = w.lnb, o.site = kRet;
    DTF_TRY(mm16<kResLn>(b.gated, w.wro, R, D, D, o, st));
  }
  {  // the slot attention's q | k | v
    Ep m = e;
    m.bias = w.bmi, m.gcol = 3 * D, m.out16 = b.mqkv, m.ld16 = 3 * D;
    DTF_TRY(mm16<kRnd>(b.x1lo, w.wmi, R, 3 * D, D, m, st));
  }
  DTF_TRY(d16::slot_attn16(b.mqkv, b.attn, B, dp, st));
  {  // its out projection, dropout, + x1, LN2
    Ep o = e;
    o.bias = w.bmo, o.res32 = b.x1, o.rsum = b.r2, o.out32 = b.x2, o.out16 = b.x2lo, o.ld16 = D;
    o.lns = w.lns + D, o.lnb = w.lnb + D, o.site = kMha;
    DTF_TRY(mm16<kResLn>(b.attn, w.wmo, R, D, D, o, st));
  }
  Ep f2 = e;  // FF2, dropout, + x2, LN3 (y); the backward's recompute: the sum r3 alone
  f2.bias = w.bf2, f2.res32 = b.x2, f2.rsum = b.r3, f2.out16 = b.y, f2.ld16 = D;
  f2.lns = w.lns + 2 * D, f2.lnb = w.lnb + 2 * D, f2.site = kFfo;
  if (!b.hdrop) {  // the forward call: the FFN in one kernel
    DTF_TRY(ffn16t<false>(b.x2lo, w.wf1, w.bf1, w.wf2, f2, nullptr, R, F, st));
  } else {  // FF1: relu and the hidden dropout, rounded (and relu' as bits), then FF2
    Ep f1 = e;
    f1.bias = w.bf1, f1.out16 = b.hdrop, f1.ld16 = F, f1.bits = b.bits;
    DTF_TRY(mm16<kRelu>(b.x2lo, w.wf1, R, F, D, f1, st));
    DTF_TRY(mm16<kResLn>(b.hdrop, w.wf2, R, D, F, f2, st));
  }
#undef DTF_TRY
  return 0;
}

// the weights the backward's input gradients read, (in, out)
struct WT16 {
  const bf16 *tqkvg, *tro, *tmi, *tmo, *tf1, *tf2;
};

// the 14 gradients, bf16, in FusionWeights order
struct Grads16 {
  bf16 *gqkvg, *gbqkvg, *gro, *gbro, *gmi, *gbmi, *gmo, *gbmo, *gf1, *gbf1, *gf2, *gbf2, *glns,
      *glnb;
};

struct BwdBufs16 {
  Bufs16 fw;
  float *dxf, *d32, *dqkv, *dqkvg, *doh, *dS, *colpart, *part;
  bf16 *g2lo, *gFlo, *dqkvlo, *dqkvglo;
};

inline int backward_tc16(const bf16* x, const bf16* dy, const float* kvs, const float* ss,
                         const W16& w, const WT16& wt, const Grads16& gr, bf16* dx,
                         const BwdBufs16& bb, int B, int C, int T, int L, int F, const Drop& dp,
                         cudaStream_t st) {
  const int BC = B * C, R = BC * T;
  const Bufs16& f = bb.fw;
  float* part = bb.part;
  int err;
#define DTF_TRY(call) \
  if ((err = (call)) != 0) return err
  // ---- recompute the forward from the checkpoints ----
  DTF_TRY(forward_tc16(x, w, f, B, C, T, L, F, dp, false, st));
  Ep e{};
  e.dp = dp;
  // ---- LN3 and the FFN; dxf carries the residual stream's gradient ----
  DTF_TRY(ln_bwd16(dy, f.r3, w.lns + 2 * D, bb.dxf, bb.g2lo, gr.glns + 2 * D, gr.glnb + 2 * D,
                   gr.gbf2, R, dp, kFfo, part, st));
  DTF_TRY(wgrad16(bb.g2lo, f.hdrop, gr.gf2, R, D, F, part, st));
  Ep add = e;
  add.out32 = bb.dxf;
  {  // FF2's input gradient through the hidden dropout and relu', rounded (gFlo, and the
     // column sums of each warp's rows), on into FF1's, added into dxf; gbf1 from the sums
    Ep g = add;
    g.bits = f.bits, g.colpart = bb.colpart;
    DTF_TRY(ffn16t<true>(bb.g2lo, wt.tf2, nullptr, wt.tf1, g, bb.gFlo, R, F, st));
    DTF_TRY(colsum16(bb.colpart, F, gr.gbf1, (R + kBM - 1) / kBM * 8, F, part, st));
  }
  DTF_TRY(wgrad16(bb.gFlo, f.x2lo, gr.gf1, R, F, D, part, st));
  // ---- LN2 and the slot attention ----
  DTF_TRY(ln_bwd16(bb.dxf, f.r2, w.lns + D, bb.dxf, bb.g2lo, gr.glns + D, gr.glnb + D, gr.gbmo,
                   R, dp, kMha, part, st));
  DTF_TRY(wgrad16(bb.g2lo, f.attn, gr.gmo, R, D, D, part, st));
  Ep f32 = e;
  f32.out32 = bb.d32;
  DTF_TRY(mm16<kF32>(bb.g2lo, wt.tmo, R, D, D, f32, st));  // dattn
  DTF_TRY(slot_attn_bwd16(f.mqkv, bb.d32, bb.dqkv, bb.dqkvlo, B, dp, st));
  DTF_TRY(colsum16(bb.dqkv, 3 * D, gr.gbmi, R, 3 * D, part, st));
  DTF_TRY(wgrad16(bb.dqkvlo, f.x1lo, gr.gmi, R, 3 * D, D, part, st));
  DTF_TRY(mm16<kAdd>(bb.dqkvlo, wt.tmi, R, D, 3 * D, add, st));
  // ---- LN1, the out projection and the gate ----
  DTF_TRY(ln_bwd16(bb.dxf, f.r1, w.lns, bb.dxf, bb.g2lo, gr.glns, gr.glnb, gr.gbro, R, dp, kRet,
                   part, st));
  DTF_TRY(wgrad16(bb.g2lo, f.gated, gr.gro, R, D, D, part, st));
  DTF_TRY(mm16<kF32>(bb.g2lo, wt.tro, R, D, D, f32, st));  // dgated
  DTF_TRY(gate_bwd<bf16>(bb.d32, f.oh, f.g, D, bb.dqkvg + 3 * D, 4 * D, bb.doh, R, st,
                         bb.dqkvglo + 3 * D));
  // ---- the retention core, then its projections ----
  const CoreBwd16 cb{f.qkv, bb.doh, f.inr, kvs, ss, bb.dS, bb.dqkvg, bb.dqkvglo, C, T, L,
                     (float)(1.0 / sqrt((double)DK))};
  DTF_TRY(core_bwd16(cb, BC, st));
  DTF_TRY(colsum16(bb.dqkvg, 4 * D, gr.gbqkvg, R, 4 * D, part, st));
  DTF_TRY(wgrad16(bb.dqkvglo, x, gr.gqkvg, R, 4 * D, D, part, st));
  Ep last = add;
  last.out16 = dx, last.ld16 = D;  // dx = dxf + this product, rounded
  DTF_TRY(mm16<kAdd>(bb.dqkvglo, wt.tqkvg, R, D, 4 * D, last, st));
#undef DTF_TRY
  return 0;
}

}  // namespace t16
