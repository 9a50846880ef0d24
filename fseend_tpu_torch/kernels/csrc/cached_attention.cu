// Attention of a block of K queries against a fixed-capacity KV cache on
// Hopper, float32, forward only.
//
// Replaces the two TPU kernels of fseend_tpu/kernels/cached_attention_pallas.py:
//   flash_cached_attention_perlane (_kernel_perlane): one write head per
//     lane and a min_pos floor, for FS-EEND's per-frame-exact fast block
//     (every encoder and decoder layer) -> perlane_kernel (K > 1) and
//     perlane_split_kernel + combine_kernel (K = 1, step()) below;
//   flash_cached_attention (_kernel; wrapper cached_attention_block): one
//     write head shared by every row and no floor, for the encoder of
//     FS-EEND's blockwise step -> shared_head_kernel below.
// For row r (a (lane, [slot,] head) triple, rows lane-major) and query i < K,
// with qpos = start[r / rows_per_lane] + i, they compute
//   out[r][i] = sum_p w[p] v[r][p],  w = softmax_p(q[r][i] . k[r][p] / sqrt(hd))
// over the positions p < cap with (min_pos <= p <= qpos) or p == qpos.  The
// shared-head form has a single start for all rows and min_pos = 0.
//
// What bounds it on the card.  A block of K queries: operations.  Each
// (query, readable position) pair costs 4 hd float32 operations (q.k and
// p.v), against 8 hd bytes of cache that every query of the row shares: at
// the decoder's fast-block shape (1536 rows, K 125, hd 64, start 1375) 70
// GFLOP against 1.1 GB read once, 0.43 ms of the tensor cores at three TF32
// passes (tc_f32.cuh), 0.33 ms of device memory.  One query (K = 1, step()):
// bytes.  The same cache prefix is read for 4 hd operations per position,
// 0.5 operations a byte.
//
// Masked entries: the score of a masked position is the finite -1e30 the JAX
// kernels use, and its probability is set to 0 explicitly.  With min_pos > 0
// a pre-warm-up query (qpos < min_pos) sees whole tiles masked before its
// first finite score, where exp(-1e30 - (-1e30)) would be 1; the explicit
// zero keeps those tiles out of the sum and the accumulator (the JAX kernel
// does the same, cached_attention_pallas.py:207-209).  Every query reads at
// least one position (its own, or [min_pos, cap) when qpos >= cap), so the
// final division is by a positive sum.
//
// K > 1, both forms (one body, tc_body<PERLANE>), on the tensor cores: one
// block per (row, 128-query tile), so at K <= 128 each row's cache prefix is
// read once.  Each of the 8 warps owns 16 query rows; q k^T and p v run
// through the float32-exact 3xTF32 mma tile of tc_f32.cuh.  kv tiles of 64
// positions are double-buffered in shared memory and copied with 16-byte
// cp.async, the next tile's copy in flight while the current one is
// multiplied; tiles past the block's last readable position are not loaded,
// and a warp skips the tiles past its own rows' last one.  The softmax is
// online, in float32 in registers: a lane holds two query rows (g, g + 8)
// and the four lanes of a row reduce by shuffles.  The probabilities go
// from the score accumulator straight into the p v product's A fragment
// without shared memory: the 8 positions of each k step are taken in the
// order the accumulator holds them (2t, 2t + 1 -> t, t + 4), and the v rows
// are read in the same order.  Tile rows are padded to hd + 4 words (hd
// rounded up to 8), so every fragment load of a warp hits 32 banks.  The
// per-lane form differs only in its start (one per lane, read per block)
// and its mask (the floor, the self position).
//
// K = 1 (the per-lane form's step()), on the FMA pipe: a 16-row mma tile
// would be 15/16 empty.  One block of 128 threads per (row, split of the
// cache), looping over tiles of 128 positions copied to shared memory with
// 16-byte cp.async (rows past the last readable position are not read);
// thread t scores position t of the tile (float4 reads along a row of
// stride hd + 4: a quarter-warp hits 32 banks), the block takes the tile's
// max and sum (shuffles, then the 4 warps in order), and thread (g, c) adds
// the probabilities of positions g, g + G, ... times the float4 c of their v
// rows into its accumulator; the online softmax runs across the split's
// tiles.  When the rows alone cannot fill the card (the encoder's 256), the
// cache is split over blockIdx.y: each split writes its (max, sum,
// accumulator) to scratch (an empty split: -1e30, 0, 0), and combine_kernel
// merges a row's splits in the order of the split, weighting each by
// exp(max - the row's max): a split with no readable position weighs 0, and
// two calls give the same bits.  The scratch is the wrapper's.
//
// The head dim is a compile-time constant (CA_HD <= 128), so that the
// accumulators stay in registers.
//
// The bf16 form (built with FS_BF16; the float32 build is the code above,
// the element type E = float): q, k, v and out are bf16 in device memory,
// and the arithmetic is the Pallas kernels' on bf16 inputs
// (cached_attention_pallas.py:72-84, 199-217): the scores q k^T are sums of
// exact bf16 products in float32, scaled, masked and soft-maxed in float32;
// the unnormalized probabilities exp(s - m) are rounded to bf16 before they
// multiply v, while the row sum l adds them unrounded; out = acc / l is
// rounded to bf16.  The Pallas kernel takes its running max over kv blocks
// of 1024 positions and this kernel over tiles of 64 (or 128 at K = 1, and
// per split), so a probability can round an ulp apart where a later tile
// raises the max (the online-softmax drift the Pallas source notes).
//   K > 1 (tc_body_bf16): the float32 body's blocks and 64-position tiles
//   in bf16 rows of CA_HD + 8 elements (16-byte cp.async copies; each 8-row
//   ldmatrix phase hits distinct banks), streamed through a ring of kRing =
//   4 stages in pairs, the next pair in flight while one is multiplied, one
//   barrier a pair; q k^T and p v are one bf16 mma.sync.m16n8k16 pass each
//   with float32 accumulation (tc_bf16.cuh).  q and k fragments come by
//   ldmatrix, v's by ldmatrix.trans; the probabilities of two adjacent
//   8-position accumulator tiles are the A fragment of one 16-deep k step
//   of p v directly (the FlashAttention-2 layout: no permutation of the
//   positions, unlike the float32 body's m16n8k8 A fragment); a tile that
//   every row of a warp reads whole skips the mask; the exponentials are
//   the SFU's 2^x on scores scaled by one fma.  Its pace is the softmax
//   and mma.sync's issue, not the copies.  CA_HD % 16 == 0.
//   K = 1: the float32 split kernel's blocks, splits and 128-position
//   tiles, the tiles copied as bf16 rows by 16-byte cp.async into a ring of
//   three stages (two in flight while one is scored) and widened to float32
//   in registers; p rounded to bf16 before the p v sum; the partials and
//   the combine stay float32.
// At K = 1 with a tile's copy waited for before it is scored, two blocks
// an SM hold at most one tile's copy in flight, and the kernel is bound by
// the copies' latency at about a third of its bytes bound; the ring keeps
// it within 1.2 times its bytes bound.
// Bound at the decoder's fast-block shape: the same 70 GFLOP on the bf16
// tensor cores (989 TFLOP/s, 0.07 ms) against 0.55 GB of bf16 cache (0.17
// ms): bytes.  At K = 1, bytes, half the float32 form's.
#include <cmath>

#include "frame_scan_common.cuh"
#include "tc_f32.cuh"
#ifdef FS_BF16
#include "tc_bf16.cuh"
#endif

#ifndef CA_HD
#error "define CA_HD (the head dim, at most 128)"
#endif

#ifdef FS_BF16
using E = fs::bf16;
#else
using E = float;
#endif

namespace ca {

constexpr float kNeg = -1e30f;

static_assert(CA_HD >= 1 && CA_HD <= 128, "head dim must be in [1, 128]");

// n rows of a (rows, CA_HD) matrix into a tile of row stride LD by cp.async
// over NT threads (16-byte copies where a row is a multiple of 16 bytes);
// rows at or past `valid` are zero-filled
template <int LD, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int n, int valid) {
  if constexpr (CA_HD % 4 == 0) {
    constexpr int kChunks = CA_HD / 4;
    for (int idx = threadIdx.x; idx < n * kChunks; idx += NT) {
      const int r = idx / kChunks, c = (idx % kChunks) * 4;
      const bool ok = r < valid;
      tc::cp_async16(dst + r * LD + c, ok ? src + (size_t)r * CA_HD + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * CA_HD; idx += NT) {
      const int r = idx / CA_HD, c = idx % CA_HD;
      const bool ok = r < valid;
      tc::cp_async4(dst + r * LD + c, ok ? src + (size_t)r * CA_HD + c : src, ok);
    }
  }
}

// four bf16 values (8 bytes, the first in the lowest half) as float32
__device__ __forceinline__ float4 b16x4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// ---- K > 1, both forms, on the tensor cores ----

constexpr int kThreads = 256;              // 8 warps
constexpr int kTcQ = 128;                  // queries per block: 8 warps x 16 rows
constexpr int kTcKV = 64;                  // kv positions per tile
#ifndef FS_BF16
constexpr int kHdp = (CA_HD + 7) / 8 * 8;  // head dim rounded up to the mma's k
constexpr int kTcLd = kHdp + 4;            // row stride of the q, k and v tiles
constexpr int kNT = kHdp / 8;              // accumulator tiles along hd
constexpr int kPad = kHdp - CA_HD;         // zero columns of a tile row
constexpr int kPadDiv = kPad > 0 ? kPad : 1;

constexpr int tc_smem_floats() { return (kTcQ + 4 * kTcKV) * kTcLd; }

// q, out (R, K, CA_HD); k, v (R, cap, CA_HD); PERLANE: start[row /
// rows_per_lane] and the min_pos floor, else start[0] and no floor; the
// tiles are the kernel's dynamic shared memory
template <bool PERLANE>
__device__ __forceinline__ void tc_body(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const int* __restrict__ start, float* __restrict__ out,
                                        int K, int cap, int rows_per_lane, int min_pos,
                                        float scale) {
  extern __shared__ __align__(16) float tsm[];
  float* qs = tsm;                       // (kTcQ, kTcLd)
  float* kvs = qs + kTcQ * kTcLd;        // 2 stages x (k, v) x (kTcKV, kTcLd)

  const int row = blockIdx.x, q0 = blockIdx.y * kTcQ;
  const int warp = threadIdx.x >> 5, g = tc::lane_g(), t = tc::lane_t();
  const int st = PERLANE ? start[row / rows_per_lane] : start[0];
  const int nq = min(kTcQ, K - q0);
  const int last = min(st + q0 + nq - 1, cap - 1);  // the block's last readable position
  const int ntile = last / kTcKV + 1;
  const int wr0 = warp * 16;                          // the warp's first query row
  const bool active = wr0 < nq;
  const int wlast = min(st + q0 + min(wr0 + 15, nq - 1), cap - 1);

  const float* kr = k + (size_t)row * cap * CA_HD;
  const float* vr = v + (size_t)row * cap * CA_HD;
  if constexpr (kPad > 0) {  // the padded columns are never copied: zero them once
    for (int idx = threadIdx.x; idx < (kTcQ + 4 * kTcKV) * kPad; idx += kThreads)
      tsm[(idx / kPadDiv) * kTcLd + CA_HD + idx % kPadDiv] = 0.f;
  }
  auto load_kv = [&](int it) {
    float* ks = kvs + (it & 1) * 2 * kTcKV * kTcLd;
    const int j0 = it * kTcKV;
    load_rows<kTcLd, kThreads>(ks, kr + (size_t)j0 * CA_HD, kTcKV, cap - j0);
    load_rows<kTcLd, kThreads>(ks + kTcKV * kTcLd, vr + (size_t)j0 * CA_HD, kTcKV, cap - j0);
  };
  load_rows<kTcLd, kThreads>(qs, q + ((size_t)row * K + q0) * CA_HD, kTcQ, nq);
  load_kv(0);
  tc::cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max, sum and accumulator
  const int qp0 = st + q0 + wr0 + g, qp1 = qp0 + 8;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < ntile; ++it) {
    if (it + 1 < ntile) {
      load_kv(it + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and q) have landed for every thread
    const int j0 = it * kTcKV;
    if (active && j0 <= wlast) {
      const float* ks = kvs + (it & 1) * 2 * kTcKV * kTcLd;
      const float* vs = ks + kTcKV * kTcLd;
      // s = q k^T over the tile: 16 rows x 64 positions, 8 accumulator tiles
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHdp / 8; ++kk) {
        tc::FragA fa;
        tc::load_a(fa, qs + wr0 * kTcLd + kk * 8, kTcLd);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          tc::FragB fb;
          tc::load_b(fb, ks + n * 8 * kTcLd + kk * 8, 1, kTcLd);
          tc::mma3(s[n], fa, fb);
        }
      }
      // mask, scale and the online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = j0 + n * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok;
          if constexpr (PERLANE)
            ok = p < cap && ((p <= qp && p >= min_pos) || p == qp);
          else
            ok = p < cap && p <= qp;
          s[n][e] = ok ? s[n][e] * scale : kNeg;
          if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
          else mx1 = fmaxf(mx1, s[n][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = expf(m0 - n0), c1 = expf(m1 - n1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mref = e < 2 ? n0 : n1;
          const float pr = s[n][e] > 0.5f * kNeg ? expf(s[n][e] - mref) : 0.f;
          s[n][e] = pr;
          if (e < 2) sum0 += pr;
          else sum1 += pr;
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= c0, o[n][1] *= c0;
        o[n][2] *= c1, o[n][3] *= c1;
      }
      // o += p v: k step kk covers positions 8kk + (2t, 2t + 1), taken as (t, t + 4)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        tc::FragA fa;
        tc::set_a(fa, s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
        const float* v0 = vs + (kk * 8 + 2 * t) * kTcLd + g;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          tc::FragB fb;
          tc::split(v0[n * 8], fb.big[0], fb.small[0]);
          tc::split(v0[kTcLd + n * 8], fb.big[1], fb.small[1]);
          tc::mma3(o[n], fa, fb);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!active) return;
  float* orow = out + ((size_t)row * K + q0) * CA_HD;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wr0 + g + (e < 2 ? 0 : 8), d = n * 8 + 2 * t + (e & 1);
      if (r < nq && d < CA_HD) orow[(size_t)r * CA_HD + d] = o[n][e] * (e < 2 ? i0 : i1);
    }
}

constexpr int tc_smem_bytes() { return (int)sizeof(float) * tc_smem_floats(); }
#define CA_TC_BODY tc_body
#else
// ---- K > 1, both forms, bf16, on the tensor cores ----

static_assert(CA_HD % 16 == 0, "the bf16 form takes head dims that are multiples of 16");
using fs::bf16;

constexpr int kBLd = CA_HD + 8;               // row stride (elements) of the bf16 tiles
constexpr int kNB = CA_HD / 8;                // accumulator tiles along hd
constexpr int kRing = 4;                      // kv tiles of the ring: two pairs
constexpr int kStageB = 2 * kTcKV * kBLd;     // bf16 elements of a stage: k, then v

constexpr int tc_smem_bytes() { return (int)sizeof(bf16) * (kTcQ * kBLd + kRing * kStageB); }

// n rows of a (rows, CA_HD) bf16 matrix into a tile of row stride kBLd by
// 16-byte cp.async over NT threads; rows at or past `valid` are zero-filled
template <int NT = kThreads>
__device__ __forceinline__ void load_rows_b16(bf16* dst, const bf16* src, int n, int valid) {
  constexpr int kChunks = CA_HD / 8;
  for (int idx = threadIdx.x; idx < n * kChunks; idx += NT) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = r < valid;
    tc::cp_async16(dst + r * kBLd + c, ok ? src + (size_t)r * CA_HD + c : src, ok);
  }
}

// 2^x on the SFU in one instruction (a result under 2^-126 flushed to 0: a
// probability that small is 0 in every sum it joins)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as the bf16 pair of an mma fragment register (the first in
// the lower half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// tc_body's blocks, masks and online softmax on bf16 tiles, one bf16 pass
// for q k^T and one for p v.  The kv tiles stream through a ring of kRing
// stages in pairs: one barrier for every two tiles, the next pair's copies
// in flight while a pair is multiplied (the float32 body takes a barrier
// every tile, one tile's copy in flight).  A tile that every row of
// a warp reads whole (past the floor, before the warp's first query,
// inside the capacity) is scored without the mask, and the softmax takes
// the unscaled scores: p = 2^(s sl2 - m sl2), sl2 = scale log2 e, one fma
// and one exp2 a probability (the same exp((s - m) scale) to a few float32
// ulps).
template <bool PERLANE>
__device__ __forceinline__ void tc_body_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                             const bf16* __restrict__ v,
                                             const int* __restrict__ start, bf16* __restrict__ out,
                                             int K, int cap, int rows_per_lane, int min_pos,
                                             float scale) {
  extern __shared__ __align__(16) bf16 hsm[];
  bf16* qs = hsm;                        // (kTcQ, kBLd)
  bf16* kvs = qs + kTcQ * kBLd;          // kRing stages x (k, v) x (kTcKV, kBLd)

  const int row = blockIdx.x, q0 = blockIdx.y * kTcQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int st = PERLANE ? start[row / rows_per_lane] : start[0];
  const int nq = min(kTcQ, K - q0);
  const int last = min(st + q0 + nq - 1, cap - 1);  // the block's last readable position
  const int ntile = last / kTcKV + 1;
  const int wr0 = warp * 16;                          // the warp's first query row
  const bool active = wr0 < nq;
  const int wlast = min(st + q0 + min(wr0 + 15, nq - 1), cap - 1);
  // tiles [0, ... ] ending at or before wfull are read whole by every row
  const int wfull = min(st + q0 + wr0, cap - 1);

  const bf16* kr = k + (size_t)row * cap * CA_HD;
  const bf16* vr = v + (size_t)row * cap * CA_HD;
  auto load_kv = [&](int it) {
    bf16* ks = kvs + (it % kRing) * kStageB;
    const int j0 = it * kTcKV;
    load_rows_b16(ks, kr + (size_t)j0 * CA_HD, kTcKV, cap - j0);
    load_rows_b16(ks + kTcKV * kBLd, vr + (size_t)j0 * CA_HD, kTcKV, cap - j0);
  };
  // the tiles in pairs, pair p (tiles 2p, 2p + 1) in stages 2 (p % 2) and
  // 2 (p % 2) + 1: one barrier a pair, the next pair's copies in flight
  // while a pair is multiplied
  auto load_pair = [&](int p) {
    if (2 * p < ntile) load_kv(2 * p);
    if (2 * p + 1 < ntile) load_kv(2 * p + 1);
  };
  load_rows_b16(qs, q + ((size_t)row * K + q0) * CA_HD, kTcQ, nq);
  load_pair(0);
  tc::cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max, sum and accumulator
  const int qp0 = st + q0 + wr0 + g, qp1 = qp0 + 8;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float o[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // p = 2^(s sl2 - m sl2) from the unscaled scores s and their running
  // max m: exp((s - m) scale) with the scale folded into one fma
  const float sl2 = scale * 1.4426950408889634f;

  for (int it = 0; it < ntile; ++it) {
    if (it % 2 == 0) {
      tc::cp_async_wait<0>();
      __syncthreads();  // pair it / 2 (and q) landed; every warp is done with the pair before
      load_pair(it / 2 + 1);
      tc::cp_async_commit();
    }
    const int j0 = it * kTcKV;
    if (active && j0 <= wlast) {
      const bf16* ks = kvs + (it % kRing) * kStageB;
      const bf16* vs = ks + kTcKV * kBLd;
      // s = q k^T over the tile: 16 rows x 64 positions, 8 accumulator tiles
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < CA_HD / 16; ++kk) {
        uint32_t fa[4];
        tc::load_a16(fa, qs + wr0 * kBLd + kk * 16, kBLd);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          // B(d, j) = k[j][d] for positions 8n .. 8n + 15: the k rows as
          // they are (matrices: rows 0-7 then 8-15, each d 0-7 then 8-15)
          uint32_t r[4];
          tc::ldsm_x4(r, ks + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * kBLd + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          tc::mma_bf16(s[n], fa, b0);
          tc::mma_bf16(s[n + 1], fa, b1);
        }
      }
      // mask and the online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
      const bool whole = j0 + kTcKV - 1 <= wfull && (!PERLANE || j0 >= min_pos);
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (!whole) {
            const int p = j0 + n * 8 + 2 * t + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            if constexpr (PERLANE)
              ok = p < cap && ((p <= qp && p >= min_pos) || p == qp);
            else
              ok = p < cap && p <= qp;
          }
          if (!ok) s[n][e] = kNeg;
          if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
          else mx1 = fmaxf(mx1, s[n][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = ex2((m0 - n0) * sl2), c1 = ex2((m1 - n1) * sl2);
      const float mb0 = n0 * sl2, mb1 = n1 * sl2;
      float sum0 = 0.f, sum1 = 0.f;
      if (whole) {  // no masked entry
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pr = ex2(fmaf(s[n][e], sl2, -(e < 2 ? mb0 : mb1)));
            s[n][e] = pr;  // unrounded: the row sum adds these
            if (e < 2) sum0 += pr;
            else sum1 += pr;
          }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pr = s[n][e] > 0.5f * kNeg
                                 ? ex2(fmaf(s[n][e], sl2, -(e < 2 ? mb0 : mb1)))
                                 : 0.f;
            s[n][e] = pr;
            if (e < 2) sum0 += pr;
            else sum1 += pr;
          }
      }
      // l holds this lane's share of the row sum (its quad's shares are
      // added at the end: the rescale is the same for the whole quad)
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      m0 = n0;
      m1 = n1;
      if (c0 != 1.f || c1 != 1.f) {  // a max that did not move rescales by exactly 1
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          o[n][0] *= c0, o[n][1] *= c0;
          o[n][2] *= c1, o[n][3] *= c1;
        }
      }
      // o += p v, p rounded to bf16: k step kk covers positions 16kk ..
      // 16kk + 15, accumulator tiles 2kk and 2kk + 1 as they are
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t fa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < kNB; n += 2) {
          uint32_t b0[2], b1[2];
          tc::load_b16x2(b0, b1, vs + kk * 16 * kBLd + n * 8, kBLd);
          tc::mma_bf16(o[n], fa, b0);
          tc::mma_bf16(o[n + 1], fa, b1);
        }
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy outlives the block (the ring's last groups are empty)

  if (!active) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  bf16* orow = out + ((size_t)row * K + q0) * CA_HD;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    const int d = n * 8 + 2 * t, r0 = wr0 + g, r1 = r0 + 8;
    if (r0 < nq) fs::store2(orow + (size_t)r0 * CA_HD + d, o[n][0] * i0, o[n][1] * i0);
    if (r1 < nq) fs::store2(orow + (size_t)r1 * CA_HD + d, o[n][2] * i1, o[n][3] * i1);
  }
}
#define CA_TC_BODY tc_body_bf16
#endif

// one start for every row, no floor
__global__ void __launch_bounds__(kThreads)
    shared_head_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, const int* __restrict__ start,
                       E* __restrict__ out, int K, int cap, float scale) {
  CA_TC_BODY<false>(q, k, v, start, out, K, cap, 1, 0, scale);
}

// per-lane starts and the min_pos floor; two blocks an SM (the mask's
// extra registers would otherwise leave one)
__global__ void __launch_bounds__(kThreads, 2)
    perlane_kernel(const E* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v, const int* __restrict__ start,
                   E* __restrict__ out, int K, int cap, int rows_per_lane, int min_pos,
                   float scale) {
  CA_TC_BODY<true>(q, k, v, start, out, K, cap, rows_per_lane, min_pos, scale);
}

// ---- K = 1, the per-lane form: a split over the cache on the FMA pipe ----

constexpr int kSplitT = 128;                // threads, and positions per tile
constexpr int kHd4 = (CA_HD + 3) / 4 * 4;   // head dim rounded up to a float4
constexpr int kSLd = kHd4 + 4;              // row stride of the k and v tiles
constexpr int kNC4 = kHd4 / 4;              // float4 columns of a row
constexpr int kGrp = kSplitT / kNC4;        // position groups of the p v sum
constexpr int kPad4 = kHd4 - CA_HD;
constexpr int kPad4Div = kPad4 > 0 ? kPad4 : 1;
// blocks that fill the card: at fewer rows the cache is split
constexpr int kFillBlocks = 132 * 8;

#ifndef FS_BF16
constexpr int split_smem_floats() { return 2 * kSplitT * kSLd + kHd4 + kSplitT + 8 + kGrp * kHd4; }
constexpr size_t split_smem_bytes() { return sizeof(float) * split_smem_floats(); }
#endif

// the splits of each row's cache at R rows: rows alone when they fill the
// card, else about kFillBlocks / R splits of whole tiles
inline int split_count(int R, int cap, int* per_tiles) {
  const int tiles = (cap + kSplitT - 1) / kSplitT;
  int n = R >= kFillBlocks ? 1 : (kFillBlocks + R - 1) / R;
  if (n > tiles) n = tiles;
  *per_tiles = (tiles + n - 1) / n;
  return (tiles + *per_tiles - 1) / *per_tiles;
}

#ifndef FS_BF16
// q, out (R, 1, CA_HD); k, v (R, cap, CA_HD).  Block (row, z) takes the
// positions [z per kSplitT, (z + 1) per kSplitT) up to the row's last
// readable one.  nsplit == 1: out = acc / sum; else part[row][z] = (max,
// sum, acc[CA_HD]).
__global__ void __launch_bounds__(kSplitT)
    perlane_split_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const int* __restrict__ start,
                         E* __restrict__ out, float* __restrict__ part, int cap,
                         int rows_per_lane, int min_pos, float scale, int per, int nsplit) {
  extern __shared__ __align__(16) float ssm[];
  float* ks = ssm;                     // (kSplitT, kSLd)
  float* vs = ks + kSplitT * kSLd;     // (kSplitT, kSLd)
  float* qs = vs + kSplitT * kSLd;     // (kHd4)
  float* ps = qs + kHd4;               // (kSplitT) the tile's probabilities
  float* wred = ps + kSplitT;          // (8) the warps' max, then sum
  float* racc = wred + 8;              // (kGrp, kHd4) the groups' accumulators

  const int row = blockIdx.x, z = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int qpos = start[row / rows_per_lane];
  const int j_begin = z * per * kSplitT;
  // positions [j_begin, j_end) are this split's, every one <= qpos and < cap
  const int j_end = min((z + 1) * per * kSplitT, min(qpos, cap - 1) + 1);
  const int c = tid % kNC4, grp = tid / kNC4;

  float m = kNeg, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j_begin < j_end) {
    const E* kr = k + (size_t)row * cap * CA_HD;
    const E* vr = v + (size_t)row * cap * CA_HD;
    if constexpr (kPad4 > 0) {  // the padded columns are never copied: zero them once
      for (int idx = tid; idx < 2 * kSplitT * kPad4; idx += kSplitT)
        ssm[(idx / kPad4Div) * kSLd + CA_HD + idx % kPad4Div] = 0.f;
    }
    for (int d = tid; d < kHd4; d += kSplitT) qs[d] = d < CA_HD ? fs::f32(q[(size_t)row * CA_HD + d]) : 0.f;
    for (int j0 = j_begin; j0 < j_end; j0 += kSplitT) {
      const int nv = min(kSplitT, j_end - j0);
      __syncthreads();  // the previous tile's ks, vs, ps and wred are consumed
      load_rows<kSLd, kSplitT>(ks, kr + (size_t)j0 * CA_HD, kSplitT, nv);
      load_rows<kSLd, kSplitT>(vs, vr + (size_t)j0 * CA_HD, kSplitT, nv);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      // the score of position j0 + tid
      const int p = j0 + tid;
      float s = 0.f;
#pragma unroll
      for (int cc = 0; cc < kNC4; ++cc) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + tid * kSLd + 4 * cc);
        const float4 qq = *reinterpret_cast<const float4*>(qs + 4 * cc);
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
        s = fmaf(qq.z, kk.z, s);
        s = fmaf(qq.w, kk.w, s);
      }
      const bool ok = tid < nv && (p >= min_pos || p == qpos);
      s = ok ? s * scale : kNeg;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) wred[warp] = mx;
      __syncthreads();
      const float m_new = fmaxf(m, fmaxf(fmaxf(wred[0], wred[1]), fmaxf(wred[2], wred[3])));
      const float corr = expf(m - m_new);
      const float pr = ok ? expf(s - m_new) : 0.f;
      ps[tid] = pr;
      const float sum = fs::warp_sum(pr);
      if (lane == 0) wred[4 + warp] = sum;
      __syncthreads();
      l = l * corr + (((wred[4] + wred[5]) + wred[6]) + wred[7]);
      m = m_new;
      acc = make_float4(acc.x * corr, acc.y * corr, acc.z * corr, acc.w * corr);
      if (grp < kGrp) {
        for (int j = grp; j < nv; j += kGrp) {
          const float pj = fs::rnd<E>(ps[j]);
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * kSLd + 4 * c);
          acc.x = fmaf(pj, vv.x, acc.x);
          acc.y = fmaf(pj, vv.y, acc.y);
          acc.z = fmaf(pj, vv.z, acc.z);
          acc.w = fmaf(pj, vv.w, acc.w);
        }
      }
    }
  }
  // the groups' accumulators added in the order of the group
  if (grp < kGrp) *reinterpret_cast<float4*>(racc + grp * kHd4 + 4 * c) = acc;
  __syncthreads();
  for (int d = tid; d < CA_HD; d += kSplitT) {
    float o = 0.f;
    for (int gi = 0; gi < kGrp; ++gi) o += racc[gi * kHd4 + d];
    if (nsplit == 1) {
      out[(size_t)row * CA_HD + d] = fs::As<E>::from(o / l);
    } else {
      float* pz = part + ((size_t)row * nsplit + z) * (CA_HD + 2);
      pz[2 + d] = o;
      if (d == 0) pz[0] = m, pz[1] = l;
    }
  }
}

#else
// The bf16 form: perlane_split_kernel's blocks, splits, tiles and online
// softmax (kernel_tiling's plan is the float32 form's), with its tiles kept
// in bf16.  The float32 form copies a tile and waits for it before scoring
// it; here each tile of kSplitT positions is copied as bf16 rows (k, then v,
// row stride kBLd: eight threads' 16-byte reads of eight rows hit 32 banks)
// by 16-byte cp.async into a ring of kSRing stages, so kSRing - 1 tiles'
// copies are in flight while one is scored, and widened to float32 in
// registers.  p is rounded to bf16 before it multiplies v (the sum adds it
// unrounded); out is rounded to bf16.
constexpr int kSRing = 3;
constexpr int kSStage = 2 * kSplitT * kBLd;  // bf16 elements of a stage
constexpr size_t split_ring_bytes() { return sizeof(bf16) * kSRing * kSStage; }
constexpr size_t split_smem_bytes() {
  return split_ring_bytes() + sizeof(float) * (CA_HD + kSplitT + 8);
}
static_assert(sizeof(float) * kGrp * CA_HD <= split_ring_bytes(), "the groups' sums fit the ring");

__global__ void __launch_bounds__(kSplitT)
    perlane_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ start,
                         bf16* __restrict__ out, float* __restrict__ part, int cap,
                         int rows_per_lane, int min_pos, float scale, int per, int nsplit) {
  extern __shared__ __align__(16) bf16 rsm[];
  bf16* ring = rsm;                                                // kSRing x (k, v) x (kSplitT, kBLd)
  float* qs = reinterpret_cast<float*>(rsm + kSRing * kSStage);    // (CA_HD)
  float* ps = qs + CA_HD;                                          // (kSplitT) the tile's probabilities
  float* wred = ps + kSplitT;                                      // (8) the warps' max, then sum
  float* racc = reinterpret_cast<float*>(rsm);                     // (kGrp, CA_HD) once the ring is done

  const int row = blockIdx.x, z = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int qpos = start[row / rows_per_lane];
  const int j_begin = z * per * kSplitT;
  // positions [j_begin, j_end) are this split's, every one <= qpos and < cap
  const int j_end = min((z + 1) * per * kSplitT, min(qpos, cap - 1) + 1);
  const int c = tid % kNC4, grp = tid / kNC4;

  float m = kNeg, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j_begin < j_end) {
    const bf16* kr = k + (size_t)row * cap * CA_HD;
    const bf16* vr = v + (size_t)row * cap * CA_HD;
    const int ntile = (j_end - j_begin + kSplitT - 1) / kSplitT;
    auto load = [&](int it) {  // tile it into stage it % kSRing; rows past j_end are zero
      bf16* ks = ring + (it % kSRing) * kSStage;
      const int j0 = j_begin + it * kSplitT;
      load_rows_b16<kSplitT>(ks, kr + (size_t)j0 * CA_HD, kSplitT, j_end - j0);
      load_rows_b16<kSplitT>(ks + kSplitT * kBLd, vr + (size_t)j0 * CA_HD, kSplitT, j_end - j0);
    };
#pragma unroll
    for (int s = 0; s < kSRing - 1; ++s) {
      if (s < ntile) load(s);
      tc::cp_async_commit();
    }
    for (int d = tid; d < CA_HD; d += kSplitT) qs[d] = fs::f32(q[(size_t)row * CA_HD + d]);
    for (int it = 0; it < ntile; ++it) {
      const int j0 = j_begin + it * kSplitT, nv = min(kSplitT, j_end - j0);
      tc::cp_async_wait<kSRing - 2>();
      __syncthreads();  // tile it (and qs) landed; every thread is done with tile it - 1, ps, wred
      if (it + kSRing - 1 < ntile) load(it + kSRing - 1);  // into tile it - 1's stage
      tc::cp_async_commit();
      const bf16* ks = ring + (it % kSRing) * kSStage;
      const bf16* vs = ks + kSplitT * kBLd;
      // the score of position j0 + tid, its k row widened in registers
      const int p = j0 + tid;
      float s = 0.f;
      const uint4* kk = reinterpret_cast<const uint4*>(ks + tid * kBLd);
#pragma unroll
      for (int cc = 0; cc < CA_HD / 8; ++cc) {
        const uint4 u = kk[cc];
        const float4 ka = b16x4(make_uint2(u.x, u.y)), kb = b16x4(make_uint2(u.z, u.w));
        const float4 qa = *reinterpret_cast<const float4*>(qs + 8 * cc);
        const float4 qb = *reinterpret_cast<const float4*>(qs + 8 * cc + 4);
        s = fmaf(qa.x, ka.x, s);
        s = fmaf(qa.y, ka.y, s);
        s = fmaf(qa.z, ka.z, s);
        s = fmaf(qa.w, ka.w, s);
        s = fmaf(qb.x, kb.x, s);
        s = fmaf(qb.y, kb.y, s);
        s = fmaf(qb.z, kb.z, s);
        s = fmaf(qb.w, kb.w, s);
      }
      const bool ok = tid < nv && (p >= min_pos || p == qpos);
      s = ok ? s * scale : kNeg;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) wred[warp] = mx;
      __syncthreads();
      const float m_new = fmaxf(m, fmaxf(fmaxf(wred[0], wred[1]), fmaxf(wred[2], wred[3])));
      const float corr = expf(m - m_new);
      const float pr = ok ? expf(s - m_new) : 0.f;
      ps[tid] = pr;
      const float sum = fs::warp_sum(pr);
      if (lane == 0) wred[4 + warp] = sum;
      __syncthreads();
      l = l * corr + (((wred[4] + wred[5]) + wred[6]) + wred[7]);
      m = m_new;
      acc = make_float4(acc.x * corr, acc.y * corr, acc.z * corr, acc.w * corr);
      if (grp < kGrp) {
        for (int j = grp; j < nv; j += kGrp) {
          const float pj = fs::rnd<bf16>(ps[j]);
          const float4 vv = b16x4(*reinterpret_cast<const uint2*>(vs + j * kBLd + 4 * c));
          acc.x = fmaf(pj, vv.x, acc.x);
          acc.y = fmaf(pj, vv.y, acc.y);
          acc.z = fmaf(pj, vv.z, acc.z);
          acc.w = fmaf(pj, vv.w, acc.w);
        }
      }
    }
    tc::cp_async_wait<0>();
  }
  __syncthreads();  // every thread is done with the ring, which racc takes over
  // the groups' accumulators added in the order of the group
  if (grp < kGrp) *reinterpret_cast<float4*>(racc + grp * CA_HD + 4 * c) = acc;
  __syncthreads();
  for (int d = tid; d < CA_HD; d += kSplitT) {
    float o = 0.f;
    for (int gi = 0; gi < kGrp; ++gi) o += racc[gi * CA_HD + d];
    if (nsplit == 1) {
      out[(size_t)row * CA_HD + d] = __float2bfloat16_rn(o / l);
    } else {
      float* pz = part + ((size_t)row * nsplit + z) * (CA_HD + 2);
      pz[2 + d] = o;
      if (d == 0) pz[0] = m, pz[1] = l;
    }
  }
}
#endif

// out[row][d] = sum_z w_z acc_z[d] / sum_z w_z sum_z, w_z = exp(max_z - the
// row's max), the splits added in the order of z
__global__ void combine_kernel(const float* __restrict__ part, E* __restrict__ out, int R,
                               int nsplit) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)R * CA_HD) return;
  const int row = (int)(e / CA_HD), d = (int)(e % CA_HD);
  const float* p = part + (size_t)row * nsplit * (CA_HD + 2);
  float mx = kNeg;
  for (int z = 0; z < nsplit; ++z) mx = fmaxf(mx, p[z * (CA_HD + 2)]);
  float num = 0.f, den = 0.f;
  for (int z = 0; z < nsplit; ++z) {
    const float* pz = p + z * (CA_HD + 2);
    const float w = expf(pz[0] - mx);
    den = fmaf(w, pz[1], den);
    num = fmaf(w, pz[2 + d], num);
  }
  out[e] = fs::As<E>::from(num / den);
}

inline float attention_scale() {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(CA_HD)));
}

inline int launch_tc(bool perlane, const E* q, const E* k, const E* v, const int* start,
                     E* out, int R, int K, int cap, int rows_per_lane, int min_pos,
                     cudaStream_t stream) {
  const size_t smem = tc_smem_bytes();
  const void* fn = perlane ? reinterpret_cast<const void*>(perlane_kernel)
                           : reinterpret_cast<const void*>(shared_head_kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, (K + kTcQ - 1) / kTcQ);
  if (perlane)
    perlane_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, start, out, K, cap,
                                                     rows_per_lane, min_pos, attention_scale());
  else
    shared_head_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, start, out, K, cap,
                                                         attention_scale());
  return cudaGetLastError();
}

inline int launch_split(const E* q, const E* k, const E* v, const int* start, E* out,
                        float* part, int R, int cap, int rows_per_lane, int min_pos,
                        cudaStream_t stream) {
  int per;
  const int nsplit = split_count(R, cap, &per);
  if (nsplit > 1 && !part) return cudaErrorInvalidValue;
  const size_t smem = split_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(perlane_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  perlane_split_kernel<<<dim3(R, nsplit), kSplitT, smem, stream>>>(
      q, k, v, start, out, part, cap, rows_per_lane, min_pos, attention_scale(), per, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const long long total = (long long)R * CA_HD;
  combine_kernel<<<(int)((total + 255) / 256), 256, 0, stream>>>(part, out, R, nsplit);
  return cudaGetLastError();
}

}  // namespace ca

// Floats of scratch cached_attention_perlane_launch needs at (R, K, cap):
// the splits' partials at K = 1 when the rows alone do not fill the card,
// else 0.
extern "C" size_t cached_attention_perlane_scratch(int R, int K, int cap) {
  int per;
  const int nsplit = ca::split_count(R, cap, &per);
  return K == 1 && nsplit > 1 ? (size_t)R * nsplit * (CA_HD + 2) : 0;
}

// Per-lane write heads: start (R / rows_per_lane) int32 on the device; part
// the scratch of cached_attention_perlane_scratch floats (null when 0), in
// float32 whatever E is.  q, k, v, out of the element type E (bf16 with
// FS_BF16).  Returns cudaGetLastError().
extern "C" int cached_attention_perlane_launch(const E* q, const E* k, const E* v,
                                               const int* start, E* out, float* part,
                                               int R, int K, int cap, int rows_per_lane,
                                               int min_pos, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 1) return ca::launch_split(q, k, v, start, out, part, R, cap, rows_per_lane, min_pos, st);
  return ca::launch_tc(true, q, k, v, start, out, R, K, cap, rows_per_lane, min_pos, st);
}

// One write head for every row: start (1) int32 on the device; no floor.
extern "C" int cached_attention_launch(const E* q, const E* k, const E* v,
                                       const int* start, E* out, int R, int K,
                                       int cap, void* stream) {
  return ca::launch_tc(false, q, k, v, start, out, R, K, cap, 1, 0,
                       static_cast<cudaStream_t>(stream));
}
