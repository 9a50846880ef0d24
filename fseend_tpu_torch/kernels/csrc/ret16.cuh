// The bf16 chunkwise retention core and retention layer at head dims 64 on
// Hopper: chunk_retention.cu (B5) and retention_layer.cu (B4) built with
// FS_BF16 and CR_DK = CR_DV = 64 run this file; the layer also needs D a
// multiple of 128 (the out projection's wgmma tile).  Every other bf16
// width keeps chunk_retention_tc.cuh's bf16 form and tc_bf16.cuh's
// products (retention_layer.cu says which), and every float32 build is
// untouched by this file.
//
// Replaces, in bf16: fseend_tpu/kernels/retention_pallas.py
// (_forward_stateful and its _kernel) and
// fseend_tpu/kernels/retention_layer_pallas.py (_forward and its _kernel).
//
// The arithmetic, with the TPU kernels' rounding points (only float32
// summation orders differ):
//   q | k | v | g = x Wqkvg + b, each rounded; k rounded, times the rounded
//     dk^-1/2, rounded again (retention_layer_pallas.py:66-80);
//   S = (q k^T) * mask, a bf16 product into float32 (retention_pallas.py:77,
//     retention_layer_pallas.py:107); inner = max(sum_j |S_ij|, 1);
//   out = (S V + idec (q KV)) / max(inner, c), rounded (retention_pallas.py
//     :81-95): S V, q KV and the state update K^T (V last_row) take a
//     float32 operand, so that operand goes to the tensor cores as three
//     bf16 terms hi + mid + lo (d16::split3, float32's own 2^-24), small
//     terms first, against the exact bf16 other operand: S against v; KV
//     against q (KV_0, read from the bf16 state, is one term); last_row K
//     against v;
//   the state carried in float32 and stored in bf16 (retention_pallas.py
//     :57-59, 101-112);
//   B4 only: the group norm (eps 1e-6, non-affine) of the rounded output,
//     rounded; silu(g) times it, rounded; y = that Wo + bo, rounded
//     (retention_layer_pallas.py:123-150).
//
// What bounds it on the card.  B4 at the decoder's call (163,840 rows, D
// 256): the projections' 10 M D^2 operations at the bf16 peak, and the
// core's bytes (q, k, v and g read, the gated value written: 0.42 GB);
// B5: the core's bytes.  Each product of the core is a few 16 x 64 x 64
// passes per row, so what matters there is that no pass runs in float32
// or TF32 and that nothing is read twice.
//
// What the design does about it:
//   wg16 (wg16.cuh)  the q | k | v | g product (K = D, N = 4D) and the out
//                    projection (K = F, N = D) on wgmma, the bias, the
//                    roundings and the k scale in the epilogue (kRound),
//                    from the weights transposed into the workspace each
//                    call (transpose16: 0.6 MB at D 256);
//   out16_kernel     one block of 8 warps per (row, chunk, 128 queries):
//                    q, the gate (B4) and KV_n's terms stay in shared
//                    memory; k/v tiles of 64 frames come by 16-byte
//                    cp.async into two stages, the next tile's copies in
//                    flight while one is multiplied, and are read with
//                    ldmatrix; the scores stay in registers, are masked
//                    there and split into their three terms there for
//                    S V (bf16 mma.sync, m16n8k16).  At T = L (every
//                    main-path call of B4 and B5's blockwise calls) the
//                    block that holds the chunk's last queries, which
//                    reads every k/v tile of the chunk anyway, also sums
//                    U = (last_row K)^T V from them and writes the new
//                    state: one launch reads k and v once.  The output
//                    (B4: the gated value) is staged through q's place
//                    and written in 16-byte chunks.  Warp w takes query
//                    rows 16 w' with w' = w for w < 4 and 11 - w after, so
//                    that the two warps that share an SM sub-partition
//                    (w, w + 4) take causal work 9 tiles' worth together;
//   sum16_kernel     T > L: one block per (row, chunk) sums its U_m the
//                    same way into float32 scratch;
//   scan16_kernel    T > L: KV_n = KV_{n-1} gamma^L + U_{n-1} and its
//                    scale in chunk order, the state in registers, each
//                    column's sum of |KV| from four threads' shares (the
//                    old scan's 64 threads each summing a column of 64
//                    took twice as long); then out16_kernel reads KV_n as
//                    three terms.
// The out projection is not fused into out16's epilogue: its wgmma wants
// 128 rows by the whole F-deep sum, i.e. all four heads of 128 frames in
// one block, where the core's blocks are per head; the gated value's round
// trip is 84 MB each way at the decoder's call.
// No atomics; every sum has a fixed order: two calls give the same bits.
// The incoming state is never written.
#pragma once

#include "chunk_retention_tc.cuh"
#include "wg16.cuh"

namespace r16 {

using fs::bf16;
using Args = crt::ArgsE<bf16>;

constexpr int DK = 64, DV = 64;   // the head dims this file takes
constexpr int kT = 64;            // frames of a k/v tile
constexpr int kQB = 128;          // query rows of a block: 8 warps x 16
constexpr int kThreads = 256;
constexpr int kLd = 72;           // bf16 row stride of every tile: ldmatrix's rows hit 32 banks
constexpr int kTileE = kT * kLd;  // elements of a 64-row tile
constexpr int kQE = kQB * kLd;    // the q rows (and the output, staged in their place)
constexpr int kKVE = DK * kLd;    // one term of KV
static_assert(crt::kThreads == kThreads, "crt's tile loaders stride by the block's threads");

// out16's dynamic shared memory: q, two stages of (k, v) tiles, KV's three
// terms and, with FINISH, the gate rows
constexpr int out_smem_bytes(bool finish) {
  return (int)sizeof(bf16) * (kQE + 4 * kTileE + 3 * kKVE + (finish ? kQE : 0));
}
constexpr int kSumBytes = (int)sizeof(bf16) * 4 * kTileE;

__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// the k and v rows [j0, j0 + 64) of a chunk into a stage (k tile, then v
// tile), rows at or past L zero
__device__ __forceinline__ void load_kv(bf16* stage, const bf16* kn, size_t ldk, const bf16* vn,
                                        size_t ldv, int j0, int L) {
  crt::load_rows_b16<DK, kLd>(stage, kn + (size_t)j0 * ldk, ldk, kT, L - j0);
  crt::load_rows_b16<DV, kLd>(stage + kTileE, vn + (size_t)j0 * ldv, ldv, kT, L - j0);
}

// last_row(f) = gamma^(L-1-f) / svl (svl = sv[L-1]) over the 64 frames of
// tile jt into lr (0 past L), by the block's first 64 threads; published by
// the caller's next barrier
__device__ __forceinline__ void last_row(float* lr, int jt, int L, float lg, float svl) {
  const int f = jt * kT + threadIdx.x;
  if (threadIdx.x < kT) lr[threadIdx.x] = f < L ? expf(lg * (L - 1 - f)) / svl : 0.f;
}

// u += (last_row K)^T V over the 64 frames of the stage's tiles (lr: their
// last_row, 0 past L): the warp's 16 x 32 share of U (rows 16 (w % 4) ..,
// columns 32 (w / 4) ..), last_row K as three bf16 terms; nk 16-frame
// groups (those that start before L)
__device__ __forceinline__ void sum_tile(float (&u)[4][4], const bf16* Ks, const bf16* Vs,
                                         const float* lr, int nk) {
  const int w = threadIdx.x >> 5, t = tc::lane_t();
  const int mt = w & 3, nh = w >> 2;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    if (kk >= nk) break;
    uint32_t fa[4];  // A (16 state rows x 16 frames) = K^T: fa[0..1] frames f, f + 1; fa[2..3] f + 8, f + 9
    tc::load_a16_t(fa, Ks + kk * 16 * kLd + 16 * mt, kLd);
    const float2 w0 = *reinterpret_cast<const float2*>(lr + 16 * kk + 2 * t);
    const float2 w1 = *reinterpret_cast<const float2*>(lr + 16 * kk + 2 * t + 8);
    uint32_t ah[4], am[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 x = unpack(fa[r]), wr = r < 2 ? w0 : w1;
      d16::split3(x.x * wr.x, x.y * wr.y, ah[r], am[r], al[r]);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b0[2], b1[2];
      tc::load_b16x2(b0, b1, Vs + kk * 16 * kLd + 32 * nh + 16 * np, kLd);
      tc::mma_bf16(u[2 * np], al, b0);
      tc::mma_bf16(u[2 * np + 1], al, b1);
      tc::mma_bf16(u[2 * np], am, b0);
      tc::mma_bf16(u[2 * np + 1], am, b1);
      tc::mma_bf16(u[2 * np], ah, b0);
      tc::mma_bf16(u[2 * np + 1], ah, b1);
    }
  }
}

// the warp's share of U to dst (DK x DV, row-major, float32)
__device__ __forceinline__ void put_u(const float (&u)[4][4], float* dst) {
  const int w = threadIdx.x >> 5, g = tc::lane_g(), t = tc::lane_t();
  const int m0 = 16 * (w & 3), c0 = 32 * (w >> 2);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(dst + (m0 + g + 8 * hh) * DV + c0 + 8 * n + 2 * t) =
          make_float2(u[n][2 * hh], u[n][2 * hh + 1]);
}

// ---- T > L: each chunk's summary to scratch; the scan ----

// Scratch (float32): U_m at (bh N + m) DK DV, which the scan overwrites
// with KV_{m+1}, where out16 reads it; then the scales c_{m+1} at (bh N +
// m) after all of them.
__global__ void __launch_bounds__(kThreads) sum16_kernel(Args a, int N) {
  extern __shared__ __align__(16) bf16 ssm[];
  __shared__ __align__(8) float lr[2][kT];
  const int n = blockIdx.x % N, bh = blockIdx.x / N;
  const int b = bh / a.H, h = bh % a.H, L = a.L;
  const float lg = logf(a.gamma[bh % a.gmod]);
  const size_t row0 = (size_t)b * a.T + (size_t)n * L;
  const bf16* kn = a.k + row0 * a.ldk + h * DK;
  const bf16* vn = a.v + row0 * a.ldv + h * DV;
  const int ntile = (L + kT - 1) / kT;
  load_kv(ssm, kn, a.ldk, vn, a.ldv, 0, L);
  tc::cp_async_commit();
  const float svl = sqrtf(crt::decay_sum(lg, L));
  float u[4][4] = {};
  for (int jt = 0; jt < ntile; ++jt) {
    last_row(lr[jt & 1], jt, L, lg, svl);
    if (jt + 1 < ntile) {
      load_kv(ssm + ((jt + 1) & 1) * 2 * kTileE, kn, a.ldk, vn, a.ldv, (jt + 1) * kT, L);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile jt and its last_row have landed
    const bf16* Ks = ssm + (jt & 1) * 2 * kTileE;
    sum_tile(u, Ks, Ks + kTileE, lr[jt & 1], (L - jt * kT + 15) / 16);
    __syncthreads();  // every warp is done with the stage before it is refilled
  }
  put_u(u, a.kvbuf + ((size_t)bh * N + n) * DK * DV);
}

// KV_{m+1} = KV_m gamma^L + U_m and its scale, in chunk order, one block
// per row: a thread holds 16 elements of the state, all in column tid % DV,
// and its share of that column's sum of |KV|; the four shares of a column
// are added in order.  KV_{m+1} goes over U_m (m + 1 < N) or, rounded, to
// the new state.
__global__ void __launch_bounds__(kThreads) scan16_kernel(Args a, int N) {
  constexpr int kE = DK * DV, kPer = kE / kThreads, kQ = kThreads / DV;
  static_assert(kThreads % DV == 0, "a thread's elements in one column");
  __shared__ float colp[kQ][DV];
  const int bh = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float cd = expf(logf(a.gamma[bh % a.gmod]) * a.L);
  float* buf = a.kvbuf + (size_t)bh * N * kE;
  float run[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) run[r] = fs::f32(a.kv0[(size_t)bh * kE + tid + r * kThreads]);
  for (int m = 0; m < N; ++m) {
    float* um = buf + (size_t)m * kE;
    float cs = 0.f;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid + r * kThreads;
      run[r] = fmaf(run[r], cd, um[i]);
      cs += fabsf(run[r]);
      if (m + 1 < N)
        um[i] = run[r];
      else
        a.kvf[(size_t)bh * kE + i] = fs::As<bf16>::from(run[r]);
    }
    colp[tid / DV][tid % DV] = cs;
    __syncthreads();
    if (warp == 0) {
      float c = 1.f;
      for (int v = lane; v < DV; v += 32) {
        float sm = colp[0][v];
#pragma unroll
        for (int q = 1; q < kQ; ++q) sm += colp[q][v];
        c = fmaxf(c, sm);
      }
#pragma unroll
      for (int of = 16; of > 0; of >>= 1) c = fmaxf(c, __shfl_xor_sync(crt::kFull, c, of));
      if (lane == 0) {
        if (m + 1 < N)
          a.cbuf[(size_t)bh * N + m] = c;
        else
          a.sf[bh] = fs::As<bf16>::from(c);
      }
    }
    __syncthreads();  // colp is rewritten by the next step
  }
}

// ---- the output of 128 queries of one chunk (and at T = L the new state) ----

template <bool FINISH>
__global__ void __launch_bounds__(kThreads, 2)
out16_kernel(Args a, const bf16* __restrict__ gt, int ldg, int nqb, int N) {
  extern __shared__ __align__(16) bf16 osm[];
  __shared__ float rsv[kQB], idec[kQB];
  __shared__ __align__(8) float lr[2][kT];  // state: last_row over each stage's frames
  __shared__ float colp[4][DV];             // state: the column sums of |KV| by 16-row group
  bf16* Qs = osm;               // (kQB, kLd); the output at the end
  bf16* St = Qs + kQE;          // 2 stages x (k tile, v tile)
  bf16* KVs = St + 4 * kTileE;  // KV_n [k][v]: hi, mid, lo
  bf16* Gs = KVs + 3 * kKVE;    // FINISH: the gate rows

  int idx = blockIdx.x;
  const int qb = nqb - 1 - idx % nqb;  // the longest blocks first
  idx /= nqb;
  const int n = idx % N, bh = idx / N;
  const int b = bh / a.H, h = bh % a.H, L = a.L, i0 = qb * kQB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp < 4 ? warp : 11 - warp;  // the warp's 16-row group of the block
  const int r0 = i0 + 16 * rg;                 // its first query (chunk place)
  const float lg = logf(a.gamma[bh % a.gmod]);
  const size_t row0 = (size_t)b * a.T + (size_t)n * L;
  const bf16* kn = a.k + row0 * a.ldk + h * DK;
  const bf16* vn = a.v + row0 * a.ldv + h * DV;
  const int ntile = (L + kT - 1) / kT;
  const int jlast = min(ntile - 1, (i0 + kQB - 1) / kT);  // the last k/v tile of the block's rows
  const bool state = N == 1 && qb == nqb - 1;  // T = L: this block also writes the new state
  const bool exact = n == 0;                   // KV_0 is bf16: one term
  const float cs = n == 0 ? fs::f32(a.s0[bh]) : a.cbuf[(size_t)bh * N + n - 1];

  crt::load_rows_b16<DK, kLd>(Qs, a.q + (row0 + i0) * a.ldq + h * DK, a.ldq, kQB, L - i0);
  if constexpr (FINISH)
    crt::load_rows_b16<DV, kLd>(Gs, gt + (row0 + i0) * ldg + h * DV, ldg, kQB, L - i0);
  if (exact) crt::load_rows_b16<DV, kLd>(KVs, a.kv0 + (size_t)bh * DK * DV, DV, DK, DK);
  load_kv(St, kn, a.ldk, vn, a.ldv, 0, L);
  tc::cp_async_commit();
  if (!exact) {  // KV_n from the scan, as three terms
    const float* src = a.kvbuf + ((size_t)bh * N + n - 1) * DK * DV;
    for (int i = tid; i < DK * DV / 2; i += kThreads) {
      const int k = (2 * i) / DV, v = (2 * i) % DV;
      const float2 x = *reinterpret_cast<const float2*>(src + 2 * i);
      uint32_t hi, mid, lo;
      d16::split3(x.x, x.y, hi, mid, lo);
      *reinterpret_cast<uint32_t*>(KVs + k * kLd + v) = hi;
      *reinterpret_cast<uint32_t*>(KVs + kKVE + k * kLd + v) = mid;
      *reinterpret_cast<uint32_t*>(KVs + 2 * kKVE + k * kLd + v) = lo;
    }
  }
  const float svl = sqrtf(crt::decay_sum(lg, L));  // sv[L-1]
  if (warp < 2) {  // 1 / sv and idec over 64 rows each: a prefix over the chunk
    const int ib = i0 + 64 * warp;
    const float base = crt::decay_sum(lg, ib);
    const float e0 = expf(lg * (ib + 2 * lane)), e1 = expf(lg * (ib + 2 * lane + 1));
    float incl = e0 + e1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(crt::kFull, incl, o);
      if (lane >= o) incl += y;
    }
    float excl = __shfl_up_sync(crt::kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float p0 = base + excl + e0, p1 = p0 + e1;
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
      const int r = 64 * warp + 2 * lane + uu, i = i0 + r;
      const float sv = sqrtf(uu ? p1 : p0);
      rsv[r] = 1.f / sv;
      idec[r] = i < L ? expf(lg * (i + 1)) * svl / sv : 0.f;
    }
  }

  const bool rows = r0 < L;  // the warp has a query of the chunk
  const bf16* Qw = Qs + 16 * rg * kLd;
  const int ia = r0 + g, ib = ia + 8;  // the lane's two queries
  const bool unit = lg == 0.f;         // gamma = 1 (LS-EEND's): no decay to exponentiate
  float o[8][4] = {}, u[4][4] = {};
  float rowabs[2] = {0.f, 0.f};
  float ra = 0.f, rb = 0.f;
  for (int jt = 0; jt <= jlast; ++jt) {
    if (state) last_row(lr[jt & 1], jt, L, lg, svl);
    if (jt < jlast) {
      load_kv(St + ((jt + 1) & 1) * 2 * kTileE, kn, a.ldk, vn, a.ldv, (jt + 1) * kT, L);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile jt has landed (and at jt = 0 q, KV_n, the rows' decays)
    if (jt == 0 && rows) {  // o = idec (q KV_n), KV_n's terms small first
      for (int term = exact ? 0 : 2; term >= 0; --term) {
        const bf16* kv = KVs + term * kKVE;
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          uint32_t fa[4];
          tc::load_a16(fa, Qw + kk * 16, kLd);
#pragma unroll
          for (int np = 0; np < DV / 16; ++np) {
            uint32_t b0[2], b1[2];
            tc::load_b16x2(b0, b1, kv + kk * 16 * kLd + np * 16, kLd);
            tc::mma_bf16(o[2 * np], fa, b0);
            tc::mma_bf16(o[2 * np + 1], fa, b1);
          }
        }
      }
      const float d0 = idec[16 * rg + g], d1 = idec[16 * rg + g + 8];
#pragma unroll
      for (int c = 0; c < 8; ++c) o[c][0] *= d0, o[c][1] *= d0, o[c][2] *= d1, o[c][3] *= d1;
      ra = rsv[16 * rg + g], rb = rsv[16 * rg + g + 8];
    }
    const bf16* Ks = St + (jt & 1) * 2 * kTileE;
    const bf16* Vs = Ks + kTileE;
    const int j0 = jt * kT;
    if (rows && j0 <= r0 + 15) {
      const int nf = min(4, (r0 + 15 - j0) / 16 + 1);  // 16-frame groups at or before the last query
      float s[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t fa[4];
        tc::load_a16(fa, Qw + kk * 16, kLd);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= nf) break;
          uint32_t b0[2], b1[2];
          d16::load_bt16x2(b0, b1, Ks + np * 16 * kLd + kk * 16, kLd);
          tc::mma_bf16(s[2 * np], fa, b0);
          tc::mma_bf16(s[2 * np + 1], fa, b1);
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 8 * c + 2 * t + (e & 1), i = e < 2 ? ia : ib;
          const float r = e < 2 ? ra : rb;
          const float m = j > i ? 0.f : unit ? r : expf(lg * (i - j)) * r;
          s[c][e] *= m;
          rowabs[e >> 1] += fabsf(s[c][e]);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // o += S V, S as three terms, small first
        if (kk >= nf) break;
        uint32_t ah[4], am[4], al[4];
        d16::split3(s[2 * kk][0], s[2 * kk][1], ah[0], am[0], al[0]);
        d16::split3(s[2 * kk][2], s[2 * kk][3], ah[1], am[1], al[1]);
        d16::split3(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], am[2], al[2]);
        d16::split3(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], am[3], al[3]);
#pragma unroll
        for (int np = 0; np < DV / 16; ++np) {
          uint32_t b0[2], b1[2];
          tc::load_b16x2(b0, b1, Vs + kk * 16 * kLd + np * 16, kLd);
          tc::mma_bf16(o[2 * np], al, b0);
          tc::mma_bf16(o[2 * np + 1], al, b1);
          tc::mma_bf16(o[2 * np], am, b0);
          tc::mma_bf16(o[2 * np + 1], am, b1);
          tc::mma_bf16(o[2 * np], ah, b0);
          tc::mma_bf16(o[2 * np + 1], ah, b1);
        }
      }
    }
    if (state) sum_tile(u, Ks, Vs, lr[jt & 1], (L - j0 + 15) / 16);
    __syncthreads();  // every warp is done with the stage before it is refilled
  }

  if (rows) {  // out = o / max(inner, c), rounded; B4: the norm and the gate
    float all[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sm = rowabs[hh];
      sm += __shfl_xor_sync(crt::kFull, sm, 1);
      sm += __shfl_xor_sync(crt::kFull, sm, 2);
      all[hh] = fmaxf(fmaxf(sm, 1.f), cs);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = fs::rnd<bf16>(o[c][e] / all[e >> 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bf16* row = Qs + (16 * rg + g + 8 * hh) * kLd + 2 * t;
      if constexpr (FINISH) {  // group norm over the head's dv values, eps 1e-6, then the gate
        float mu = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) mu += o[c][2 * hh] + o[c][2 * hh + 1];
        mu += __shfl_xor_sync(crt::kFull, mu, 1);
        mu += __shfl_xor_sync(crt::kFull, mu, 2);
        mu /= DV;
        float var = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float d0 = o[c][2 * hh] - mu, d1 = o[c][2 * hh + 1] - mu;
          var += d0 * d0 + d1 * d1;
        }
        var += __shfl_xor_sync(crt::kFull, var, 1);
        var += __shfl_xor_sync(crt::kFull, var, 2);
        const float rs = rsqrtf(var / DV + 1e-6f);
        const bf16* gr = Gs + (16 * rg + g + 8 * hh) * kLd + 2 * t;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 gv = fs::load2(gr + 8 * c);
          fs::store2(row + 8 * c, d16::silu_rn(gv.x) * fs::rnd<bf16>((o[c][2 * hh] - mu) * rs),
                     d16::silu_rn(gv.y) * fs::rnd<bf16>((o[c][2 * hh + 1] - mu) * rs));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) fs::store2(row + 8 * c, o[c][2 * hh], o[c][2 * hh + 1]);
      }
    }
  }
  __syncthreads();
  bf16* on = a.out + row0 * a.ldo + h * DV;
  for (int i = tid; i < kQB * (DV / 8); i += kThreads) {
    const int r = i / (DV / 8), c = (i % (DV / 8)) * 8;
    if (i0 + r < L)
      *reinterpret_cast<uint4*>(on + (size_t)(i0 + r) * a.ldo + c) =
          *reinterpret_cast<const uint4*>(Qs + r * kLd + c);
  }
  if (!state) return;
  // KV_1 = KV_0 gamma^L + U in the warp's registers, stored bf16; its scale
  // max_v sum_k |KV|, the sums over each warp's 16 rows (pairs of rows in a
  // lane, then the lanes g) added over the four row groups in order
  const float cd = expf(lg * L);
  const int m0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  const size_t kvo = (size_t)bh * DK * DV + (size_t)(m0 + g) * DV + c0 + 2 * t;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t i = kvo + (size_t)8 * hh * DV + 8 * c;
      const float2 k0 = fs::load2(a.kv0 + i);
      const float x0 = fmaf(k0.x, cd, u[c][2 * hh]), x1 = fmaf(k0.y, cd, u[c][2 * hh + 1]);
      fs::store2(a.kvf + i, x0, x1);
      s0 += fabsf(x0), s1 += fabsf(x1);
    }
#pragma unroll
    for (int of = 4; of < 32; of <<= 1) {
      s0 += __shfl_xor_sync(crt::kFull, s0, of);
      s1 += __shfl_xor_sync(crt::kFull, s1, of);
    }
    if (g == 0) colp[warp & 3][c0 + 8 * c + 2 * t] = s0, colp[warp & 3][c0 + 8 * c + 2 * t + 1] = s1;
  }
  __syncthreads();
  if (warp == 0) {
    float m = 1.f;
    for (int v = lane; v < DV; v += 32)
      m = fmaxf(m, ((colp[0][v] + colp[1][v]) + colp[2][v]) + colp[3][v]);
#pragma unroll
    for (int of = 16; of > 0; of >>= 1) m = fmaxf(m, __shfl_xor_sync(crt::kFull, m, of));
    if (lane == 0) a.sf[bh] = fs::As<bf16>::from(m);
  }
}

// the core on `stream` for `rows` (batch, head) rows: out16 alone at T = L;
// sum16, scan16 and out16 otherwise, with a.kvbuf the float32 scratch
// (rows (T/L) (DK DV + 1) floats; a.cbuf is set here).
// FINISH: a.out receives the gated value and gt (row stride ldg) holds the
// gate.  Returns the first CUDA error of the launches.
template <bool FINISH>
inline int core16(Args a, const bf16* gt, int ldg, int rows, cudaStream_t stream) {
  const int N = a.T / a.L, nqb = (a.L + kQB - 1) / kQB;
  cudaError_t err;
  if (N > 1) {
    a.cbuf = a.kvbuf + (size_t)rows * N * DK * DV;
    sum16_kernel<<<rows * N, kThreads, kSumBytes, stream>>>(a, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan16_kernel<<<rows, kThreads, 0, stream>>>(a, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int smem = out_smem_bytes(FINISH);
  err = cudaFuncSetAttribute(out16_kernel<FINISH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  out16_kernel<FINISH><<<rows * N * nqb, kThreads, smem, stream>>>(a, gt, ldg, nqb, N);
  return cudaGetLastError();
}

// The layer (retention_layer.cu's entry point, its arguments): ws holds
// q | k | v | g (M rows of W = 2D + 2F), then the gated value (M, F),
// Wqkvg^T (W, D) and Wo^T (D, F); D % 128 == 0.
inline int layer16(const float* gamma, const bf16* x, const bf16* wqkvg, const bf16* bqkvg,
                   const bf16* wo, const bf16* bo, bf16* ws, float* scratch, bf16* y,
                   const bf16* kv0, const bf16* s0, bf16* kvf, bf16* sf, int B, int T, int L,
                   int H, float kscale, cudaStream_t stream) {
  const int D = H * DK, F = H * DV, W = 2 * D + 2 * F, M = B * T;
  bf16* gated = ws + (size_t)M * W;
  bf16* wt = gated + (size_t)M * F;
  bf16* wot = wt + (size_t)W * D;
  int err = d16::transpose16(wqkvg, wt, 1, D, W, stream);
  if (err != 0 || (err = d16::transpose16(wo, wot, 1, F, D, stream)) != 0) return err;
  d16::Epi16 ep{};
  ep.bias = bqkvg, ep.s_lo = D, ep.s_hi = 2 * D, ep.s = kscale;
  if ((err = d16::wg16<d16::kRound>(x, wt, ws, M, W, D, ep, stream)) != 0) return err;
  Args a{};
  a.q = ws, a.k = ws + D, a.v = ws + 2 * D, a.ldq = W, a.ldk = W, a.ldv = W;
  a.out = gated, a.ldo = F, a.gamma = gamma, a.gmod = H;
  a.kv0 = kv0, a.s0 = s0, a.kvf = kvf, a.sf = sf;
  a.kvbuf = scratch;
  a.H = H, a.T = T, a.L = L;
  if ((err = core16<true>(a, ws + 2 * D + F, W, B * H, stream)) != 0) return err;
  d16::Epi16 eo{};
  eo.bias = bo, eo.s = 1.f;
  return d16::wg16<d16::kRound>(gated, wot, y, M, D, F, eo, stream);
}

}  // namespace r16
