// The chunkwise-retention core on Hopper's tensor cores, shared by
// chunk_retention.cu (B5) and retention_layer.cu (B4), float32.
//
// For one (batch, head) row and each L-frame chunk n, with the carried
// unnormalized state KV (dk, dv) and its scale c (a scalar >= 1):
//   mask[i][j]  = gamma^(i-j) / sv[i]  for j <= i,  sv[i] = sqrt(sum_{m<=i} gamma^m)
//   S           = (Q K^T) * mask                                   (L, L)
//   inner[i]    = max(sum_j |S[i][j]|, 1)
//   out[i]      = (S V + idec[i] * (Q KV)) / max(inner[i], c)      (L, dv)
//                 idec[i] = gamma^(i+1) * sv[L-1] / sv[i]
//   KV          = KV * gamma^L + K^T (V * gamma^(L-1-j) / sv[L-1])
//   c           = max(max_v sum_k |KV[k][v]|, 1)
// `out` reads KV and c as they were BEFORE the chunk's update (the TPU
// kernels' arithmetic with the divisions by inner and c folded into one, as
// chunk_retention_core.cuh has it).
//
// The state is linear in the chunks' summaries U_m = K_m^T (V_m *
// gamma^(L-1-j) / sv[L-1]):  KV_n = gamma^(nL) KV_0 + sum_{m<n}
// gamma^((n-1-m)L) U_m.  So a call does not walk a row's chunks in one
// block; it runs three kernels on the caller's stream:
//   (a) state_kernel, one block per (row, chunk): U_m on the tensor cores.
//       A single-chunk call (T = L) finishes the state here (KV_1 = KV_0
//       gamma^L + U_0 and its scale); otherwise U_m goes to scratch.
//   (b) scan_kernel, one block per row, only when T > L: KV_n = KV_{n-1}
//       gamma^L + U_{n-1} and c_n in chunk order on the FMA pipe, each KV_n
//       written over U_{n-1}'s slot, the last one as the new state.
//   (c) out_kernel, one block per (row, chunk, 64-query tile): the chunk's
//       queries against the k/v tiles at or before them, plus the read of
//       KV_n and c_n (KV_0 and the incoming scale for chunk 0).
// No atomics and no order that depends on scheduling: two calls give the
// same bits.  The incoming state is never written.
//
// Precision: every product runs through tc_f32.cuh's 3xTF32 mma in the
// precise form (operands split with split_rn, partial sums added on the FMA
// pipe), because the tensor cores' accumulator truncates.  Sums over a
// chunk's frames (S V, and K^T V for U_m) add each 32-frame slice.  With
// FINISH (B4), q k^T and q KV add each 8-deep k step too, so that a score is
// float32-exact even where its terms cancel: a row whose scores sum below 1
// is not renormalized, and the group norm after the core scales such a
// row's small output (and its error) up to unit size.  Without it (B5) they
// run in the plain form: no group norm follows, and a score's error stays
// at ~1e-6 of its terms.
//
// (c) in detail: 8 warps; warp (rw, hf) owns query rows rw*16 .. +15 of the
// tile, positions hf*32 .. +31 of each 64-frame k/v tile and half hf of
// dk in the cross read, each half in a sum of its own.  The masked
// scores stay in registers and go straight into the S V product's A
// fragment (the accumulator's column order 2t, 2t + 1 is read as t, t + 4,
// and the v rows in the same order, as cached_attention.cu does).  The two
// halves' accumulators and row sums are added in a fixed order through
// shared memory at the end.  k/v tiles are double-buffered with 16-byte
// cp.async into padded rows (every fragment load of a warp hits 32 banks;
// see Tiles); KV_n sits in the second stage until the cross term has read
// it.  Frames past the chunk's end are zero-filled, so they add nothing to
// the row sums or to the state.  The tiles of a row are ordered longest
// first (the last query tile reads every k/v tile).  The sv row comes from
// a warp's prefix over the chunk, not from one thread.  FINISH (B4): the
// group norm over the head's dv values (eps 1e-6, non-affine) and the
// silu(g) gate in the epilogue, written over g.
#pragma once

#include "frame_scan_common.cuh"
#include "tc_f32.cuh"

namespace crt {

constexpr int kTile = 64;      // frames of a query tile and of a k/v tile
constexpr int kThreads = 256;  // 8 warps
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  // q, k, v and out are matrices of B*T rows; the row of frame t of batch b
  // starts at p + (b*T + t)*ld, head h at column h*dk (h*dv for v and out)
  const float *q, *k, *v;
  int ldq, ldk, ldv;
  float* out;  // plain: the core's output.  FINISH: holds the gate g on
  int ldo;     // entry and silu(g) * groupnorm(core output) on exit
  const float* gamma;  // decay of row bh is gamma[bh % gmod]
  int gmod;
  const float *kv0, *s0;  // (B*H, dk, dv), (B*H)
  float *kvf, *sf;        // the new state, same shapes
  // T > L only: (B*H, T/L, dk, dv) and (B*H, T/L) scratch
  float *kvbuf, *cbuf;
  int H, T, L;
};

// sum_{m < n} gamma^m over one warp (lanes stride over m, then a butterfly,
// which leaves the same value in every lane)
__device__ __forceinline__ float decay_sum(float lg, int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int m = lane; m < n; m += 32) s += expf(lg * m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// nrows rows of width W (a multiple of 4) into a tile of row stride LD by
// 16-byte cp.async; rows at or past `valid` are zero-filled
template <int W, int LD = W + 4>
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t ld, int nrows,
                                          int valid) {
  constexpr int kC = W / 4, kLd = LD;
  for (int idx = threadIdx.x; idx < nrows * kC; idx += kThreads) {
    const int r = idx / kC, c = (idx % kC) * 4;
    const bool ok = r < valid;
    tc::cp_async16(dst + r * kLd + c, ok ? src + (size_t)r * ld + c : src, ok);
  }
}

// Row strides.  A warp's fragment loads hit 32 distinct banks when a row
// read as (lane % 4) + 4 (lane / 4) or 8 (lane % 4) + lane / 4 words in:
// the q and k tiles of (c) (rows by lane / 4) and the v tile of (c) (rows 2
// (lane % 4)) take W + 4; KV_n in (c) and both tiles of (a) (rows lane % 4)
// take W + 8.
template <int DK, int DV>
struct Tiles {
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DK <= 128 && DV <= 128,
                "head dims must be multiples of 16, at most 128");
  static constexpr int kLdk = DK + 4, kLdv = DV + 4, kLdkv = DV + 8;
  static constexpr int kPair = kTile * kLdk + kTile * kLdv;  // a k tile and a v tile
  static constexpr int kStage = kPair > DK * kLdkv ? kPair : DK * kLdkv;  // or KV_n
  static constexpr int kOutFloats = kTile * kLdk + 2 * kStage;  // + the q tile
  static constexpr int kComb = 32 * (DV / 2 + 2);  // one warp's accumulators and row sums
  static constexpr int kSLdk = DK + 8, kSLdv = DV + 8;  // (a)
  static constexpr int kSStage = kTile * kSLdk + kTile * kSLdv;
  static constexpr int kStateFloats = 2 * kSStage;
  static_assert(4 * kComb <= kStage && DK * DV <= kStateFloats, "epilogue buffers");
};

// ---- (a) U_m, or for a single chunk the new state ----

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2) state_kernel(Args a, int N) {
  using S = Tiles<DK, DV>;
  constexpr int kMt = DK / 16, kItems = kMt * (DV / 16), kPer = (kItems + 7) / 8;
  extern __shared__ __align__(16) float sm[];
  __shared__ float lr[2][kTile];  // the last mask row over each stage's frames
  __shared__ float col[DV];
  __shared__ float svl;

  const int n = blockIdx.x % N, bh = blockIdx.x / N;
  const int b = bh / a.H, h = bh % a.H, L = a.L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float lg = logf(a.gamma[bh % a.gmod]);  // gamma = 1: every decay term is exp(0) = 1
  const size_t row0 = (size_t)b * a.T + (size_t)n * L;
  const float* kn = a.k + row0 * a.ldk + h * DK;
  const float* vn = a.v + row0 * a.ldv + h * DV;
  const int ntile = (L + kTile - 1) / kTile;

  if (warp == 0) {
    const float s = sqrtf(decay_sum(lg, L));
    if (lane == 0) svl = s;
  }
  auto load = [&](int jt) {
    float* ks = sm + (jt & 1) * S::kSStage;
    const int j0 = jt * kTile;
    load_rows<DK, S::kSLdk>(ks, kn + (size_t)j0 * a.ldk, a.ldk, kTile, L - j0);
    load_rows<DV, S::kSLdv>(ks + kTile * S::kSLdk, vn + (size_t)j0 * a.ldv, a.ldv, kTile, L - j0);
  };
  load(0);
  tc::cp_async_commit();
  __syncthreads();  // svl

  float acc[kPer][2][4];
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][c][e] = 0.f;

  for (int jt = 0; jt < ntile; ++jt) {
    if (threadIdx.x < kTile) {
      const int j = jt * kTile + threadIdx.x;
      lr[jt & 1][threadIdx.x] = j < L ? expf(lg * (L - 1 - j)) / svl : 0.f;
    }
    if (jt + 1 < ntile) {
      load(jt + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile jt and its lr row have landed
    const float* ks = sm + (jt & 1) * S::kSStage;
    const float* vs = ks + kTile * S::kSLdk;
    const float* w = lr[jt & 1];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int item = warp + 8 * p;
      if (item >= kItems) break;
      const int m0 = (item % kMt) * 16, c0 = (item / kMt) * 16;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 32 frames into a fresh accumulator
        float part[2][4];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[c][e] = 0.f;
#pragma unroll
        for (int kk = half * 4; kk < half * 4 + 4; ++kk) {
          // A (16 state rows x 8 frames): element (m, f) = K[f][m0 + m]
          const float* kp = ks + kk * 8 * S::kSLdk + m0;
          tc::FragA fa;
          tc::set_a<true>(fa, kp[t * S::kSLdk + g], kp[t * S::kSLdk + g + 8],
                          kp[(t + 4) * S::kSLdk + g], kp[(t + 4) * S::kSLdk + g + 8]);
          const float w0 = w[kk * 8 + t], w1 = w[kk * 8 + t + 4];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // B (8 frames x 8 columns): element (f, v) = V[f][v] * lr[f]
            const float* vp = vs + kk * 8 * S::kSLdv + c0 + c * 8 + g;
            tc::FragB fb;
            tc::split_rn(vp[t * S::kSLdv] * w0, fb.big[0], fb.small[0]);
            tc::split_rn(vp[(t + 4) * S::kSLdv] * w1, fb.big[1], fb.small[1]);
            tc::mma3(part[c], fa, fb);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][c][e] += part[c][e];
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // U_m into shared memory (row-major, dk x dv), then out
  float* u = sm;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int item = warp + 8 * p;
    if (item >= kItems) break;
    const int m0 = (item % kMt) * 16, c0 = (item / kMt) * 16;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        u[(m0 + g + (e < 2 ? 0 : 8)) * DV + c0 + c * 8 + 2 * t + (e & 1)] = acc[p][c][e];
  }
  __syncthreads();
  if (N > 1) {
    float* dst = a.kvbuf + ((size_t)bh * N + n) * DK * DV;
    for (int i = threadIdx.x; i < DK * DV; i += kThreads) dst[i] = u[i];
    return;
  }
  const float cd = expf(lg * L);
  const float* kv0 = a.kv0 + (size_t)bh * DK * DV;
  float* kvf = a.kvf + (size_t)bh * DK * DV;
  for (int i = threadIdx.x; i < DK * DV; i += kThreads) {
    const float x = fmaf(kv0[i], cd, u[i]);
    u[i] = x;
    kvf[i] = x;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < DV; v += kThreads) {
    float s = 0.f;
    for (int k = 0; k < DK; ++k) s += fabsf(u[k * DV + v]);
    col[v] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float m = 1.f;
    for (int v = lane; v < DV; v += 32) m = fmaxf(m, col[v]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) a.sf[bh] = m;
  }
}

// ---- (b) the state before each chunk, in chunk order ----

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a, int N) {
  constexpr int kE = DK * DV, kPerT = (kE + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float kv[];  // (DK, DV): this step's state
  __shared__ float col[DV];
  const int bh = blockIdx.x, lane = threadIdx.x & 31;
  const float cd = expf(logf(a.gamma[bh % a.gmod]) * a.L);
  const float* kv0 = a.kv0 + (size_t)bh * kE;
  float* buf = a.kvbuf + (size_t)bh * N * kE;
  float run[kPerT];
#pragma unroll
  for (int r = 0; r < kPerT; ++r) {
    const int i = threadIdx.x + r * kThreads;
    run[r] = i < kE ? kv0[i] : 0.f;
  }
  for (int m = 0; m < N; ++m) {
    // slot m holds U_m; it becomes KV_{m+1} (the new state when m = N - 1)
    float* dst = m + 1 < N ? buf + (size_t)m * kE : a.kvf + (size_t)bh * kE;
#pragma unroll
    for (int r = 0; r < kPerT; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < kE) {
        run[r] = fmaf(run[r], cd, buf[(size_t)m * kE + i]);
        dst[i] = run[r];
        kv[i] = run[r];
      }
    }
    __syncthreads();
    for (int v = threadIdx.x; v < DV; v += kThreads) {
      float s = 0.f;
      for (int k = 0; k < DK; ++k) s += fabsf(kv[k * DV + v]);
      col[v] = s;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      float c = 1.f;
      for (int v = lane; v < DV; v += 32) c = fmaxf(c, col[v]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) c = fmaxf(c, __shfl_xor_sync(kFull, c, o));
      if (lane == 0) {
        if (m + 1 < N)
          a.cbuf[(size_t)bh * N + m] = c;
        else
          a.sf[bh] = c;
      }
    }
    __syncthreads();  // col and kv are rewritten by the next step
  }
}

// ---- (c) the output of one 64-query tile of one chunk ----

// d += a b over one k step: PRECISE, into a fresh accumulator added on the
// FMA pipe (so the step's sum is not truncated against d)
template <bool PRECISE>
__device__ __forceinline__ void mma_into(float (&d)[4], const tc::FragA& a, const tc::FragB& b) {
  if (PRECISE) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    tc::mma3(p, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += p[e];
  } else {
    tc::mma3(d, a, b);
  }
}

template <int DK, int DV, bool FINISH>
__global__ void __launch_bounds__(kThreads, 2) out_kernel(Args a, int nqt, int N) {
  using S = Tiles<DK, DV>;
  constexpr int kNv = DV / 8;  // accumulator tiles along dv
  extern __shared__ __align__(16) float sm[];
  __shared__ float rsv[kTile], idec[kTile];
  float* qs = sm;                      // (kTile, kLdk)
  float* st0 = qs + kTile * S::kLdk;   // 2 stages x (k tile, v tile)
  float* kvs = st0 + S::kStage;        // KV_n (DK, kLdkv) in the second stage, at first

  int idx = blockIdx.x;
  const int it = nqt - 1 - idx % nqt;  // the longest tiles first
  idx /= nqt;
  const int n = idx % N, bh = idx / N;
  const int b = bh / a.H, h = bh % a.H, L = a.L, i0 = it * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, hf = warp >> 2;
  const float lg = logf(a.gamma[bh % a.gmod]);
  const size_t row0 = (size_t)b * a.T + (size_t)n * L;
  const float* kn = a.k + row0 * a.ldk + h * DK;
  const float* vn = a.v + row0 * a.ldv + h * DV;
  const float* kvn = n == 0 ? a.kv0 + (size_t)bh * DK * DV
                            : a.kvbuf + ((size_t)bh * N + n - 1) * DK * DV;
  const float cs = n == 0 ? a.s0[bh] : a.cbuf[(size_t)bh * N + n - 1];

  load_rows<DK>(qs, a.q + (row0 + i0) * a.ldq + h * DK, a.ldq, kTile, L - i0);
  load_rows<DV, S::kLdkv>(kvs, kvn, DV, DK, DK);
  load_rows<DK>(st0, kn, a.ldk, kTile, L);
  load_rows<DV>(st0 + kTile * S::kLdk, vn, a.ldv, kTile, L);
  tc::cp_async_commit();
  if (warp == 0) {  // sv over the tile's rows: a prefix over the chunk
    const float base = decay_sum(lg, i0), tot = decay_sum(lg, L);
    const float e0 = expf(lg * (i0 + 2 * lane)), e1 = expf(lg * (i0 + 2 * lane + 1));
    float incl = e0 + e1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float p0 = base + excl + e0, p1 = p0 + e1;
    const float svl = sqrtf(tot);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 2 * lane + u, i = i0 + r;
      const float sv = sqrtf(u ? p1 : p0);
      rsv[r] = 1.f / sv;
      idec[r] = i < L ? expf(lg * (i + 1)) * svl / sv : 0.f;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  float acc[kNv][4];
#pragma unroll
  for (int c = 0; c < kNv; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const float* qw = qs + rw * 16 * S::kLdk;  // the warp's 16 query rows
  {  // the cross-chunk read idec[i] * (q_i KV_n), each half of the warps over half of dk
#pragma unroll
    for (int kk = hf * DK / 16; kk < (hf + 1) * DK / 16; ++kk) {
      tc::FragA fa;
      tc::load_a<FINISH>(fa, qw + kk * 8, S::kLdk);
#pragma unroll
      for (int c = 0; c < kNv; ++c) {
        tc::FragB fb;
        tc::load_b<FINISH>(fb, kvs + kk * 8 * S::kLdkv + c * 8, S::kLdkv, 1);
        mma_into<FINISH>(acc[c], fa, fb);
      }
    }
    const float d0 = idec[rw * 16 + g], d1 = idec[rw * 16 + g + 8];
#pragma unroll
    for (int c = 0; c < kNv; ++c) {
      acc[c][0] *= d0, acc[c][1] *= d0;
      acc[c][2] *= d1, acc[c][3] *= d1;
    }
  }
  __syncthreads();  // KV_n is read: the second stage is free

  const int ia = i0 + rw * 16 + g, ib = ia + 8;  // the lane's two query rows
  const float ra = rsv[rw * 16 + g], rb = rsv[rw * 16 + g + 8];
  const bool unit = lg == 0.f;  // gamma = 1 (LS-EEND's): no decay to exponentiate
  float suma = 0.f, sumb = 0.f;  // sum_j |S[i][j]|
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      float* nx = st0 + ((jt + 1) & 1) * S::kStage;
      const int j0 = (jt + 1) * kTile;
      load_rows<DK>(nx, kn + (size_t)j0 * a.ldk, a.ldk, kTile, L - j0);
      load_rows<DV>(nx + kTile * S::kLdk, vn + (size_t)j0 * a.ldv, a.ldv, kTile, L - j0);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile jt has landed
    const int j0 = jt * kTile + hf * 32;  // the warp's first position
    if (j0 <= i0 + rw * 16 + 15) {        // else every position is past the warp's rows
      const float* ks = st0 + (jt & 1) * S::kStage + hf * 32 * S::kLdk;
      const float* vs = st0 + (jt & 1) * S::kStage + kTile * S::kLdk + hf * 32 * S::kLdv;
      float s[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 8; ++kk) {
        tc::FragA fa;
        tc::load_a<FINISH>(fa, qw + kk * 8, S::kLdk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          tc::FragB fb;
          tc::load_b<FINISH>(fb, ks + c * 8 * S::kLdk + kk * 8, 1, S::kLdk);
          mma_into<FINISH>(s[c], fa, fb);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + c * 8 + 2 * t + (e & 1), i = e < 2 ? ia : ib;
          const float r = e < 2 ? ra : rb;
          const float m = j > i ? 0.f : unit ? r : expf(lg * (i - j)) * r;
          const float w = s[c][e] * m;
          s[c][e] = w;
          if (e < 2) suma += fabsf(w);
          else sumb += fabsf(w);
        }
      // S V over the warp's 32 positions, into a fresh accumulator: the
      // positions of k step kk are taken as (2t, 2t + 1) -> (t, t + 4)
      float part[kNv][4];
#pragma unroll
      for (int c = 0; c < kNv; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[c][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        tc::FragA fa;
        tc::set_a<true>(fa, s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
        const float* v0 = vs + (kk * 8 + 2 * t) * S::kLdv + g;
#pragma unroll
        for (int c = 0; c < kNv; ++c) {
          tc::FragB fb;
          tc::split_rn(v0[c * 8], fb.big[0], fb.small[0]);
          tc::split_rn(v0[S::kLdv + c * 8], fb.big[1], fb.small[1]);
          tc::mma3(part[c], fa, fb);
        }
      }
#pragma unroll
      for (int c = 0; c < kNv; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] += part[c][e];
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // the second half's sums onto the first's, in that order
  float* comb = st0 + rw * S::kComb;
  if (hf == 1) {
#pragma unroll
    for (int c = 0; c < kNv; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) comb[(c * 4 + e) * 32 + lane] = acc[c][e];
    comb[kNv * 4 * 32 + lane] = suma;
    comb[(kNv * 4 + 1) * 32 + lane] = sumb;
  }
  __syncthreads();
  if (hf == 1) return;
#pragma unroll
  for (int c = 0; c < kNv; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] += comb[(c * 4 + e) * 32 + lane];
  suma += comb[kNv * 4 * 32 + lane];
  sumb += comb[(kNv * 4 + 1) * 32 + lane];
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {  // the four lanes of a row
    suma += __shfl_xor_sync(kFull, suma, o);
    sumb += __shfl_xor_sync(kFull, sumb, o);
  }
  const float alla = fmaxf(fmaxf(suma, 1.f), cs), allb = fmaxf(fmaxf(sumb, 1.f), cs);
#pragma unroll
  for (int c = 0; c < kNv; ++c) {
    acc[c][0] /= alla, acc[c][1] /= alla;
    acc[c][2] /= allb, acc[c][3] /= allb;
  }
  float* on = a.out + row0 * a.ldo + h * DV + 2 * t;
  if (FINISH) {  // group norm over the head's dv values, eps 1e-6, then the gate
    float mua = 0.f, mub = 0.f;
#pragma unroll
    for (int c = 0; c < kNv; ++c) mua += acc[c][0] + acc[c][1], mub += acc[c][2] + acc[c][3];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mua += __shfl_xor_sync(kFull, mua, o);
      mub += __shfl_xor_sync(kFull, mub, o);
    }
    mua /= DV, mub /= DV;
    float vara = 0.f, varb = 0.f;
#pragma unroll
    for (int c = 0; c < kNv; ++c) {
      vara += (acc[c][0] - mua) * (acc[c][0] - mua) + (acc[c][1] - mua) * (acc[c][1] - mua);
      varb += (acc[c][2] - mub) * (acc[c][2] - mub) + (acc[c][3] - mub) * (acc[c][3] - mub);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      vara += __shfl_xor_sync(kFull, vara, o);
      varb += __shfl_xor_sync(kFull, varb, o);
    }
    const float rsa = rsqrtf(vara / DV + 1e-6f), rsb = rsqrtf(varb / DV + 1e-6f);
#pragma unroll
    for (int c = 0; c < kNv; ++c) {
      if (ia < L) {
        float2* p = reinterpret_cast<float2*>(on + (size_t)ia * a.ldo + c * 8);
        const float2 gv = *p;
        *p = make_float2(fs::silu(gv.x) * ((acc[c][0] - mua) * rsa),
                         fs::silu(gv.y) * ((acc[c][1] - mua) * rsa));
      }
      if (ib < L) {
        float2* p = reinterpret_cast<float2*>(on + (size_t)ib * a.ldo + c * 8);
        const float2 gv = *p;
        *p = make_float2(fs::silu(gv.x) * ((acc[c][2] - mub) * rsb),
                         fs::silu(gv.y) * ((acc[c][3] - mub) * rsb));
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kNv; ++c) {
      if (ia < L)
        *reinterpret_cast<float2*>(on + (size_t)ia * a.ldo + c * 8) =
            make_float2(acc[c][0], acc[c][1]);
      if (ib < L)
        *reinterpret_cast<float2*>(on + (size_t)ib * a.ldo + c * 8) =
            make_float2(acc[c][2], acc[c][3]);
    }
  }
}

// (a), (b) when T > L, (c) on `stream` for `rows` (batch, head) rows;
// returns the first CUDA error of the launches
template <int DK, int DV, bool FINISH>
inline int launch_core(const Args& a, int rows, cudaStream_t stream) {
  using S = Tiles<DK, DV>;
  const int N = a.T / a.L, nqt = (a.L + kTile - 1) / kTile;
  const int smem_a = (int)sizeof(float) * S::kStateFloats;
  cudaError_t err = cudaFuncSetAttribute(state_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return err;
  state_kernel<DK, DV><<<rows * N, kThreads, smem_a, stream>>>(a, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (N > 1) {
    const int smem_b = (int)sizeof(float) * DK * DV;
    err = cudaFuncSetAttribute(scan_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_b);
    if (err != cudaSuccess) return err;
    scan_kernel<DK, DV><<<rows, kThreads, smem_b, stream>>>(a, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int smem_c = (int)sizeof(float) * S::kOutFloats;
  err = cudaFuncSetAttribute(out_kernel<DK, DV, FINISH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_c);
  if (err != cudaSuccess) return err;
  out_kernel<DK, DV, FINISH><<<rows * N * nqt, kThreads, smem_c, stream>>>(a, nqt, N);
  return cudaGetLastError();
}

}  // namespace crt
