// Attention of a block of K queries against a fixed-capacity KV cache on
// Hopper, float32, forward only.
//
// Replaces the two TPU kernels of fseend_tpu/kernels/cached_attention_pallas.py:
//   flash_cached_attention_perlane (_kernel_perlane): one write head per
//     lane and a min_pos floor, for FS-EEND's per-frame-exact fast block
//     (every encoder and decoder layer) -> cached_attention_kernel below;
//   flash_cached_attention (_kernel; wrapper cached_attention_block): one
//     write head shared by every row and no floor, for the encoder of
//     FS-EEND's blockwise step -> shared_head_kernel below.
// For row r (a (lane, [slot,] head) triple, rows lane-major) and query i < K,
// with qpos = start[r / rows_per_lane] + i, both compute
//   out[r][i] = sum_p w[p] v[r][p],  w = softmax_p(q[r][i] . k[r][p] / sqrt(hd))
// over the positions p < cap with (min_pos <= p <= qpos) or p == qpos.  The
// shared-head form has a single start for all rows and min_pos = 0.
//
// What bounds it on the card: operations.  Each (query, readable position)
// pair costs 4 hd float32 operations (q.k and p.v), against 8 hd bytes of
// cache that every query of the row shares: at the decoder's fast-block shape
// (1536 rows, K 125, hd 64, a full 2048-position cache) 100.7 GFLOP against
// 1.6 GB read once, 1.5 ms of the FMA pipe against 0.5 ms of device memory;
// at the blockwise encoder's (256 rows, K 128, start 1920) 16.6 GFLOP
// against 285 MB, 0.25 ms of the FMA pipe, 0.10 ms of the tensor cores at
// three TF32 passes (tc_f32.cuh), 0.085 ms of device memory.
//
// Masked entries (both kernels): the score of a masked position is the
// finite -1e30 the JAX kernels use, and its probability is set to 0
// explicitly.  With min_pos > 0 a pre-warm-up query (qpos < min_pos) sees
// whole tiles masked before its first finite score, where
// exp(-1e30 - (-1e30)) would be 1; the explicit zero keeps those tiles out
// of the sum and the accumulator (the JAX kernel does the same,
// cached_attention_pallas.py:207-209).  Every query reads at least one
// position (its own, or [min_pos, cap) when qpos >= cap), so the final
// division is by a positive sum.
//
// cached_attention_kernel (the per-lane form), the simple design: one
// thread block per (row, 64-query tile), looping over 64-position kv tiles
// staged in shared memory up to the last position any of its queries may
// read (later tiles are dead and are not loaded).  The scores of a tile live
// in registers, the probabilities pass through shared memory on their way to
// the p.v product, and the running max, sum and the 64 x hd accumulator stay
// in registers across tiles (online softmax in float32), so no (K, cap)
// score tensor is ever written.  256 threads as 16 x 16: thread (ty, tx)
// owns query rows ty + 16a and kv columns tx + 16b (a, b < 4) of a score
// tile, and output columns tx + 16c of the accumulator, so that a warp reads
// neighbouring shared-memory words; the rows of a q or k tile are padded by
// one word against bank conflicts.  All products on the FMA pipe.
//
// shared_head_kernel (the shared-head form), on the tensor cores: one block
// per (row, 128-query tile), so at K <= 128 each row's cache prefix is read
// once.  Each of the 8 warps owns 16 query rows; q k^T and p v run through
// the float32-exact 3xTF32 mma tile of tc_f32.cuh.  kv tiles of 64
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
// rounded up to 8), so every fragment load of a warp hits 32 banks.
//
// The head dim is a compile-time constant (CA_HD <= 128), so that the
// accumulators stay in registers.
#include <cmath>

#include "frame_scan_common.cuh"
#include "tc_f32.cuh"

#ifndef CA_HD
#error "define CA_HD (the head dim, at most 128)"
#endif

namespace ca {

constexpr int kQT = 64;            // queries per block
constexpr int kKT = 64;            // kv positions per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kNC = (CA_HD + 15) / 16;  // accumulator columns per thread
constexpr int kLdq = CA_HD + 1;    // padded row length of the q and k tiles
constexpr int kLdp = kKT + 1;      // padded row length of the probability tile
constexpr float kNeg = -1e30f;

static_assert(CA_HD >= 1 && CA_HD <= 128, "head dim must be in [1, 128]");

constexpr int smem_floats() { return 2 * kQT * kLdq + kKT * CA_HD + kQT * kLdp; }

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, out (R, K, CA_HD); k, v (R, cap, CA_HD); start[row / rows_per_lane]
__global__ void __launch_bounds__(kThreads)
    cached_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ start,
                            float* __restrict__ out, int K, int cap, int rows_per_lane,
                            int min_pos, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // (kQT, kLdq)
  float* ks = qs + kQT * kLdq;          // (kKT, kLdq)
  float* vs = ks + kKT * kLdq;          // (kKT, CA_HD)
  float* ps = vs + kKT * CA_HD;         // (kQT, kLdp)

  const int row = blockIdx.x;
  const int q0 = blockIdx.y * kQT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int st = start[row / rows_per_lane];
  const int nq = min(kQT, K - q0);
  // the last position a query of this tile may read
  const int last = min(st + q0 + nq - 1, cap - 1);

  const float* qr = q + ((size_t)row * K + q0) * CA_HD;
  const float* kr = k + (size_t)row * cap * CA_HD;
  const float* vr = v + (size_t)row * cap * CA_HD;
  for (int idx = threadIdx.x; idx < kQT * CA_HD; idx += kThreads) {
    const int r = idx / CA_HD, d = idx % CA_HD;
    qs[r * kLdq + d] = r < nq ? qr[(size_t)r * CA_HD + d] : 0.f;
  }

  float m[4], l[4], acc[4][kNC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNeg;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[a][c] = 0.f;
  }

  for (int j0 = 0; j0 <= last; j0 += kKT) {
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    const int nk = min(kKT, cap - j0);
    for (int idx = threadIdx.x; idx < kKT * CA_HD; idx += kThreads) {
      const int r = idx / CA_HD, d = idx % CA_HD;
      const bool in = r < nk;
      ks[r * kLdq + d] = in ? kr[(size_t)(j0 + r) * CA_HD + d] : 0.f;
      vs[r * CA_HD + d] = in ? vr[(size_t)(j0 + r) * CA_HD + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < CA_HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * kLdq + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = ks[(tx + 16 * b) * kLdq + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = st + q0 + ty + 16 * a;
      unsigned ok = 0;  // bit b: kv column tx + 16b is readable
      float mx = kNeg;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = j0 + tx + 16 * b;
        if (p < cap && ((p <= qpos && p >= min_pos) || p == qpos)) ok |= 1u << b;
        s[a][b] = (ok >> b) & 1u ? s[a][b] * scale : kNeg;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(mx));
      const float corr = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = (ok >> b) & 1u ? expf(s[a][b] - m_new) : 0.f;
        ps[(ty + 16 * a) * kLdp + tx + 16 * b] = p;
        sum += p;
      }
      l[a] = l[a] * corr + half_warp_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float pa[4], vc[kNC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int d = tx + 16 * c;
        vc[c] = d < CA_HD ? vs[j * CA_HD + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kNC; ++c) acc[a][c] = fmaf(pa[a], vc[c], acc[a][c]);
    }
  }

  float* orow = out + ((size_t)row * K + q0) * CA_HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= nq) continue;
    const float inv = 1.f / l[a];
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int d = tx + 16 * c;
      if (d < CA_HD) orow[(size_t)r * CA_HD + d] = acc[a][c] * inv;
    }
  }
}

inline int launch(const float* q, const float* k, const float* v, const int* start,
                  float* out, int R, int K, int cap, int rows_per_lane, int min_pos,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats();
  cudaError_t err = cudaFuncSetAttribute(cached_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, (K + kQT - 1) / kQT);
  cached_attention_kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, start, out, K, cap, rows_per_lane, min_pos,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(CA_HD))));
  return cudaGetLastError();
}


// ---- the shared-head form on the tensor cores ----

constexpr int kTcQ = 128;                  // queries per block: 8 warps x 16 rows
constexpr int kTcKV = 64;                  // kv positions per tile
constexpr int kHdp = (CA_HD + 7) / 8 * 8;  // head dim rounded up to the mma's k
constexpr int kTcLd = kHdp + 4;            // row stride of the q, k and v tiles
constexpr int kNT = kHdp / 8;              // accumulator tiles along hd
constexpr int kPad = kHdp - CA_HD;         // zero columns of a tile row
constexpr int kPadDiv = kPad > 0 ? kPad : 1;

constexpr int tc_smem_floats() { return (kTcQ + 4 * kTcKV) * kTcLd; }

// n rows of a (rows, CA_HD) matrix into a tile of row stride kTcLd by
// cp.async; rows at or past `valid` are zero-filled
__device__ __forceinline__ void tc_load_rows(float* dst, const float* src, int n, int valid) {
  if constexpr (CA_HD % 4 == 0) {
    constexpr int kChunks = CA_HD / 4;
    for (int idx = threadIdx.x; idx < n * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 4;
      const bool ok = r < valid;
      tc::cp_async16(dst + r * kTcLd + c, ok ? src + (size_t)r * CA_HD + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * CA_HD; idx += kThreads) {
      const int r = idx / CA_HD, c = idx % CA_HD;
      const bool ok = r < valid;
      tc::cp_async4(dst + r * kTcLd + c, ok ? src + (size_t)r * CA_HD + c : src, ok);
    }
  }
}

// q, out (R, K, CA_HD); k, v (R, cap, CA_HD); one start for every row
__global__ void __launch_bounds__(kThreads)
    shared_head_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ start,
                       float* __restrict__ out, int K, int cap, float scale) {
  extern __shared__ __align__(16) float tsm[];
  float* qs = tsm;                       // (kTcQ, kTcLd)
  float* kvs = qs + kTcQ * kTcLd;        // 2 stages x (k, v) x (kTcKV, kTcLd)

  const int row = blockIdx.x, q0 = blockIdx.y * kTcQ;
  const int warp = threadIdx.x >> 5, g = tc::lane_g(), t = tc::lane_t();
  const int st = start[0];
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
    tc_load_rows(ks, kr + (size_t)j0 * CA_HD, kTcKV, cap - j0);
    tc_load_rows(ks + kTcKV * kTcLd, vr + (size_t)j0 * CA_HD, kTcKV, cap - j0);
  };
  tc_load_rows(qs, q + ((size_t)row * K + q0) * CA_HD, kTcQ, nq);
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
          const bool ok = p < cap && p <= (e < 2 ? qp0 : qp1);
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

inline int launch_shared_head(const float* q, const float* k, const float* v,
                              const int* start, float* out, int R, int K, int cap,
                              cudaStream_t stream) {
  const size_t smem = sizeof(float) * tc_smem_floats();
  cudaError_t err = cudaFuncSetAttribute(shared_head_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, (K + kTcQ - 1) / kTcQ);
  shared_head_kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, start, out, K, cap,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(CA_HD))));
  return cudaGetLastError();
}

}  // namespace ca

// Per-lane write heads: start (R / rows_per_lane) int32 on the device.
// Returns cudaGetLastError().
extern "C" int cached_attention_perlane_launch(const float* q, const float* k,
                                               const float* v, const int* start,
                                               float* out, int R, int K, int cap,
                                               int rows_per_lane, int min_pos,
                                               void* stream) {
  return ca::launch(q, k, v, start, out, R, K, cap, rows_per_lane, min_pos,
                    static_cast<cudaStream_t>(stream));
}

// One write head for every row: start (1) int32 on the device; no floor.
extern "C" int cached_attention_launch(const float* q, const float* k, const float* v,
                                       const int* start, float* out, int R, int K,
                                       int cap, void* stream) {
  return ca::launch_shared_head(q, k, v, start, out, R, K, cap,
                                static_cast<cudaStream_t>(stream));
}
