// Attention of a block of K queries against a fixed-capacity KV cache on
// Hopper, float32, forward only.
//
// Replaces the two TPU kernels of fseend_tpu/kernels/cached_attention_pallas.py:
//   flash_cached_attention_perlane (_kernel_perlane): one write head per
//     lane and a min_pos floor, for FS-EEND's per-frame-exact fast block
//     (every encoder and decoder layer);
//   flash_cached_attention (_kernel; wrapper cached_attention_block): one
//     write head shared by every row and no floor, for the encoder of
//     FS-EEND's blockwise step.
// For row r (a (lane, [slot,] head) triple, rows lane-major) and query i < K,
// with qpos = start[r / rows_per_lane] + i, both compute
//   out[r][i] = sum_p w[p] v[r][p],  w = softmax_p(q[r][i] . k[r][p] / sqrt(hd))
// over the positions p < cap with (min_pos <= p <= qpos) or p == qpos.  The
// shared-head kernel is this one with a single start for all rows
// (rows_per_lane = R) and min_pos = 0; the two entry points below keep them
// apart for their callers.
//
// What bounds it on the card: operations.  Each (query, readable position)
// pair costs 4 hd float32 operations (q.k and p.v), against 8 hd bytes of
// cache that every query of the row shares: at the decoder's fast-block shape
// (1536 rows, K 125, hd 64, a full 2048-position cache) 100.7 GFLOP against
// 1.6 GB read once, 1.5 ms of the FMA pipe against 0.5 ms of device memory.
//
// Design, the simple form: one thread block per (row, 64-query tile), looping
// over 64-position kv tiles staged in shared memory up to the last position
// any of its queries may read (later tiles are dead and are not loaded).  The
// scores of a tile live in registers, the probabilities pass through shared
// memory on their way to the p.v product, and the running max, sum and the
// 64 x hd accumulator stay in registers across tiles (online softmax in
// float32), so no (K, cap) score tensor is ever written.  256 threads as
// 16 x 16: thread (ty, tx) owns query rows ty + 16a and kv columns tx + 16b
// (a, b < 4) of a score tile, and output columns tx + 16c of the
// accumulator, so that a warp reads neighbouring shared-memory words; the
// rows of a q or k tile are padded by one word against bank conflicts.
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
// The head dim is a compile-time constant (CA_HD <= 128), so that the
// accumulator stays in registers.  All products run on the FMA pipe;
// tensor cores, TMA and wgmma are later work.
#include <cmath>

#include "frame_scan_common.cuh"

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
  return ca::launch(q, k, v, start, out, R, K, cap, R, 0,
                    static_cast<cudaStream_t>(stream));
}
