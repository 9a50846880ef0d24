// The chunkwise-retention core shared by chunk_retention.cu and
// retention_layer.cu, float32.
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
// `out` reads KV and c as they were BEFORE the chunk's update.  This is
// the TPU kernels' arithmetic with the two divisions by inner and c folded
// into one (inner * (inner_scale / all) + cross * (c / all) there), so that
// S V can be accumulated over column tiles before the row sums are known.
//
// Design: one thread block per (batch, head) row, looping over the chunks
// inside the launch (the chunks of a row are sequential, the rows are
// independent).  KV stays in shared memory for the whole launch and is read
// from and written to device memory once; the incoming state is not
// overwritten (the callers gate the new state per lane).  A chunk is cut
// into tiles of 64 frames: for a q tile the block streams the k/v tiles at
// or before it, forms the 64 x 64 masked products in registers, accumulates
// their absolute row sums, passes them through shared memory and multiplies
// by the v tile.  K^T V for the state is accumulated from each diagonal tile.
// 256 threads as 16 x 16; thread (ty, tx) owns rows r*16 + ty and columns
// c*16 + tx of every tile, so that a warp reads neighbouring shared-memory
// words.  All products run on the FMA pipe; tensor cores are later work.
#pragma once

#include "frame_scan_common.cuh"

namespace cr {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kLd = kTile + 1;  // row length of the k-major (transposed) tiles

struct CoreArgs {
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
  int H, T, L;
};

template <int DK, int DV>
__host__ __device__ constexpr int core_smem_floats(int L) {
  return 2 * DK * kLd + kTile * DV + kTile * kLd + DK * DV + kTile + DV + L;
}

// sum over the 16 threads that share ty (a half warp)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [i0, i0 + 64) of a chunk's (L, W) operand into a k-major tile
// dst[w * kLd + r]; rows at or past L are zeros
template <int W>
__device__ __forceinline__ void load_tile_t(float* dst, const float* src, int ld,
                                            int i0, int L) {
  for (int idx = threadIdx.x; idx < kTile * W; idx += kThreads) {
    const int r = idx / W, w = idx % W;
    dst[w * kLd + r] = i0 + r < L ? src[(size_t)(i0 + r) * ld + w] : 0.f;
  }
}

template <int DK, int DV, bool FINISH>
__global__ void __launch_bounds__(kThreads) core_kernel(CoreArgs a) {
  static_assert(DK % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  constexpr int R = kTile / 16;  // rows of a tile per thread
  constexpr int CV = DV / 16;    // value columns per thread
  constexpr int RK = DK / 16;    // state rows per thread
  extern __shared__ __align__(16) float sm[];
  float* QsT = sm;                 // (DK, kLd)   q tile, k-major
  float* KsT = QsT + DK * kLd;     // (DK, kLd)   k tile, k-major
  float* Vs = KsT + DK * kLd;      // (kTile, DV) v tile
  float* Ss = Vs + kTile * DV;     // (kTile, kLd) masked q k^T
  float* KV = Ss + kTile * kLd;    // (DK, DV)    carried state
  float* lr = KV + DK * DV;        // (kTile)     last mask row of the k tile
  float* colsum = lr + kTile;      // (DV)
  float* sv = colsum + DV;         // (L)         sqrt of the decay row sums
  __shared__ float kv_scale;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int T = a.T, L = a.L;
  const float lg = logf(a.gamma[bh % a.gmod]);  // gamma = 1: every decay term is exp(0) = 1

  if (tid == 0) {
    float s = 0.f;
    for (int m = 0; m < L; ++m) {
      s += expf(lg * m);
      sv[m] = sqrtf(s);
    }
    kv_scale = a.s0[bh];
  }
  for (int i = tid; i < DK * DV; i += kThreads) KV[i] = a.kv0[(size_t)bh * DK * DV + i];
  __syncthreads();
  const float scale_last = sv[L - 1];
  const float cross_decay = expf(lg * L);
  const int ntile = (L + kTile - 1) / kTile;

  for (int n = 0; n < T / L; ++n) {
    const size_t row0 = (size_t)b * T + (size_t)n * L;
    const float* qn = a.q + row0 * a.ldq + h * DK;
    const float* kn = a.k + row0 * a.ldk + h * DK;
    const float* vn = a.v + row0 * a.ldv + h * DV;
    float* on = a.out + row0 * a.ldo + h * DV;
    const float cs = kv_scale;  // the scale of the state this chunk reads
    float kvc[RK][CV];
#pragma unroll
    for (int r = 0; r < RK; ++r)
#pragma unroll
      for (int c = 0; c < CV; ++c) kvc[r][c] = 0.f;

    for (int it = 0; it < ntile; ++it) {
      __syncthreads();  // the last tile's reads of QsT are done
      load_tile_t<DK>(QsT, qn, a.ldq, it * kTile, L);
      __syncthreads();
      // cross-chunk read: idec[i] * (q_i KV)
      float acc[R][CV];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < DK; ++kk) {
        float av[R], bv[CV];
#pragma unroll
        for (int r = 0; r < R; ++r) av[r] = QsT[kk * kLd + r * 16 + ty];
#pragma unroll
        for (int c = 0; c < CV; ++c) bv[c] = KV[kk * DV + c * 16 + tx];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < CV; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      float rowabs[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = it * kTile + r * 16 + ty;
        const float idec = i < L ? expf(lg * (i + 1)) * scale_last / sv[i] : 0.f;
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[r][c] *= idec;
        rowabs[r] = 0.f;
      }

      for (int jt = 0; jt <= it; ++jt) {
        __syncthreads();  // the last tile's reads of KsT, Vs, Ss and lr are done
        load_tile_t<DK>(KsT, kn, a.ldk, jt * kTile, L);
        for (int idx = tid; idx < kTile * DV; idx += kThreads) {
          const int j = jt * kTile + idx / DV;
          Vs[idx] = j < L ? vn[(size_t)j * a.ldv + idx % DV] : 0.f;
        }
        if (tid < kTile) {
          const int j = jt * kTile + tid;
          lr[tid] = j < L ? expf(lg * (L - 1 - j)) / scale_last : 0.f;
        }
        __syncthreads();
        float s[R][R];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c) s[r][c] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < DK; ++kk) {
          float av[R], bv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) av[r] = QsT[kk * kLd + r * 16 + ty];
#pragma unroll
          for (int c = 0; c < R; ++c) bv[c] = KsT[kk * kLd + c * 16 + tx];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < R; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = it * kTile + r * 16 + ty;
#pragma unroll
          for (int c = 0; c < R; ++c) {
            const int j = jt * kTile + c * 16 + tx;
            const float m = (j <= i && i < L) ? expf(lg * (i - j)) / sv[i] : 0.f;
            const float w = s[r][c] * m;
            rowabs[r] += fabsf(w);
            Ss[(r * 16 + ty) * kLd + c * 16 + tx] = w;
          }
        }
        if (jt == it) {  // each k/v tile adds to the state once: K^T (V * lr)
#pragma unroll 4
          for (int j = 0; j < kTile; ++j) {
            const float w = lr[j];
            float kr[RK], vv[CV];
#pragma unroll
            for (int r = 0; r < RK; ++r) kr[r] = KsT[(r * 16 + ty) * kLd + j] * w;
#pragma unroll
            for (int c = 0; c < CV; ++c) vv[c] = Vs[j * DV + c * 16 + tx];
#pragma unroll
            for (int r = 0; r < RK; ++r)
#pragma unroll
              for (int c = 0; c < CV; ++c) kvc[r][c] = fmaf(kr[r], vv[c], kvc[r][c]);
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          float av[R], vv[CV];
#pragma unroll
          for (int r = 0; r < R; ++r) av[r] = Ss[(r * 16 + ty) * kLd + j];
#pragma unroll
          for (int c = 0; c < CV; ++c) vv[c] = Vs[j * DV + c * 16 + tx];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < CV; ++c) acc[r][c] = fmaf(av[r], vv[c], acc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = it * kTile + r * 16 + ty;
        const float inner = fmaxf(half_warp_sum(rowabs[r]), 1.f);
        const float all = fmaxf(inner, cs);
        float o[CV];
#pragma unroll
        for (int c = 0; c < CV; ++c) o[c] = acc[r][c] / all;
        if (FINISH) {  // group norm over the head's dv values, eps 1e-6, then the gate
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < CV; ++c) sum += o[c];
          const float mu = half_warp_sum(sum) / DV;
          float var = 0.f;
#pragma unroll
          for (int c = 0; c < CV; ++c) var += (o[c] - mu) * (o[c] - mu);
          const float rs = rsqrtf(half_warp_sum(var) / DV + 1e-6f);
          if (i < L) {
#pragma unroll
            for (int c = 0; c < CV; ++c) {
              float* p = on + (size_t)i * a.ldo + c * 16 + tx;
              *p = fs::silu(*p) * ((o[c] - mu) * rs);
            }
          }
        } else if (i < L) {
#pragma unroll
          for (int c = 0; c < CV; ++c) on[(size_t)i * a.ldo + c * 16 + tx] = o[c];
        }
      }
    }

    __syncthreads();  // every tile has read the old state
#pragma unroll
    for (int r = 0; r < RK; ++r)
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        float* p = KV + (r * 16 + ty) * DV + c * 16 + tx;
        *p = *p * cross_decay + kvc[r][c];
      }
    __syncthreads();
    for (int v = tid; v < DV; v += kThreads) {
      float s = 0.f;
      for (int k = 0; k < DK; ++k) s += fabsf(KV[k * DV + v]);
      colsum[v] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float m = 1.f;
      for (int v = 0; v < DV; ++v) m = fmaxf(m, colsum[v]);
      kv_scale = m;
    }
    __syncthreads();
  }

  for (int i = tid; i < DK * DV; i += kThreads) a.kvf[(size_t)bh * DK * DV + i] = KV[i];
  if (tid == 0) a.sf[bh] = kv_scale;
}

// one block per (batch, head) row; returns cudaGetLastError() after the launch
template <int DK, int DV, bool FINISH>
inline int launch_core(const CoreArgs& a, int rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * core_smem_floats<DK, DV>(a.L);
  cudaError_t err = cudaFuncSetAttribute(core_kernel<DK, DV, FINISH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  core_kernel<DK, DV, FINISH><<<rows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace cr
