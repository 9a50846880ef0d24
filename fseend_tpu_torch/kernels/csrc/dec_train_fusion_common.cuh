// The small kernels of one decoder fusion layer in training semantics,
// float32, shared by the fusion layer's forward sequence
// (dec_train_fusion_seq.cuh) and its backward (dec_train_fusion_bwd.cu):
// the dropout hash, residual + dropout + LayerNorm forward and backward, the
// group norm + silu gate forward and backward, relu + dropout, and the
// attention across the C slots of a frame, forward and backward.
//
// The grid of the layer is slot-major: row r = (b*C + c)*T + t holds frame t
// of slot c of batch row b, so a (b, c) pair is a sequence of T rows, and
// frame t lies in chunk n = t / L at place l = t % L.
//
// Row kernels run one warp per row; lane i owns the NV = D/32 contiguous
// columns [i*NV, (i+1)*NV) (float4 loads, float2 where NV is not a multiple
// of 4), so a head's DV columns are the G = DV/NV lanes of an aligned group
// and its sums are shuffles inside the group.  D (DTF_D) and the head dims
// (CR_DK = CR_DV) are compile-time.  The frame scans (dec_frame_scan.cu,
// enc_frame_scan.cu) run the forward row kernels at dropout 0.
#pragma once

#include <initializer_list>

#include "chunk_retention_core.cuh"

#ifndef DTF_D
#error "define DTF_D (the model width), CR_DK and CR_DV (the head dims)"
#endif

namespace dtf {

constexpr int D = DTF_D;
constexpr int DK = CR_DK;
constexpr int H = D / DK;
constexpr int NV = D / 32;
constexpr int G = DK / NV;
static_assert(D % 64 == 0 && D <= 512, "D a multiple of 64, at most 512");
static_assert(CR_DK == CR_DV && H * DK == D, "equal key and value head dims tiling D");
static_assert(DK % NV == 0 && 32 % G == 0, "a head is an aligned group of lanes");

constexpr unsigned kFull = 0xffffffffu;
enum Site { kRet = 0, kAttnW = 1, kMha = 2, kFfh = 3, kFfo = 4 };

// the dropout of one call and the grid geometry its element indices need
struct Drop {
  unsigned seed, thr;  // an element is kept iff its hash >= thr
  float mult;          // 1 / (1 - rate)
  int C, T, L;
};

// dec_train_fusion_pallas.py:_hash_keep, bit for bit (uint32 arithmetic)
__device__ __forceinline__ unsigned hash_base(const Drop& d, int b, int n, int site) {
  return d.seed * 0x9E3779B9u ^ (unsigned)b * 0x85EBCA6Bu ^ (unsigned)n * 0xC2B2AE35u ^
         (unsigned)site * 0x27D4EB2Fu;
}

__device__ __forceinline__ float keep(const Drop& d, unsigned base, unsigned idx) {
  unsigned h = idx ^ base;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= d.thr ? d.mult : 0.f;
}

// (b, n, and the chunk-local row c*L + l) of grid row r
struct RowPos {
  int b, n, cl;
};

__device__ __forceinline__ RowPos row_pos(const Drop& d, long long r) {
  const int seq = (int)(r / d.T), t = (int)(r % d.T);
  return {seq / d.C, t / d.L, (seq % d.C) * d.L + t % d.L};
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ void load_row(const float* p, float (&v)[NV]) {
  if constexpr (NV % 4 == 0) {
    const float4* q = reinterpret_cast<const float4*>(p + lane_id() * NV);
#pragma unroll
    for (int i = 0; i < NV / 4; ++i) {
      const float4 t = q[i];
      v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
    }
  } else {
    const float2* q = reinterpret_cast<const float2*>(p + lane_id() * NV);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      const float2 t = q[i];
      v[2 * i] = t.x, v[2 * i + 1] = t.y;
    }
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[NV]) {
  if constexpr (NV % 4 == 0) {
    float4* q = reinterpret_cast<float4*>(p + lane_id() * NV);
#pragma unroll
    for (int i = 0; i < NV / 4; ++i)
      q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    float2* q = reinterpret_cast<float2*>(p + lane_id() * NV);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) q[i] = make_float2(v[2 * i], v[2 * i + 1]);
  }
}

__device__ __forceinline__ float row_sum(const float (&v)[NV]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) s += v[i];
  return fs::warp_sum(s);
}

// sum over the G lanes of a head
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// the warps of a launch walk the rows
#define DTF_FOR_ROWS(r, R)                                                         \
  for (long long r = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); \
       r < (R); r += (long long)gridDim.x * (blockDim.x >> 5))

// y = LN(x + a * mask(site)) with scale/bias (eps 1e-5); the pre-norm sum
// is written to rsum when it is not null (the backward reads it), y when it
// is not null
__global__ void __launch_bounds__(256)
add_drop_ln_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ rsum, float* __restrict__ y, long long R, Drop dp,
                   int site) {
  const int c0 = lane_id() * NV;
  DTF_FOR_ROWS(r, R) {
    const RowPos p = row_pos(dp, r);
    const unsigned base = hash_base(dp, p.b, p.n, site);
    float v[NV], av[NV];
    load_row(x + r * D, v);
    load_row(a + r * D, av);
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += av[i] * keep(dp, base, (unsigned)(p.cl * D + c0 + i));
    if (rsum) store_row(rsum + r * D, v);
    if (!y) continue;
    const float mu = row_sum(v) / D;
    float d2[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) d2[i] = (v[i] - mu) * (v[i] - mu);
    const float rs = rsqrtf(row_sum(d2) / D + 1e-5f);
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = (v[i] - mu) * rs * __ldg(scale + c0 + i) + __ldg(bias + c0 + i);
    store_row(y + r * D, v);
  }
}

// Backward of add_drop_ln: from dy and the pre-norm sum rsum, dres = the
// gradient of the sum (written over dres, which may be dy) and dbranch =
// dres * mask(site); the block's column sums of the scale and bias
// gradients, over its rows in a fixed order, go to part[blockIdx.x] (2D
// floats: scale, then bias), which ln_bwd_reduce_kernel adds in block order.
__global__ void __launch_bounds__(256)
ln_bwd_kernel(const float* dy, const float* __restrict__ rsum, const float* __restrict__ scale,
              float* dres, float* __restrict__ dbranch, float* __restrict__ part, long long R,
              Drop dp, int site) {
  __shared__ float red[2][8][D];
  const int c0 = lane_id() * NV, warp = threadIdx.x >> 5;
  float ds[NV], db[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) ds[i] = db[i] = 0.f;
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
      v[i] = (v[i] - mu) * rs;  // xhat
      ds[i] += g[i] * v[i];
      db[i] += g[i];
      g[i] *= __ldg(scale + c0 + i);  // dxhat
      t[i] = g[i] * v[i];
    }
    const float m1 = row_sum(g) / D, m2 = row_sum(t) / D;
#pragma unroll
    for (int i = 0; i < NV; ++i) g[i] = rs * (g[i] - m1 - v[i] * m2);
    store_row(dres + r * D, g);
#pragma unroll
    for (int i = 0; i < NV; ++i) g[i] *= keep(dp, base, (unsigned)(p.cl * D + c0 + i));
    store_row(dbranch + r * D, g);
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) red[0][warp][c0 + i] = ds[i], red[1][warp][c0 + i] = db[i];
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    const int which = c / D, col = c % D;
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[which][w][col];
    part[(size_t)blockIdx.x * 2 * D + c] = s;
  }
}

// dscale[c], dbias[c] = the sums over the S blocks of ln_bwd_kernel's parts,
// in block order (the same bits from run to run)
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part, int S,
                                     float* __restrict__ dscale, float* __restrict__ dbias) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < 2 * D; c += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < S; ++z) s += part[(size_t)z * 2 * D + c];
    (c < D ? dscale : dbias)[c % D] = s;
  }
}

// per (row, head): gated = silu(g) * groupnorm(oh) (eps 1e-6, non-affine);
// g has row stride ldg
__global__ void __launch_bounds__(256)
gate_fwd_kernel(const float* __restrict__ oh, const float* __restrict__ g, int ldg,
                float* __restrict__ gated, long long R) {
  DTF_FOR_ROWS(r, R) {
    float v[NV], gv[NV], t[NV];
    load_row(oh + r * D, v);
    load_row(g + r * ldg, gv);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) s += v[i];
    const float mu = group_sum(s) / DK;
    s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) s += (v[i] - mu) * (v[i] - mu);
    const float rs = rsqrtf(group_sum(s) / DK + 1e-6f);
#pragma unroll
    for (int i = 0; i < NV; ++i) t[i] = fs::silu(gv[i]) * ((v[i] - mu) * rs);
    store_row(gated + r * D, t);
  }
}

// Backward of gate_fwd: from dgated, dg (stride ldg) = dgated * ohn *
// silu'(g) and doh = the group-norm backward of dgated * silu(g)
__global__ void __launch_bounds__(256)
gate_bwd_kernel(const float* __restrict__ dgated, const float* __restrict__ oh,
                const float* __restrict__ g, int ldg, float* __restrict__ dg, int lddg,
                float* __restrict__ doh, long long R) {
  DTF_FOR_ROWS(r, R) {
    float v[NV], gv[NV], dv[NV], t[NV];
    load_row(oh + r * D, v);
    load_row(g + r * ldg, gv);
    load_row(dgated + r * D, dv);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) s += v[i];
    const float mu = group_sum(s) / DK;
    s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) s += (v[i] - mu) * (v[i] - mu);
    const float rs = rsqrtf(group_sum(s) / DK + 1e-6f);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      v[i] = (v[i] - mu) * rs;  // ohn
      const float sg = fs::sigmoid(gv[i]);
      t[i] = dv[i] * v[i] * (sg * (1.f + gv[i] * (1.f - sg)));  // dg
      dv[i] *= gv[i] * sg;                                       // d ohn
      s1 += dv[i];
      s2 += dv[i] * v[i];
    }
    store_row(dg + r * lddg, t);
    const float m1 = group_sum(s1) / DK, m2 = group_sum(s2) / DK;
#pragma unroll
    for (int i = 0; i < NV; ++i) dv[i] = rs * (dv[i] - m1 - v[i] * m2);
    store_row(doh + r * D, dv);
  }
}

// out = src * (hpre > 0 ? mask(FFN hidden) : 0) over (R, F): relu + dropout
// forward (src = hpre) and backward (src = the gradient)
__global__ void relu_drop_kernel(const float* src, const float* hpre, float* out, long long total,
                                 int F, Drop dp) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / F;
    const int f = (int)(e % F);
    const RowPos p = row_pos(dp, r);
    const float m = hpre[e] > 0.f
                        ? keep(dp, hash_base(dp, p.b, p.n, kFfh), (unsigned)(p.cl * F + f))
                        : 0.f;
    out[e] = src[e] * m;
  }
}

// Attention across the C slots of one (b, t, head) per warp, head dim DK.
// qkv rows hold q | k | v (stride 3D).  Softmax weights w (C x C) with
// dropout (site 1 + 16 h, chunk-local shape (C, L, C)); out = (w * mask) v.
constexpr int kAttnWarps = 4;

__host__ __device__ constexpr int attn_smem_floats(int C, bool bwd) {
  return kAttnWarps * ((bwd ? 4 : 3) * C * DK + (bwd ? 3 : 2) * C * C);
}

struct SlotView {
  int b, t, h, n, l;
  bool ok;
};

__device__ __forceinline__ SlotView slot_view(const Drop& dp, int B) {
  const int gw = blockIdx.x * kAttnWarps + (threadIdx.x >> 5);
  const int t = (gw / H) % dp.T;
  return {gw / (H * dp.T), t, gw % H, t / dp.L, t % dp.L, gw < B * dp.T * H};
}

__device__ __forceinline__ long long slot_row(const Drop& dp, const SlotView& s, int c) {
  return ((long long)s.b * dp.C + c) * dp.T + s.t;
}

// softmax rows of W (C x C) in place; M gets each weight's dropout multiplier
__device__ __forceinline__ void softmax_mask(const Drop& dp, const SlotView& s, float* W, float* M) {
  const int C = dp.C, c = lane_id();
  if (c < C) {
    float m = W[c * C];
    for (int j = 1; j < C; ++j) m = fmaxf(m, W[c * C + j]);
    float sum = 0.f;
    for (int j = 0; j < C; ++j) {
      const float e = expf(W[c * C + j] - m);
      W[c * C + j] = e;
      sum += e;
    }
    const unsigned base = hash_base(dp, s.b, s.n, kAttnW + 16 * s.h);
    for (int j = 0; j < C; ++j) {
      W[c * C + j] /= sum;
      M[c * C + j] = keep(dp, base, (unsigned)((c * dp.L + s.l) * C + j));
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void load_slots(const float* qkv, const Drop& dp, const SlotView& s,
                                           float* qs, float* ks, float* vs) {
  for (int c = 0; c < dp.C; ++c) {
    const float* row = qkv + slot_row(dp, s, c) * 3 * D + s.h * DK;
    for (int d = lane_id(); d < DK; d += 32) {
      qs[c * DK + d] = row[d];
      ks[c * DK + d] = row[D + d];
      vs[c * DK + d] = row[2 * D + d];
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void scores(const Drop& dp, const float* qs, const float* ks, float* W) {
  const int C = dp.C;
  const float inv = (float)(1.0 / sqrt((double)DK));
  for (int p = lane_id(); p < C * C; p += 32) {
    const int c = p / C, j = p % C;
    float s = 0.f;
    for (int d = 0; d < DK; ++d) s += qs[c * DK + d] * ks[j * DK + d];
    W[p] = s * inv;
  }
  __syncwarp();
}

__global__ void slot_attn_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ attn, int B,
                                     Drop dp) {
  extern __shared__ __align__(16) float sm[];
  const SlotView s = slot_view(dp, B);
  if (!s.ok) return;
  const int C = dp.C;
  float* qs = sm + (threadIdx.x >> 5) * (attn_smem_floats(C, false) / kAttnWarps);
  float *ks = qs + C * DK, *vs = ks + C * DK, *W = vs + C * DK, *M = W + C * C;
  load_slots(qkv, dp, s, qs, ks, vs);
  scores(dp, qs, ks, W);
  softmax_mask(dp, s, W, M);
  for (int c = 0; c < C; ++c) {
    float* out = attn + slot_row(dp, s, c) * D + s.h * DK;
    for (int d = lane_id(); d < DK; d += 32) {
      float o = 0.f;
      for (int j = 0; j < C; ++j) o += (W[c * C + j] * M[c * C + j]) * vs[j * DK + d];
      out[d] = o;
    }
  }
}

// dattn rows (stride D) -> dqkv rows (stride 3D): dq | dk | dv of the head
__global__ void slot_attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                                     float* __restrict__ dqkv, int B, Drop dp) {
  extern __shared__ __align__(16) float sm[];
  const SlotView s = slot_view(dp, B);
  if (!s.ok) return;
  const int C = dp.C, lane = lane_id();
  float* qs = sm + (threadIdx.x >> 5) * (attn_smem_floats(C, true) / kAttnWarps);
  float *ks = qs + C * DK, *vs = ks + C * DK, *das = vs + C * DK;
  float *W = das + C * DK, *M = W + C * C, *S = M + C * C;
  load_slots(qkv, dp, s, qs, ks, vs);
  for (int c = 0; c < C; ++c) {
    const float* row = dattn + slot_row(dp, s, c) * D + s.h * DK;
    for (int d = lane; d < DK; d += 32) das[c * DK + d] = row[d];
  }
  scores(dp, qs, ks, W);
  softmax_mask(dp, s, W, M);
  // d(w * mask), then through the mask
  for (int p = lane; p < C * C; p += 32) {
    const int c = p / C, j = p % C;
    float g = 0.f;
    for (int d = 0; d < DK; ++d) g += das[c * DK + d] * vs[j * DK + d];
    S[p] = g * M[p];
  }
  __syncwarp();
  const float inv = (float)(1.0 / sqrt((double)DK));
  if (lane < C) {  // softmax backward, row c = lane
    float t = 0.f;
    for (int j = 0; j < C; ++j) t += S[lane * C + j] * W[lane * C + j];
    for (int j = 0; j < C; ++j) S[lane * C + j] = W[lane * C + j] * (S[lane * C + j] - t) * inv;
  }
  __syncwarp();
  for (int c = 0; c < C; ++c) {
    float* out = dqkv + slot_row(dp, s, c) * 3 * D + s.h * DK;
    for (int d = lane; d < DK; d += 32) {
      float gq = 0.f, gk = 0.f, gv = 0.f;
      for (int j = 0; j < C; ++j) {
        gq += S[c * C + j] * ks[j * DK + d];
        gk += S[j * C + c] * qs[j * DK + d];
        gv += (W[j * C + c] * M[j * C + c]) * das[j * DK + d];
      }
      out[d] = gq;
      out[D + d] = gk;
      out[2 * D + d] = gv;
    }
  }
}

__global__ void fill_kernel(float* p, float v, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    p[i] = v;
}

// ---- launches: each returns cudaGetLastError() ----

inline long long lmin(long long a, long long b) { return a < b ? a : b; }

inline int row_grid(long long R) { return (int)lmin((R + 7) / 8, 132 * 8); }

inline int add_drop_ln(const float* x, const float* a, const float* scale, const float* bias,
                       float* rsum, float* y, long long R, const Drop& dp, int site,
                       cudaStream_t st) {
  add_drop_ln_kernel<<<row_grid(R), 256, 0, st>>>(x, a, scale, bias, rsum, y, R, dp, site);
  return cudaGetLastError();
}

// kLnBwdBlocks * 2D floats of `part` hold the blocks' column sums
constexpr int kLnBwdBlocks = 132 * 2;

inline int ln_bwd(const float* dy, const float* rsum, const float* scale, float* dres,
                  float* dbranch, float* dscale, float* dbias, long long R, const Drop& dp,
                  int site, float* part, cudaStream_t st) {
  const int grid = (int)lmin((R + 7) / 8, kLnBwdBlocks);
  ln_bwd_kernel<<<grid, 256, 0, st>>>(dy, rsum, scale, dres, dbranch, part, R, dp, site);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_bwd_reduce_kernel<<<(2 * D + 255) / 256, 256, 0, st>>>(part, grid, dscale, dbias);
  return cudaGetLastError();
}

inline int gate_fwd(const float* oh, const float* g, int ldg, float* gated, long long R,
                    cudaStream_t st) {
  gate_fwd_kernel<<<row_grid(R), 256, 0, st>>>(oh, g, ldg, gated, R);
  return cudaGetLastError();
}

inline int gate_bwd(const float* dgated, const float* oh, const float* g, int ldg, float* dg,
                    int lddg, float* doh, long long R, cudaStream_t st) {
  gate_bwd_kernel<<<row_grid(R), 256, 0, st>>>(dgated, oh, g, ldg, dg, lddg, doh, R);
  return cudaGetLastError();
}

inline int relu_drop(const float* src, const float* hpre, float* out, long long R, int F,
                     const Drop& dp, cudaStream_t st) {
  const long long total = R * F;
  const int grid = (int)lmin((total + 255) / 256, 132 * 16);
  relu_drop_kernel<<<grid, 256, 0, st>>>(src, hpre, out, total, F, dp);
  return cudaGetLastError();
}

inline int slot_attn(const float* qkv, const float* dattn, float* out, int B, const Drop& dp,
                     bool bwd, cudaStream_t st) {
  const int smem = (int)sizeof(float) * attn_smem_floats(dp.C, bwd);
  const int grid = (B * dp.T * H + kAttnWarps - 1) / kAttnWarps;
  cudaError_t e = bwd ? cudaFuncSetAttribute(slot_attn_bwd_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                      : cudaFuncSetAttribute(slot_attn_fwd_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (bwd)
    slot_attn_bwd_kernel<<<grid, 32 * kAttnWarps, smem, st>>>(qkv, dattn, out, B, dp);
  else
    slot_attn_fwd_kernel<<<grid, 32 * kAttnWarps, smem, st>>>(qkv, out, B, dp);
  return cudaGetLastError();
}

inline int fill(float* p, float v, long long n, cudaStream_t st) {
  fill_kernel<<<(int)lmin((n + 255) / 256, 1024), 256, 0, st>>>(p, v, n);
  return cudaGetLastError();
}

// A workspace cut into 16-byte aligned pieces; with a null base it only
// counts the floats (the wrapper asks for the size first).
struct Carve {
  float* base;
  size_t used = 0;
  float* take(size_t n) {
    float* p = base ? base + used : nullptr;
    used += (n + 3) / 4 * 4;
    return p;
  }
};

// the chunkwise retention forward over q | k | v columns of qkvg (stride 4D)
// into oh (stride D), from a zero state, writing the per-chunk checkpoints
// when kvs is not null; zkv/ones/kvf/sf are per-(sequence, head) scratch
inline int retention_fwd(const float* qkvg, float* oh, float* zkv, float* ones, float* kvf,
                         float* sf, float* kvs, float* ss, int BC, int T, int L, int C,
                         cudaStream_t st) {
  const long long rows = (long long)BC * H;
  cudaError_t e = cudaMemsetAsync(zkv, 0, sizeof(float) * rows * DK * DK, st);
  if (e != cudaSuccess) return e;
  int err = fill(ones, 1.f, rows, st);
  if (err) return err;
  cr::CoreArgs a{qkvg, qkvg + D, qkvg + 2 * D, 4 * D, 4 * D, 4 * D, oh, D, ones, 1,
                 zkv, ones, kvf, sf, H, T, L};
  a.kvs = kvs;
  a.ss = ss;
  a.ckC = C;
  return cr::launch_core<DK, DK>(a, (int)rows, st);
}

}  // namespace dtf
