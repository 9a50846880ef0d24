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
// enc_frame_scan.cu) run the forward row kernels at dropout 0; their bf16
// forms (built with FS_BF16) instantiate the forward kernels with bf16 data
// and rounding points (fs::rnd) where the TPU kernel rounds to its data type.
// The fusion layer's own bf16 forms (dec_train_fusion_{fwd,bwd}.cu with
// FS_BF16) instantiate them, and the backward kernels, with the rounding
// points of dec_train_fusion_pallas.py (template arguments below; a float32
// instantiation computes what it did before them).
#pragma once

#include <initializer_list>
#include <type_traits>

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

// the bf16 forms: a lane's NV bf16 values read to float, written rounded
__device__ __forceinline__ void load_row(const fs::bf16* p, float (&v)[NV]) {
  static_assert(NV % 2 == 0, "bf16 rows in pairs");
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p + lane_id() * NV);
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const float2 t = __bfloat1622float2(q[i]);
    v[2 * i] = t.x, v[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store_row(fs::bf16* p, const float (&v)[NV]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p + lane_id() * NV);
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
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
// (float32) is written to rsum when it is not null (the backward reads it),
// y when it is not null, and y rounded to bf16 to ylo when that is not null
// (the fusion layer's bf16 form keeps a float32 residual stream and feeds
// the next product its bf16 copy).  TX, TP, TY: the element types of x, of
// the norm's weights and of y (a is float32); a bf16 y is rounded where it
// is written.
template <typename TX, typename TP, typename TY>
__global__ void __launch_bounds__(256)
add_drop_ln_kernel(const TX* __restrict__ x, const float* __restrict__ a,
                   const TP* __restrict__ scale, const TP* __restrict__ bias,
                   float* __restrict__ rsum, TY* __restrict__ y, fs::bf16* __restrict__ ylo,
                   long long R, Drop dp, int site) {
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
    if (!y && !ylo) continue;
    const float mu = row_sum(v) / D;
    float d2[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) d2[i] = (v[i] - mu) * (v[i] - mu);
    const float rs = rsqrtf(row_sum(d2) / D + 1e-5f);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      v[i] = (v[i] - mu) * rs * fs::ldg(scale + c0 + i) + fs::ldg(bias + c0 + i);
    if (y) store_row(y + r * D, v);
    if (ylo) store_row(ylo + r * D, v);
  }
}

// Backward of add_drop_ln: from dy and the pre-norm sum rsum, dres = the
// gradient of the sum (written over dres, which may be dy) and dbranch =
// dres * mask(site); the block's column sums of the scale and bias
// gradients, over its rows in a fixed order, go to part[blockIdx.x] (2D
// floats: scale, then bias), which ln_bwd_reduce_kernel adds in block order.
// TD: dy's element type; TP: the scale's, and the bf16 form (TP = bf16)
// reads the normalized row rounded to bf16, as the TPU kernel stashes it.
template <typename TD, typename TP>
__global__ void __launch_bounds__(256)
ln_bwd_kernel(const TD* dy, const float* __restrict__ rsum, const TP* __restrict__ scale,
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
      v[i] = fs::rnd<TP>((v[i] - mu) * rs);  // xhat
      ds[i] += g[i] * v[i];
      db[i] += g[i];
      g[i] *= fs::ldg(scale + c0 + i);  // dxhat
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
// g has row stride ldg.  TG, TO: the element types of g and gated.  The
// frame scans' bf16 form (TG = bf16) rounds the group norm's output before
// the gate (dec_frame_scan_pallas.py); the fusion layer's training form
// (TG = float, TO = bf16) gates the float32 norm with the float32 g and
// rounds the product where it is written (dec_train_fusion_pallas.py:231-235)
template <typename TG, typename TO>
__global__ void __launch_bounds__(256)
gate_fwd_kernel(const float* __restrict__ oh, const TG* __restrict__ g, int ldg,
                TO* __restrict__ gated, long long R) {
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
    for (int i = 0; i < NV; ++i) t[i] = fs::silu(gv[i]) * fs::rnd<TG>((v[i] - mu) * rs);
    store_row(gated + r * D, t);
  }
}

// Backward of gate_fwd: from dgated, dg (stride ldg) = dgated * ohn *
// silu'(g) and doh = the group-norm backward of dgated * silu(g).  T = bf16
// reads g and the normalized ohn rounded to bf16, as the TPU kernel stashes
// them (dec_train_fusion_pallas.py:229, 291, 477-481); dglo, when not null,
// gets dg rounded to bf16 (stride lddg), the copy a bf16 product reads
template <typename T>
__global__ void __launch_bounds__(256)
gate_bwd_kernel(const float* __restrict__ dgated, const float* __restrict__ oh,
                const float* __restrict__ g, int ldg, float* __restrict__ dg, int lddg,
                float* __restrict__ doh, long long R, fs::bf16* __restrict__ dglo) {
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
      v[i] = fs::rnd<T>((v[i] - mu) * rs);  // ohn
      gv[i] = fs::rnd<T>(gv[i]);
      const float sg = fs::sigmoid(gv[i]);
      t[i] = dv[i] * v[i] * (sg * (1.f + gv[i] * (1.f - sg)));  // dg
      dv[i] *= gv[i] * sg;                                       // d ohn
      s1 += dv[i];
      s2 += dv[i] * v[i];
    }
    store_row(dg + r * lddg, t);
    if (dglo) store_row(dglo + r * lddg, t);
    const float m1 = group_sum(s1) / DK, m2 = group_sum(s2) / DK;
#pragma unroll
    for (int i = 0; i < NV; ++i) dv[i] = rs * (dv[i] - m1 - v[i] * m2);
    store_row(doh + r * D, dv);
  }
}

// out = src * (hpre > 0 ? mask(FFN hidden) : 0) over (R, F): relu + dropout
// forward (src = hpre) and backward (src = the gradient); a bf16 out is
// rounded where it is written
template <typename TO>
__global__ void relu_drop_kernel(const float* src, const float* hpre, TO* out, long long total,
                                 int F, Drop dp) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / F;
    const int f = (int)(e % F);
    const RowPos p = row_pos(dp, r);
    const float m = hpre[e] > 0.f
                        ? keep(dp, hash_base(dp, p.b, p.n, kFfh), (unsigned)(p.cl * F + f))
                        : 0.f;
    out[e] = fs::As<TO>::from(src[e] * m);
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

template <typename T>
__device__ __forceinline__ void load_slots(const T* qkv, const Drop& dp, const SlotView& s,
                                           float* qs, float* ks, float* vs) {
  for (int c = 0; c < dp.C; ++c) {
    const T* row = qkv + slot_row(dp, s, c) * 3 * D + s.h * DK;
    for (int d = lane_id(); d < DK; d += 32) {
      qs[c * DK + d] = fs::f32(row[d]);
      ks[c * DK + d] = fs::f32(row[D + d]);
      vs[c * DK + d] = fs::f32(row[2 * D + d]);
    }
  }
  __syncwarp();
}

// T = bf16: each product q k rounded to bf16 before the float32 sum, as the
// TPU kernel multiplies in its data type (dec_frame_scan_pallas.py:149)
template <typename T = float>
__device__ __forceinline__ void scores(const Drop& dp, const float* qs, const float* ks, float* W) {
  const int C = dp.C;
  const float inv = (float)(1.0 / sqrt((double)DK));
  for (int p = lane_id(); p < C * C; p += 32) {
    const int c = p / C, j = p % C;
    float s = 0.f;
    for (int d = 0; d < DK; ++d) s += fs::rnd<T>(qs[c * DK + d] * ks[j * DK + d]);
    W[p] = s * inv;
  }
  __syncwarp();
}

// T = bf16: the probabilities rounded to bf16, then multiplied by the
// dropout multiplier rounded to bf16 (the fusion layer's bf16 mask,
// dec_train_fusion_pallas.py:177-181, 262; 1 at dropout 0) and rounded
// again, each product p v too, the sum in float32 rounded to bf16 where it
// is written (dec_frame_scan_pallas.py:152-157)
template <typename T>
__global__ void slot_attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ attn, int B,
                                     Drop dp) {
  extern __shared__ __align__(16) float sm[];
  const SlotView s = slot_view(dp, B);
  if (!s.ok) return;
  const int C = dp.C;
  float* qs = sm + (threadIdx.x >> 5) * (attn_smem_floats(C, false) / kAttnWarps);
  float *ks = qs + C * DK, *vs = ks + C * DK, *W = vs + C * DK, *M = W + C * C;
  load_slots(qkv, dp, s, qs, ks, vs);
  scores<T>(dp, qs, ks, W);
  softmax_mask(dp, s, W, M);
  for (int c = 0; c < C; ++c) {
    T* out = attn + slot_row(dp, s, c) * D + s.h * DK;
    for (int d = lane_id(); d < DK; d += 32) {
      float o = 0.f;
      for (int j = 0; j < C; ++j)
        o += fs::rnd<T>(fs::rnd<T>(fs::rnd<T>(W[c * C + j]) * fs::rnd<T>(M[c * C + j])) *
                        vs[j * DK + d]);
      out[d] = fs::As<T>::from(o);
    }
  }
}

// dattn rows (stride D) -> dqkv rows (stride 3D): dq | dk | dv of the head.
// T = bf16 (qkv in bf16) as the TPU kernel's backward (:426-459): the scores'
// products rounded, the softmax weights and the dropout multiplier rounded
// to bf16, d(w * mask) from the products of dattn rounded to bf16 and v,
// each rounded; dv from the unrounded dattn.  dlo, when not null, gets
// dqkv rounded to bf16 (the copy a bf16 product reads)
template <typename T>
__global__ void slot_attn_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ dattn,
                                     float* __restrict__ dqkv, int B, Drop dp,
                                     fs::bf16* __restrict__ dlo) {
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
  scores<T>(dp, qs, ks, W);
  softmax_mask(dp, s, W, M);
  if constexpr (!std::is_same<T, float>::value) {
    for (int p = lane; p < C * C; p += 32) W[p] = fs::rnd<T>(W[p]), M[p] = fs::rnd<T>(M[p]);
    __syncwarp();
  }
  // d(w * mask), then through the mask
  for (int p = lane; p < C * C; p += 32) {
    const int c = p / C, j = p % C;
    float g = 0.f;
    for (int d = 0; d < DK; ++d) g += fs::rnd<T>(fs::rnd<T>(das[c * DK + d]) * vs[j * DK + d]);
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
      if (dlo) {
        fs::bf16* lo = dlo + slot_row(dp, s, c) * 3 * D + s.h * DK;
        lo[d] = __float2bfloat16_rn(gq);
        lo[D + d] = __float2bfloat16_rn(gk);
        lo[2 * D + d] = __float2bfloat16_rn(gv);
      }
    }
  }
}

// dst = src rounded to bf16: the copy a bf16 product reads of a float32
// gradient (the TPU kernel's `.astype(dt)` before a dot)
__global__ void round_kernel(const float* __restrict__ src, fs::bf16* __restrict__ dst,
                             long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

__global__ void fill_kernel(float* p, float v, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    p[i] = v;
}

// ---- launches: each returns cudaGetLastError() ----

inline long long lmin(long long a, long long b) { return a < b ? a : b; }

inline int row_grid(long long R) { return (int)lmin((R + 7) / 8, 132 * 8); }

template <typename TX, typename TP, typename TY>
inline int add_drop_ln(const TX* x, const float* a, const TP* scale, const TP* bias,
                       float* rsum, TY* y, long long R, const Drop& dp, int site,
                       cudaStream_t st, fs::bf16* ylo = nullptr) {
  add_drop_ln_kernel<TX, TP, TY><<<row_grid(R), 256, 0, st>>>(x, a, scale, bias, rsum, y, ylo, R,
                                                              dp, site);
  return cudaGetLastError();
}

// kLnBwdBlocks * 2D floats of `part` hold the blocks' column sums
constexpr int kLnBwdBlocks = 132 * 2;

template <typename TD, typename TP>
inline int ln_bwd(const TD* dy, const float* rsum, const TP* scale, float* dres,
                  float* dbranch, float* dscale, float* dbias, long long R, const Drop& dp,
                  int site, float* part, cudaStream_t st) {
  const int grid = (int)lmin((R + 7) / 8, kLnBwdBlocks);
  ln_bwd_kernel<TD, TP><<<grid, 256, 0, st>>>(dy, rsum, scale, dres, dbranch, part, R, dp, site);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_bwd_reduce_kernel<<<(2 * D + 255) / 256, 256, 0, st>>>(part, grid, dscale, dbias);
  return cudaGetLastError();
}

template <typename TG, typename TO>
inline int gate_fwd(const float* oh, const TG* g, int ldg, TO* gated, long long R,
                    cudaStream_t st) {
  gate_fwd_kernel<TG, TO><<<row_grid(R), 256, 0, st>>>(oh, g, ldg, gated, R);
  return cudaGetLastError();
}

template <typename T = float>
inline int gate_bwd(const float* dgated, const float* oh, const float* g, int ldg, float* dg,
                    int lddg, float* doh, long long R, cudaStream_t st,
                    fs::bf16* dglo = nullptr) {
  gate_bwd_kernel<T><<<row_grid(R), 256, 0, st>>>(dgated, oh, g, ldg, dg, lddg, doh, R, dglo);
  return cudaGetLastError();
}

template <typename TO>
inline int relu_drop(const float* src, const float* hpre, TO* out, long long R, int F,
                     const Drop& dp, cudaStream_t st) {
  const long long total = R * F;
  const int grid = (int)lmin((total + 255) / 256, 132 * 16);
  relu_drop_kernel<TO><<<grid, 256, 0, st>>>(src, hpre, out, total, F, dp);
  return cudaGetLastError();
}

// forward: out in qkv's element type; backward (bwd): out float32 (dqkv)
// and, when lo is not null, its bf16 copy
template <typename T, typename TO>
inline int slot_attn(const T* qkv, const float* dattn, TO* out, int B, const Drop& dp, bool bwd,
                     cudaStream_t st, fs::bf16* lo = nullptr) {
  const int smem = (int)sizeof(float) * attn_smem_floats(dp.C, bwd);
  const int grid = (B * dp.T * H + kAttnWarps - 1) / kAttnWarps;
  if constexpr (std::is_same<TO, float>::value) {
    if (bwd) {
      cudaError_t e = cudaFuncSetAttribute(slot_attn_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      slot_attn_bwd_kernel<T><<<grid, 32 * kAttnWarps, smem, st>>>(qkv, dattn, out, B, dp, lo);
      return cudaGetLastError();
    }
  }
  if constexpr (std::is_same<T, TO>::value) {
    cudaError_t e = cudaFuncSetAttribute(slot_attn_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    slot_attn_fwd_kernel<T><<<grid, 32 * kAttnWarps, smem, st>>>(qkv, out, B, dp);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

inline int round_bf16(const float* src, fs::bf16* dst, long long n, cudaStream_t st) {
  round_kernel<<<(int)lmin((n + 255) / 256, 132 * 16), 256, 0, st>>>(src, dst, n);
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
  fs::bf16* take16(size_t n) { return reinterpret_cast<fs::bf16*>(take((n + 1) / 2)); }
};

// the chunkwise retention forward over the q | k | v columns of qkv (row
// stride ld) into oh (stride D), from a zero state, writing the per-chunk
// checkpoints when kvs is not null; zkv/ones/kvf/sf are per-(sequence, head)
// scratch.  E: the element type of q, k and v (bf16: the core's bf16 form)
template <typename E>
inline int retention_fwd(const E* qkv, int ld, float* oh, float* zkv, float* ones, float* kvf,
                         float* sf, float* kvs, float* ss, int BC, int T, int L, int C,
                         cudaStream_t st) {
  const long long rows = (long long)BC * H;
  cudaError_t e = cudaMemsetAsync(zkv, 0, sizeof(float) * rows * DK * DK, st);
  if (e != cudaSuccess) return e;
  int err = fill(ones, 1.f, rows, st);
  if (err) return err;
  cr::CoreArgsE<E> a{qkv, qkv + D, qkv + 2 * D, ld, ld, ld, oh, D, ones, 1,
                     zkv, ones, kvf, sf, H, T, L};
  a.kvs = kvs;
  a.ss = ss;
  a.ckC = C;
  return cr::launch_core<DK, DK>(a, (int)rows, st);
}

}  // namespace dtf
