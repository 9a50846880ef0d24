// One decoder fusion layer in training semantics, backward, on Hopper,
// float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/dec_train_fusion_pallas.py
// (_bwd_call and its _bwd_kernel): from x, dy, the per-chunk state
// checkpoints (kvs, ss) and the dropout seed, dx and the 14 weight
// gradients of the layer that dtf_forward computes.
//
// What bounds it on the card: operations, about three times the forward's:
// the forward is recomputed once, and every product of the backward is two
// (the input gradient and the weight gradient).  0.84 TFLOP at the T3 shape
// (B 8, C 10, T 1024, D 256, F 2048): 12.5 ms of the FMA pipe, about 5.1 ms
// of the tensor cores at three TF32 passes.
//
// The TPU kernel recomputes each chunk's forward in VMEM inside its reverse
// sweep.  Here the recompute runs first, over the whole layer: the
// forward's own sequence (dec_train_fusion_seq.cuh) into a workspace, so
// the recomputed activations are the forward's to the bit (x, dy and the
// checkpoints are all the backward reads from the forward, as in the JAX
// contract), and the backward then runs layer-wide, in reverse:
//   ln_bwd (LN3) -> wgrad, colsum, linear (FFN out) -> relu_drop (the same
//   kernel: mask * relu') -> wgrad, colsum, linear accumulated (FFN in) ->
//   ln_bwd (LN2) -> ... slot_attn backward ... -> ln_bwd (LN1) -> out
//   projection -> gate_bwd -> core_bwd_kernel -> the q | k | v | g products.
// Every product runs on the tensor cores, float32-exact (tc_f32.cuh): the
// recompute's as A W with the transposed weights (in, out), the input
// gradients dX = G W with the weights as they are (out, in), accumulated
// into dx where the residual stream's gradient gathers.  Weight gradients
// G = A^T X over all B*C*T rows (tc::wgrad_kernel), bias gradients (column
// sums) and the LayerNorms' scale and bias gradients are sums over row
// slices added in a fixed order, with no atomics: every gradient comes out
// the same to the bit from run to run.
//
// core_bwd_kernel is the retention core's backward: one block per (b, c,
// head), the chunks in reverse, carrying dS, the cotangent of the state
// after the chunk, in shared memory (zero after the last chunk).  Chunk n's
// k and v gradients take dS_n alone; the chunk's cross read adds
// qid^T (doh / all) to make dS_{n-1}.  The row sums, the incoming scale and
// their max are constants (the reference detaches them).  A chunk of L rows
// is walked in tiles of 64 rows held in shared memory, and every product
// (the masked L x L score tiles S = mask * Q K~^T and Dm = mask * P V^T, and
// the dk x dk state products) runs on the tensor cores (tc_f32.cuh, small
// parts rounded to nearest): a pass for the row sums, one over the key tiles
// for dk and dv, one over the query tiles for dq, one for dS.  Each
// gradient element is one warp's complete sum, so no element is added to
// twice.
//
// The bf16 form (built with FS_BF16; the float32 build is the code above
// unchanged) takes bf16 x, dy and weights, writes a bf16 dx and the 14
// weight gradients summed in float32 and rounded to bf16 (the JAX VJP's
// `like`, dec_train_fusion_pallas.py:724-725), at _bwd_kernel's rounding
// points (:337-535): the recompute is the bf16 sequence (forward_seq16);
// the LayerNorm backward reads the normalized rows rounded to bf16; every
// gradient is rounded to bf16 before it enters a product (a bf16 copy beside
// the float32 one that the bias gradients sum), each product one bf16
// tensor-core pass (tc_bf16.cuh: the input gradients accumulated into a
// float32 residual stream, the weight gradients by wgrad_bf16_kernel in the
// same fixed-order row slices); the slot attention's and the gate's
// backward read the rounded weights, g and ohn; core_bwd_kernel<true>
// rounds doh (is / all), doh (c / all), KV / c, q idec, the masked dqk and
// dS before their products, whose operands, all bf16 values, it holds in
// float32 tiles and packs to bf16 as it reads them: each product one bf16
// mma.sync pass (warp_mma16).  The same bits from run to run, as the
// float32 form.
#include "dec_train_fusion_seq.cuh"
#if defined(FS_BF16) && DTF_D == 256 && CR_DK == 64
#define DTF_TC16 1
#include "dtf_tc16.cuh"
#endif

using namespace dtf;

namespace {

#ifdef FS_BF16
using E = fs::bf16;
#else
using E = float;
#endif

template <bool BF>
struct CoreBwdArgs {
  const E *q, *k, *v;  // rows of stride ldq (the q | k | v columns)
  int ldq;
  float* p;  // doh in (stride ldp), doh / all out (BF: doh (inner / all) rounded)
  float* pc;  // BF: doh (c / all) rounded out (stride ldp)
  int ldp;
  float *dq, *dk, *dv;  // stride ldd
  int ldd;
  const float *kvs, *ss;
  int C, T, L;
  float kscale;
};

constexpr int kBt = 64;        // rows of a tile
constexpr int kLdt = DK + 4;   // row stride of the (rows, DK) tiles
constexpr int kLdx = kBt + 4;  // row stride of the (kBt, kBt) score tiles
constexpr int NJD = DK / 16;   // 8-column mma tiles of a warp's half of DK
constexpr int NJS = kBt / 16;  // 8-column mma tiles of a warp's half of a score tile

constexpr int core_smem_floats(int L, bool bf) {
  return (bf ? 5 : 4) * kBt * kLdt + 2 * kBt * kLdx + 2 * DK * kLdt + (bf ? 4 : 3) * L;
}

// acc[j] += A B for a warp's 16 rows and NJ * 8 columns over kn (a multiple
// of 8): A(m, k) with m < 16, B(k, n) with n < 8 NJ, both read from shared
// memory by the caller's accessors
template <int NJ, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NJ][4], int kn, FA A, FB Bm) {
  const int g = tc::lane_g(), t = tc::lane_t();
  for (int k0 = 0; k0 < kn; k0 += 8) {
    tc::FragA fa;
    tc::set_a<true>(fa, A(g, k0 + t), A(g + 8, k0 + t), A(g, k0 + t + 4), A(g + 8, k0 + t + 4));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      tc::FragB fb;
      tc::split_rn(Bm(k0 + t, 8 * j + g), fb.big[0], fb.small[0]);
      tc::split_rn(Bm(k0 + t + 4, 8 * j + g), fb.big[1], fb.small[1]);
      tc::mma3(acc[j], fa, fb);
    }
  }
}

#ifdef FS_BF16
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// warp_mma on operands that hold bf16 values (the bf16 form's): each pair
// packed to bf16 (exact) as it is read, one bf16 tensor-core pass
// (tc::mma_bf16) per 16 of k; kn a multiple of 16
template <int NJ, class FA, class FB>
__device__ __forceinline__ void warp_mma16(float (&acc)[NJ][4], int kn, FA A, FB Bm) {
  const int g = tc::lane_g(), t = tc::lane_t();
  for (int k0 = 0; k0 < kn; k0 += 16) {
    const int k = k0 + 2 * t;
    const uint32_t fa[4] = {
        pack_bf16(A(g, k), A(g, k + 1)), pack_bf16(A(g + 8, k), A(g + 8, k + 1)),
        pack_bf16(A(g, k + 8), A(g, k + 9)), pack_bf16(A(g + 8, k + 8), A(g + 8, k + 9))};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = 8 * j + g;
      const uint32_t fb[2] = {pack_bf16(Bm(k, n), Bm(k + 1, n)),
                              pack_bf16(Bm(k + 8, n), Bm(k + 9, n))};
      tc::mma_bf16(acc[j], fa, fb);
    }
  }
}
#endif

// the core backward's products: float32-exact (warp_mma) in the float32
// form, one bf16 pass (warp_mma16) in the bf16 form
template <bool BF, int NJ, class FA, class FB>
__device__ __forceinline__ void kmma(float (&acc)[NJ][4], int kn, FA A, FB Bm) {
#ifdef FS_BF16
  if constexpr (BF) {
    warp_mma16(acc, kn, A, Bm);
    return;
  }
#endif
  warp_mma(acc, kn, A, Bm);
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// f(m, n, v) for each accumulator element of a warp: row m < 16, column n
template <int NJ, class F>
__device__ __forceinline__ void each(const float (&acc)[NJ][4], F f) {
  const int g = tc::lane_g(), t = tc::lane_t();
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) f(g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1), acc[j][e]);
}

// rows [r0, r0 + kBt) of a (L, DK) operand of row stride ld into a tile,
// rows at or past L zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int ld, int r0, int L) {
  for (int i = threadIdx.x; i < kBt * (DK / 4); i += blockDim.x) {
    const int r = i / (DK / 4), c = (i % (DK / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L) v = fs::load4(src + (size_t)(r0 + r) * ld + c);
    *reinterpret_cast<float4*>(dst + r * kLdt + c) = v;
  }
}

template <bool BF>
__global__ void __launch_bounds__(256) core_bwd_kernel(CoreBwdArgs<BF> a) {
  extern __shared__ __align__(16) float sm[];
  float* Qi = sm;                 // (kBt, kLdt) query-side tile of q
  float* Pi = Qi + kBt * kLdt;    // (kBt, kLdt) query-side tile of doh / all
  float* Kj = Pi + kBt * kLdt;    // (kBt, kLdt) key-side tile of k~
  float* Vj = Kj + kBt * kLdt;    // (kBt, kLdt) key-side tile of v
  float* Sx = Vj + kBt * kLdt;    // (kBt, kLdx) the tile of S
  float* Dx = Sx + kBt * kLdx;    // (kBt, kLdx) the tile of Dm
  float* KV = Dx + kBt * kLdx;    // (DK, kLdt) the state the chunk read, [k][v]
  float* dS = KV + DK * kLdt;     // (DK, kLdt) the state cotangent, [k][v]
  const int L = a.L, T = a.T, N = T / L, ld = a.ldq, nb = (L + kBt - 1) / kBt;
  float* all = dS + DK * kLdt;    // (L) the row renormalizers
  float* rsq = all + L;           // (L) 1 / sqrt(i + 1)
  float* scl = rsq + L;           // (L) sqrt(L) / sqrt(i + 1)
  float* inr = scl + L;           // BF: (L) the inner row sums, max(sum, 1)
  float* Ci = inr + L;            // BF: (kBt, kLdt) query-side tile of doh (c / all)
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = 16 * (warp >> 1);                 // the warp's 16 rows of a 64-row output
  const int wcs = (kBt / 2) * (warp & 1);          // its half of a score tile's columns
  const int wcd = (DK / 2) * (warp & 1);           // its half of DK
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float sqL = sqrtf((float)L), wlast = (float)(1.0 / sqrt((double)L));

  for (int i = tid; i < DK * kLdt; i += blockDim.x) dS[i] = 0.f;
  for (int i = tid; i < L; i += blockDim.x) {
    rsq[i] = 1.f / sqrtf(i + 1.f);
    scl[i] = sqL / sqrtf(i + 1.f);
  }
  // S tile (I, J) into Sx: mask * (Qi Kj^T) / sqrt(i + 1); `norm` (BF):
  // divided by the row's inner sum and rounded to bf16
  auto score = [&](float* X, const float* Aop, const float* Bop, int I, int J, bool norm) {
    float acc[NJS][4];
    zero(acc);
    kmma<BF>(acc, DK, [&](int m, int k) { return Aop[(wr + m) * kLdt + k]; },
             [&](int k, int n) { return Bop[(wcs + n) * kLdt + k]; });
    each(acc, [&](int m, int n, float v) {
      const int i = I * kBt + wr + m, j = J * kBt + wcs + n;
      float x = j <= i && i < L ? v * rsq[i] : 0.f;
      if (BF && norm && i < L) x = fs::rnd<fs::bf16>(x / inr[i]);
      X[(wr + m) * kLdx + wcs + n] = x;
    });
  };
  for (int n = N - 1; n >= 0; --n) {
    const size_t row0 = (size_t)b * T + (size_t)n * L;
    const E* q = a.q + row0 * ld + h * DK;
    const E* k = a.k + row0 * ld + h * DK;
    const E* v = a.v + row0 * ld + h * DK;
    float* P = a.p + row0 * a.ldp + h * DK;
    float* PC = BF ? a.pc + row0 * a.ldp + h * DK : nullptr;
    const size_t slot = (((size_t)(b / a.C) * N + n) * H + h) * a.C + b % a.C;
    const float s_in = a.ss[slot];
    __syncthreads();  // the last chunk is done with every tile
    for (int i = tid; i < DK * DK; i += blockDim.x) {  // BF: KV / c rounded
      const float x = a.kvs[slot * DK * DK + i];
      KV[(i / DK) * kLdt + i % DK] = BF ? fs::rnd<fs::bf16>(x / s_in) : x;
    }
    for (int i = tid; i < L; i += blockDim.x) all[i] = 0.f;
    // ---- the row sums of |S|, then P = doh / max(max(sum, 1), s_in) ----
    for (int I = 0; I < nb; ++I) {
      __syncthreads();
      load_tile(Qi, q, ld, I * kBt, L);
      for (int J = 0; J <= I; ++J) {
        load_tile(Kj, k, ld, J * kBt, L);
        __syncthreads();
        score(Sx, Qi, Kj, I, J, false);
        __syncthreads();
        {  // four threads a row, 16 columns each
          const int r = tid >> 2, c0 = (tid & 3) * 16;
          float sum = 0.f;
          for (int c = 0; c < 16; ++c) sum += fabsf(Sx[r * kLdx + c0 + c]);
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          if ((tid & 3) == 0 && I * kBt + r < L) all[I * kBt + r] += sum;
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < L; i += blockDim.x) {
      if (BF) inr[i] = fmaxf(all[i], 1.f);
      all[i] = fmaxf(fmaxf(all[i], 1.f), s_in);
    }
    __syncthreads();
    for (int e = tid; e < L * DK; e += blockDim.x) {
      float* p = P + (size_t)(e / DK) * a.ldp + e % DK;
      if constexpr (BF) {  // dinner, dcross rounded
        const float d = *p;
        PC[(size_t)(e / DK) * a.ldp + e % DK] = fs::rnd<fs::bf16>(d * (s_in / all[e / DK]));
        *p = fs::rnd<fs::bf16>(d * (inr[e / DK] / all[e / DK]));
      } else {
        *p /= all[e / DK];
      }
    }
    __syncthreads();  // P is read back by the tiles below
    // ---- per key tile J: dv = S^T P + (K dS) / sqrt(L),
    //      dk = (Dm^T Q + (V dS^T) / sqrt(L)) kscale ----
    for (int J = 0; J < nb; ++J) {
      __syncthreads();
      load_tile(Kj, k, ld, J * kBt, L);
      load_tile(Vj, v, ld, J * kBt, L);
      float dv[NJD][4], dk[NJD][4];
      zero(dv);
      zero(dk);
      for (int I = J; I < nb; ++I) {
        __syncthreads();
        load_tile(Qi, q, ld, I * kBt, L);
        load_tile(Pi, P, a.ldp, I * kBt, L);
        __syncthreads();
        score(Sx, Qi, Kj, I, J, true);
        score(Dx, Pi, Vj, I, J, true);
        __syncthreads();
        kmma<BF>(dv, kBt, [&](int m, int kk) { return Sx[kk * kLdx + wr + m]; },
                 [&](int kk, int c) { return Pi[kk * kLdt + wcd + c]; });
        kmma<BF>(dk, kBt, [&](int m, int kk) { return Dx[kk * kLdx + wr + m]; },
                 [&](int kk, int c) { return Qi[kk * kLdt + wcd + c]; });
      }
      float kd[NJD][4], vd[NJD][4];
      zero(kd);
      zero(vd);
      // BF: dS rounded before its products
      auto dSr = [&](int i) { return BF ? fs::rnd<fs::bf16>(dS[i]) : dS[i]; };
      kmma<BF>(kd, DK, [&](int m, int u) { return Kj[(wr + m) * kLdt + u]; },
               [&](int u, int c) { return dSr(u * kLdt + wcd + c); });
      kmma<BF>(vd, DK, [&](int m, int u) { return Vj[(wr + m) * kLdt + u]; },
               [&](int u, int c) { return dSr((wcd + c) * kLdt + u); });
      const int j0 = J * kBt + wr;
      const int ldd = a.ldd;
      each(dv, [&](int m, int c, float x) {
        if (j0 + m < L) a.dv[(row0 + j0 + m) * ldd + h * DK + wcd + c] = x;
      });
      each(kd, [&](int m, int c, float x) {
        if (j0 + m < L) a.dv[(row0 + j0 + m) * ldd + h * DK + wcd + c] += x * wlast;
      });
      each(dk, [&](int m, int c, float x) {
        if (j0 + m < L) a.dk[(row0 + j0 + m) * ldd + h * DK + wcd + c] = x;
      });
      each(vd, [&](int m, int c, float x) {
        float* o = a.dk + (row0 + j0 + m) * ldd + h * DK + wcd + c;
        if (j0 + m < L) *o = (*o + x * wlast) * a.kscale;
      });
    }
    // ---- per query tile I: dq = Dm K~ + (P KV^T) sqrt(L) / sqrt(i + 1)
    //      (BF: the cross term from doh (c / all) and KV / c) ----
    const float* Pcr = BF ? Ci : Pi;
    for (int I = 0; I < nb; ++I) {
      __syncthreads();
      load_tile(Pi, P, a.ldp, I * kBt, L);
      if (BF) load_tile(Ci, PC, a.ldp, I * kBt, L);
      float dq[NJD][4];
      zero(dq);
      for (int J = 0; J <= I; ++J) {
        __syncthreads();
        load_tile(Kj, k, ld, J * kBt, L);
        load_tile(Vj, v, ld, J * kBt, L);
        __syncthreads();
        score(Dx, Pi, Vj, I, J, true);
        __syncthreads();
        kmma<BF>(dq, kBt, [&](int m, int jj) { return Dx[(wr + m) * kLdx + jj]; },
                 [&](int jj, int c) { return Kj[jj * kLdt + wcd + c]; });
      }
      float cr[NJD][4];
      zero(cr);
      kmma<BF>(cr, DK, [&](int m, int u) { return Pcr[(wr + m) * kLdt + u]; },
               [&](int u, int c) { return KV[(wcd + c) * kLdt + u]; });
      const int i0 = I * kBt + wr;
      each(dq, [&](int m, int c, float x) {
        if (i0 + m < L) a.dq[(row0 + i0 + m) * a.ldd + h * DK + wcd + c] = x;
      });
      each(cr, [&](int m, int c, float x) {
        if (i0 + m < L) a.dq[(row0 + i0 + m) * a.ldd + h * DK + wcd + c] += x * scl[i0 + m];
      });
    }
    // ---- dS += (Q sqrt(L) / sqrt(i + 1))^T P, a warp's 16 rows of k
    //      (BF: q idec rounded, against doh (c / all), then / c) ----
    float ds[NJD][4];
    zero(ds);
    for (int I = 0; I < nb; ++I) {
      __syncthreads();
      load_tile(Qi, q, ld, I * kBt, L);
      load_tile(Pi, BF ? PC : P, a.ldp, I * kBt, L);
      __syncthreads();
      if (wr < DK)
        kmma<BF>(ds, kBt,
                 [&](int m, int i) {
                   const int r = I * kBt + i;
                   const float x = r < L ? Qi[i * kLdt + wr + m] * scl[r] : 0.f;
                   return BF ? fs::rnd<fs::bf16>(x) : x;
                 },
                 [&](int i, int u) { return Pi[i * kLdt + wcd + u]; });
    }
    __syncthreads();  // every read of dS_n is done
    if (wr < DK)
      each(ds, [&](int m, int u, float x) {
        dS[(wr + m) * kLdt + wcd + u] += BF ? x / s_in : x;
      });
  }
}

#ifndef FS_BF16
struct BwdBufs {
  SeqBufs fw;  // the recompute's activations (dec_train_fusion_seq.cuh)
  float *g2, *gF, *dqkv, *dqkvg, *doh;
};

size_t carve_bwd(float* base, int BC, int T, int L, int F, BwdBufs* b) {
  const size_t R = (size_t)BC * T, rows = (size_t)BC * H;
  Carve c{base};
  SeqBufs& f = b->fw;
  f = SeqBufs{};
  f.qkvg = c.take(R * 4 * D);
  for (float** p : {&f.oh, &f.gated, &f.a, &f.r1, &f.x1}) *p = c.take(R * D);
  f.qkv = c.take(R * 3 * D);
  for (float** p : {&f.attn, &f.s, &f.r2, &f.x2}) *p = c.take(R * D);
  f.hpre = c.take(R * F);
  f.hdrop = c.take(R * F);
  for (float** p : {&f.f, &f.r3, &b->g2, &b->doh}) *p = c.take(R * D);
  b->gF = c.take(R * F);
  b->dqkv = c.take(R * 3 * D);
  b->dqkvg = c.take(R * 4 * D);
  f.zkv = c.take(rows * DK * DK);
  f.kvf = c.take(rows * DK * DK);
  f.ones = c.take(rows);
  f.sf = c.take(rows);
  f.part = c.take(tc::kSplitFloats);  // partial sums of the products and the gradients' row slices
  return c.used;
}

}  // namespace

// floats of workspace dtf_backward needs
extern "C" size_t dtf_bwd_workspace(int BC, int T, int L, int H_, int F) {
  BwdBufs b;
  return H_ == H ? carve_bwd(nullptr, BC, T, L, F, &b) : 0;
}

// x, dy, dx (B, C, T, D); kvs, ss as dtf_forward writes them; w* the 14
// weights and t* the transposes (in, out) of wqkvg, wro, wmi, wmo, wf1, wf2;
// g* the 14 gradients in the weights' layouts, each written once.  Returns
// the first CUDA error of the launches.
extern "C" int dtf_backward(const float* x, const float* dy, const float* kvs, const float* ss,
                            const float* wqkvg, const float* bqkvg, const float* wro,
                            const float* bro, const float* wmi, const float* bmi,
                            const float* wmo, const float* bmo, const float* wf1,
                            const float* bf1, const float* wf2, const float* bf2,
                            const float* lns, const float* lnb, const float* tqkvg,
                            const float* tro, const float* tmi, const float* tmo,
                            const float* tf1, const float* tf2, float* dx, float* gqkvg,
                            float* gbqkvg, float* gro, float* gbro, float* gmi, float* gbmi,
                            float* gmo, float* gbmo, float* gf1, float* gbf1, float* gf2,
                            float* gbf2, float* glns, float* glnb, float* ws, int B, int C,
                            int T, int L, int F, unsigned seed, unsigned thr, float mult,
                            void* stream_) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const int BC = B * C, R = BC * T;
  const Drop dp{seed, thr, mult, C, T, L};
  const float kscale = (float)(1.0 / sqrt((double)DK));
  BwdBufs bb;
  carve_bwd(ws, BC, T, L, F, &bb);
  const SeqBufs& b = bb.fw;
  float* part = b.part;
  int err;
#define DTF_TRY(call) \
  if ((err = (call)) != 0) return err
  // ---- recompute the forward: the forward's own sequence ----
  const SeqWeights sw{tqkvg, bqkvg, tro, bro, tmi, bmi, tmo, bmo, tf1, bf1, tf2, bf2, lns, lnb};
  DTF_TRY(forward_seq(x, sw, b, B, C, T, L, F, dp, st));
  // ---- backward; dx carries the residual stream's gradient ----
  // LN3 and the FFN
  DTF_TRY(ln_bwd(dy, b.r3, lns + 2 * D, dx, bb.g2, glns + 2 * D, glnb + 2 * D, R, dp, kFfo, part,
                 st));
  DTF_TRY(tc::launch_wgrad(bb.g2, D, b.hdrop, F, gf2, R, D, F, st, part));
  DTF_TRY(tc::launch_colsum(bb.g2, D, gbf2, R, D, st, part));
  DTF_TRY(mm(bb.g2, wf2, nullptr, bb.gF, R, F, D, st, part));
  DTF_TRY(relu_drop(bb.gF, b.hpre, bb.gF, R, F, dp, st));
  DTF_TRY(tc::launch_wgrad(bb.gF, F, b.x2, D, gf1, R, F, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.gF, F, gbf1, R, F, st, part));
  DTF_TRY(mm_add(bb.gF, wf1, dx, R, F, st, part));
  // LN2 and the slot attention
  DTF_TRY(ln_bwd(dx, b.r2, lns + D, dx, bb.g2, glns + D, glnb + D, R, dp, kMha, part, st));
  DTF_TRY(tc::launch_wgrad(bb.g2, D, b.attn, D, gmo, R, D, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.g2, D, gbmo, R, D, st, part));
  DTF_TRY(mm(bb.g2, wmo, nullptr, b.a, R, D, D, st, part));
  DTF_TRY(slot_attn(b.qkv, b.a, bb.dqkv, B, dp, true, st));
  DTF_TRY(tc::launch_wgrad(bb.dqkv, 3 * D, b.x1, D, gmi, R, 3 * D, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.dqkv, 3 * D, gbmi, R, 3 * D, st, part));
  DTF_TRY(mm_add(bb.dqkv, wmi, dx, R, 3 * D, st, part));
  // LN1, the out projection and the gate
  DTF_TRY(ln_bwd(dx, b.r1, lns, dx, bb.g2, glns, glnb, R, dp, kRet, part, st));
  DTF_TRY(tc::launch_wgrad(bb.g2, D, b.gated, D, gro, R, D, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.g2, D, gbro, R, D, st, part));
  DTF_TRY(mm(bb.g2, wro, nullptr, b.a, R, D, D, st, part));
  DTF_TRY(gate_bwd(b.a, b.oh, b.qkvg + 3 * D, 4 * D, bb.dqkvg + 3 * D, 4 * D, bb.doh, R, st));
  // the retention core, then its projections
  CoreBwdArgs<false> ca{b.qkvg, b.qkvg + D, b.qkvg + 2 * D, 4 * D, bb.doh, nullptr, D,
                        bb.dqkvg, bb.dqkvg + D, bb.dqkvg + 2 * D, 4 * D, kvs, ss, C, T, L,
                        kscale};
  const int smem = (int)sizeof(float) * core_smem_floats(L, false);
  cudaError_t e = cudaFuncSetAttribute(core_bwd_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  core_bwd_kernel<false><<<BC * H, 256, smem, st>>>(ca);
  DTF_TRY(cudaGetLastError());
  DTF_TRY(tc::launch_wgrad(bb.dqkvg, 4 * D, x, D, gqkvg, R, 4 * D, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.dqkvg, 4 * D, gbqkvg, R, 4 * D, st, part));
  DTF_TRY(mm_add(bb.dqkvg, wqkvg, dx, R, 4 * D, st, part));
#undef DTF_TRY
  return 0;
}
#else  // FS_BF16

struct BwdBufs16 {
  SeqBufs16 fw;  // the recompute's activations (dec_train_fusion_seq.cuh)
  float *dxf, *g2, *gF, *dqkv, *dqkvg, *doh, *pc, *da, *grads;
  bf16 *g2lo, *gFlo, *dqkvlo, *dqkvglo;
};

#ifdef DTF_TC16
// At the production width (D 256, head dim 64, F a multiple of 128) the
// bf16 backward is dtf_tc16.cuh's: the recompute from the checkpoints, then
// wgmma input and weight gradients with the masks, roundings and bias
// sums in their epilogues, the chunk-parallel core backward, and no
// rounding pass but the outputs' own.  Other widths keep the sequence below.
inline bool tc16_width(int F) { return F % 128 == 0; }

size_t carve_bwd_tc16(float* base, int BC, int T, int L, int F, t16::BwdBufs16* b) {
  const size_t R = (size_t)BC * T;
  Carve c{base};
  *b = t16::BwdBufs16{};
  t16::Bufs16& f = b->fw;
  for (bf16** p : {&f.qkv, &f.mqkv}) *p = c.take16(R * 3 * D);
  for (bf16** p : {&f.gated, &f.x1lo, &f.attn, &f.x2lo, &b->g2lo}) *p = c.take16(R * D);
  for (float** p : {&f.g, &f.x1, &f.x2, &f.r1, &f.r2, &f.r3, &f.oh, &b->dxf, &b->d32, &b->doh})
    *p = c.take(R * D);
  f.inr = c.take(R * H);
  for (bf16** p : {&f.hdrop, &b->gFlo}) *p = c.take16(R * F);
  f.bits = reinterpret_cast<uint32_t*>(c.take(t16::bits_words((long long)R, F)));
  b->dqkv = c.take(R * 3 * D);
  b->dqkvlo = c.take16(R * 3 * D);
  b->dqkvg = c.take(R * 4 * D);
  b->dqkvglo = c.take16(R * 4 * D);
  b->dS = c.take((size_t)BC * H * (T / L) * DK * DK);
  b->colpart = c.take((R + t16::kBM - 1) / t16::kBM * 8 * F);  // a row per warp of each block
  b->part = c.take(tc::kSplitFloats);
  return c.used;
}
#endif

// the 14 gradients' float32 sums, packed in FusionWeights order
size_t grad_floats(int F) {
  return (size_t)4 * D * D + 4 * D + 2 * (D * D + D) + 3 * D * D + 3 * D + 2 * (size_t)F * D + F +
         D + 6 * D;
}

size_t carve_bwd16(float* base, int BC, int T, int L, int F, BwdBufs16* b) {
  const size_t R = (size_t)BC * T, rows = (size_t)BC * H;
  Carve c{base};
  SeqBufs16& f = b->fw;
  f = SeqBufs16{};
  f.qkv = c.take16(R * 3 * D);
  f.mqkv = c.take16(R * 3 * D);
  for (bf16** p : {&f.gated, &f.x1lo, &f.attn, &f.x2lo}) *p = c.take16(R * D);
  for (float** p : {&f.g, &f.oh, &f.br, &f.x1, &f.x2, &f.r1, &f.r2, &f.r3}) *p = c.take(R * D);
  f.hpre = c.take(R * F);
  f.hdrop = c.take16(R * F);
  for (float** p : {&b->dxf, &b->g2, &b->doh, &b->pc, &b->da}) *p = c.take(R * D);
  b->gF = c.take(R * F);
  b->dqkv = c.take(R * 3 * D);
  b->dqkvg = c.take(R * 4 * D);
  b->g2lo = c.take16(R * D);
  b->gFlo = c.take16(R * F);
  b->dqkvlo = c.take16(R * 3 * D);
  b->dqkvglo = c.take16(R * 4 * D);
  b->grads = c.take(grad_floats(F));
  f.zkv = c.take(rows * DK * DK);
  f.kvf = c.take(rows * DK * DK);
  f.ones = c.take(rows);
  f.sf = c.take(rows);
  f.part = c.take(tc::kSplitFloats);  // partial sums of the products and the gradients' row slices
  return c.used;
}

}  // namespace

// floats of workspace dtf_backward needs
extern "C" size_t dtf_bwd_workspace(int BC, int T, int L, int H_, int F) {
#ifdef DTF_TC16
  if (tc16_width(F)) {
    t16::BwdBufs16 b;
    return H_ == H ? carve_bwd_tc16(nullptr, BC, T, L, F, &b) : 0;
  }
#endif
  BwdBufs16 b;
  return H_ == H ? carve_bwd16(nullptr, BC, T, L, F, &b) : 0;
}

// The bf16 form: x, dy, dx, the weights, their transposes and the 14
// gradients bf16; kvs, ss and ws float32.  Returns the first CUDA error of
// the launches.
extern "C" int dtf_backward(const E* x, const E* dy, const float* kvs, const float* ss,
                            const E* wqkvg, const E* bqkvg, const E* wro, const E* bro,
                            const E* wmi, const E* bmi, const E* wmo, const E* bmo, const E* wf1,
                            const E* bf1, const E* wf2, const E* bf2, const E* lns, const E* lnb,
                            const E* tqkvg, const E* tro, const E* tmi, const E* tmo,
                            const E* tf1, const E* tf2, E* dx, E* gqkvg, E* gbqkvg, E* gro,
                            E* gbro, E* gmi, E* gbmi, E* gmo, E* gbmo, E* gf1, E* gbf1, E* gf2,
                            E* gbf2, E* glns, E* glnb, float* ws, int B, int C, int T, int L,
                            int F, unsigned seed, unsigned thr, float mult, void* stream_) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const int BC = B * C, R = BC * T;
  const Drop dp{seed, thr, mult, C, T, L};
  const float kscale = (float)(1.0 / sqrt((double)DK));
#ifdef DTF_TC16
  if (tc16_width(F)) {
    t16::BwdBufs16 tb;
    carve_bwd_tc16(ws, BC, T, L, F, &tb);
    tb.fw.kvs = const_cast<float*>(kvs);  // read only: the recompute's chunks read their states
    tb.fw.ss = const_cast<float*>(ss);
    const t16::W16 w{wqkvg, bqkvg, wro, bro, wmi, bmi, wmo, bmo, wf1, bf1, wf2, bf2, lns, lnb};
    const t16::WT16 wt{tqkvg, tro, tmi, tmo, tf1, tf2};
    const t16::Grads16 gr{gqkvg, gbqkvg, gro, gbro, gmi, gbmi, gmo, gbmo, gf1, gbf1, gf2, gbf2,
                          glns, glnb};
    return t16::backward_tc16(x, dy, kvs, ss, w, wt, gr, dx, tb, B, C, T, L, F, dp, st);
  }
#endif
  BwdBufs16 bb;
  carve_bwd16(ws, BC, T, L, F, &bb);
  const SeqBufs16& f = bb.fw;
  float* part = f.part;
  // the gradients' float32 sums, FusionWeights order, then rounded to bf16
  float* gs[14];
  const size_t sizes[14] = {(size_t)4 * D * D, (size_t)4 * D, (size_t)D * D, (size_t)D,
                            (size_t)3 * D * D, (size_t)3 * D, (size_t)D * D, (size_t)D,
                            (size_t)F * D, (size_t)F, (size_t)D * F, (size_t)D,
                            (size_t)3 * D, (size_t)3 * D};
  E* const outs[14] = {gqkvg, gbqkvg, gro, gbro, gmi, gbmi, gmo, gbmo, gf1, gbf1, gf2, gbf2,
                       glns, glnb};
  gs[0] = bb.grads;
  for (int i = 1; i < 14; ++i) gs[i] = gs[i - 1] + sizes[i - 1];
  int err;
#define DTF_TRY(call) \
  if ((err = (call)) != 0) return err
  // a float32 gradient and its bf16 copy for the products
#define DTF_ROUND(src, dst, n) DTF_TRY(round_bf16(src, dst, (long long)(n), st))
  // ---- recompute the forward: the forward's own sequence ----
  const SeqWeights16 sw{tqkvg, bqkvg, tro, bro, tmi, bmi, tmo, bmo, tf1, bf1, tf2, bf2, lns, lnb};
  DTF_TRY(forward_seq16(x, sw, f, B, C, T, L, F, dp, st));
  // ---- backward; dxf carries the residual stream's gradient in float32 ----
  // LN3 and the FFN
  DTF_TRY(ln_bwd(dy, f.r3, lns + 2 * D, bb.dxf, bb.g2, gs[12] + 2 * D, gs[13] + 2 * D, R, dp,
                 kFfo, part, st));
  DTF_ROUND(bb.g2, bb.g2lo, (size_t)R * D);
  DTF_TRY(tc::launch_wgrad(bb.g2lo, D, f.hdrop, F, gs[10], R, D, F, st, part));
  DTF_TRY(tc::launch_colsum(bb.g2, D, gs[11], R, D, st, part));
  DTF_TRY(lin16(bb.g2lo, D, wf2, F, nullptr, bb.gF, F, R, F, D, st, 0, 0, 1.f, part));
  DTF_TRY(relu_drop(bb.gF, f.hpre, bb.gF, R, F, dp, st));
  DTF_ROUND(bb.gF, bb.gFlo, (size_t)R * F);
  DTF_TRY(tc::launch_wgrad(bb.gFlo, F, f.x2lo, D, gs[8], R, F, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.gF, F, gs[9], R, F, st, part));
  DTF_TRY(lin16<true>(bb.gFlo, F, wf1, D, nullptr, bb.dxf, D, R, D, F, st, 0, 0, 1.f, part));
  // LN2 and the slot attention
  DTF_TRY(ln_bwd(bb.dxf, f.r2, lns + D, bb.dxf, bb.g2, gs[12] + D, gs[13] + D, R, dp, kMha, part,
                 st));
  DTF_ROUND(bb.g2, bb.g2lo, (size_t)R * D);
  DTF_TRY(tc::launch_wgrad(bb.g2lo, D, f.attn, D, gs[6], R, D, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.g2, D, gs[7], R, D, st, part));
  DTF_TRY(lin16(bb.g2lo, D, wmo, D, nullptr, bb.da, D, R, D, D, st, 0, 0, 1.f, part));
  DTF_TRY(slot_attn(f.mqkv, bb.da, bb.dqkv, B, dp, true, st));
  DTF_ROUND(bb.dqkv, bb.dqkvlo, (size_t)R * 3 * D);
  DTF_TRY(tc::launch_wgrad(bb.dqkvlo, 3 * D, f.x1lo, D, gs[4], R, 3 * D, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.dqkv, 3 * D, gs[5], R, 3 * D, st, part));
  DTF_TRY(lin16<true>(bb.dqkvlo, 3 * D, wmi, D, nullptr, bb.dxf, D, R, D, 3 * D, st, 0, 0, 1.f,
                      part));
  // LN1, the out projection and the gate
  DTF_TRY(ln_bwd(bb.dxf, f.r1, lns, bb.dxf, bb.g2, gs[12], gs[13], R, dp, kRet, part, st));
  DTF_ROUND(bb.g2, bb.g2lo, (size_t)R * D);
  DTF_TRY(tc::launch_wgrad(bb.g2lo, D, f.gated, D, gs[2], R, D, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.g2, D, gs[3], R, D, st, part));
  DTF_TRY(lin16(bb.g2lo, D, wro, D, nullptr, bb.da, D, R, D, D, st, 0, 0, 1.f, part));
  DTF_TRY(gate_bwd<bf16>(bb.da, f.oh, f.g, D, bb.dqkvg + 3 * D, 4 * D, bb.doh, R, st));
  // the retention core, then its projections
  CoreBwdArgs<true> ca{f.qkv, f.qkv + D, f.qkv + 2 * D, 3 * D, bb.doh, bb.pc, D,
                       bb.dqkvg, bb.dqkvg + D, bb.dqkvg + 2 * D, 4 * D, kvs, ss, C, T, L,
                       kscale};
  const int smem = (int)sizeof(float) * core_smem_floats(L, true);
  cudaError_t e = cudaFuncSetAttribute(core_bwd_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  core_bwd_kernel<true><<<BC * H, 256, smem, st>>>(ca);
  DTF_TRY(cudaGetLastError());
  DTF_ROUND(bb.dqkvg, bb.dqkvglo, (size_t)R * 4 * D);
  DTF_TRY(tc::launch_wgrad(bb.dqkvglo, 4 * D, x, D, gs[0], R, 4 * D, D, st, part));
  DTF_TRY(tc::launch_colsum(bb.dqkvg, 4 * D, gs[1], R, 4 * D, st, part));
  DTF_TRY(lin16<true>(bb.dqkvglo, 4 * D, wqkvg, D, nullptr, bb.dxf, D, R, D, 4 * D, st, 0, 0,
                      1.f, part));
  DTF_ROUND(bb.dxf, dx, (size_t)R * D);
  for (int i = 0; i < 14; ++i) DTF_ROUND(gs[i], outs[i], sizes[i]);
#undef DTF_ROUND
#undef DTF_TRY
  return 0;
}
#endif  // FS_BF16
