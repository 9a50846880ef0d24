// Frame scan of the LS-EEND conformer encoder on Hopper, float32, computed
// layer by layer over the whole K-frame block.
//
// Replaces the TPU kernel fseend_tpu/kernels/enc_frame_scan_pallas.py
// (enc_frame_scan, its _kernel): one call runs K frames of every lane
// through all L conformer blocks (half FF (silu) -> pre-LN recurrent gamma=1
// retention -> LN, pw1, GLU, causal depthwise conv over a k-slot ring,
// folded BatchNorm, silu, pw2 -> half FF -> LN), with a per-lane flush that
// gates the retention update and keeps the ring.
//
// What bounds it on the card: operations.  About 12.9 MFLOP per lane-frame
// at the production config (D 256, F 1024, L 4), 0.211 TFLOP per block of
// 128 lanes x 128 frames: 3.2 ms of the FMA pipe, about 1.3 ms of the tensor
// cores at three TF32 passes (tc_f32.cuh).  The TPU kernel held all lanes'
// state in its VMEM across the block; at 128 lanes the state is 34 MB of kv
// and 8 MB of rings.
//
// The key fact: the only dependences between frames are the retention carry
// and the conv ring.  So the block is computed layer-major over the rows
// r = b*Kc + k (lane-major): every linear layer is one matrix product over
// B*Kc rows on the tensor cores, reading its weights once per slice of
// frames, and the retention state is read and written once per layer and
// slice by ret_block_kernel (frame_ret.cuh, the exact recurrence with g_j =
// 1 - flush[b, j]).
//
// The conv ring under flush: a flushed frame does not shift the ring and
// reads it as it stands; the ring's slot 0 is zero at the start of a call.
// So per lane take S = [the kc-slot window at the start of the slice (0 and
// the kc-1 carried frames at the start of a call), then the GLU outputs of
// the slice's kept frames in order].  With n_k the kept frames up to and
// including frame k, frame k reads S[n_k .. n_k + kc - 1]; the window left
// for the next slice is S[n .. n + kc - 1] (n = n_{Kc-1}), and the carried
// history written back at the end of the call is its last kc - 1 slots.
//
// One call is this sequence of kernels on the caller's stream around one
// workspace (frames in slices of at most kSlice that carry the state, so the
// workspace stays B*kSlice rows whatever K is):
//   s0_kernel, enc_in_kernel   the incoming counts; x = h0, gates 1 - flush
//   add_ln_kernel              t = LN(x)
//   per layer:
//     tc::linear x 2, add_ln   half FF (silu), x += ffac * (...), t = LN(x)
//     tc::linear               qkvg = t W_qkvg + b (k columns scaled by dk^-1/2)
//     ret_block_kernel         the exact recurrence, 64 frames per chunk
//     gate_fwd                 silu(g) * groupnorm(out) (eps 1e-6)
//     tc::linear, add_ln       out projection, add, t = LN(x)
//     tc::linear               pw1
//     conv_kernel              GLU, the conv as a gather over S, BN, silu
//     tc::linear, add_ln       pw2, add, t = LN(x)
//     tc::linear x 2, add_ln   half FF, add, the final LN (and the next
//                              layer's first LN)
//   enc_out_kernel             h = x
// gate_fwd is the training fusion layer's (dec_train_fusion_common.cuh).
//
// step() (K = 1) is bound by the host: the sequence is about 100 launches
// for 0.5 ms of device work.  So a caller may ask for the sequence as a
// CUDA graph: captured at the first call with a set of weights, state and
// workspace, and replayed at every later call with the same ones; h0, flush
// and h are staged through the workspace, so that they may change.
//
// The bf16 form (built with FS_BF16; the float32 build is the code above
// unchanged): the weights, h0 and h, the activations between layers, the
// stored state (kv, s) and the conv ring are bf16; every product is one
// bf16 tensor-core pass with float32 accumulation (tc_bf16.cuh); LN, silu,
// GLU, the folded BatchNorm and the recurrence run in float32.  The data is
// rounded to bf16 where the TPU kernel rounds it (enc_frame_scan_pallas.py:
// 66-125): each LN's output, the half FF's hidden layer, x after each
// residual add, q | k | v | g, the group norm's output and the gated value,
// the GLU output (what the ring keeps), silu of the conv.  pw1's output and
// the products that go into a residual add stay float32.  The state is
// carried in float32 within a call (frame_ret.cuh).  Bound: 0.211 TFLOP a
// block at 128 lanes x 128 frames, 0.21 ms of the bf16 tensor cores.
//
// At D = 256 the bf16 form runs its layer on scan16.cuh's tools instead:
// as the sequence above it took 2.54 ms a 128-lane x 128-frame block on an
// H100 (the products on mma.sync at a fifth of the bf16 peak, float32
// products and the FFN's hidden layer through device memory, the
// recurrence on the FMA pipe), and a step() 0.41 ms of about 100 graph
// nodes.  Eight kernels a layer, every float32 intermediate in registers or
// shared memory:
//   ffn16_kernel (silu, kAddLn)  half FF #1: x = round(x + ffac (...)) in
//                                place, t = round(LN(x))
//   wg16_kernel kRound           q | k | v | g (k~ scaled in bf16)
//   ret_tc_kernel                the recurrence on the tensor cores (gates
//                                1 - flush), group norm and silu gate, four
//                                blocks an SM (one wave of 512)
//   wg16_kernel kAddLn           out projection, add, x and t = LN(x)
//   wg16_kernel kGlu             pw1 and the GLU (pw1's a and b columns
//                                interleaved): the bf16 GLU output, pw1's
//                                float32 product never stored
//   conv_kernel<bf16>            the conv over that output, BN, silu
//   wg16_kernel kAddLn           pw2, add, x and t = LN(x)
//   ffn16_kernel (silu, kAddLn)  half FF #2, the final LN into x and the
//                                next layer's first LN into t
// The weights are transposed into the workspace once a call, or for a
// step()'s graph once per set of weights (outside the graph).  Where the
// slice's 128-row tiles leave most SMs idle (a step()'s 128 rows are one
// block of ffn16_kernel and of the 256-wide products), each half FF runs
// over runs of its hidden slices (kPart) and the out projection and pw2
// over runs of their k tiles, each followed by a row kernel
// (add_ln_parts_kernel) that adds the float32 sums in order, then the
// residual add and the norms (splits_for).  At K = 1 the recurrence runs as
// ret_step16_kernel: twelve graph nodes a layer.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>

#include "frame_ret.cuh"
#include "tc_f32.cuh"
#ifdef FS_BF16
#include "scan16.cuh"
#include "tc_bf16.cuh"
using T = fs::bf16;
#else
using T = float;
#endif

using namespace dtf;
using namespace frs;

namespace {

struct EncWeights {
  // stacked over layers, (in, out) layouts:
  const T *lns, *lnb;                    // (L, 5, D): ff1, ret, conv, ff2, final
  const T *wf1a, *bf1a, *wf1b, *bf1b;    // (L, D, F), (L, F), (L, F, D), (L, D)
  const T *wqkvg, *bqkvg, *wro, *bro;    // (L, D, 4D), (L, 4D), (L, D, D), (L, D)
  const T *wpw1, *bpw1, *dw, *bna, *bnb; // (L, D, 2D), (L, 2D), (L, k, D), (L, D) x2
  const T *wpw2, *bpw2;                  // (L, D, D), (L, D)
  const T *wf2a, *bf2a, *wf2b, *bf2b;    // as ff1
};
constexpr int kNumWeights = 21;

// x[(b*Kc + k)*D + d] = h0[(b*Kt + k0 + k)*D + d]; gate[b*Kc + k] = 1 - flush[b*Kt + k0 + k]
__global__ void enc_in_kernel(const T* __restrict__ h0, const float* __restrict__ flush,
                              T* __restrict__ x, float* __restrict__ gate, int Kc, int Kt,
                              int k0, long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (D / 4);
    const int d = (int)(i % (D / 4)) * 4;
    const size_t f = (size_t)(r / Kc) * Kt + k0 + r % Kc;
    fs::store4(x + r * D + d, fs::load4(h0 + f * D + d));
    if (d == 0) gate[r] = 1.f - flush[f];
  }
}

// hout[(b*Kt + k0 + k)*D + d] = x[(b*Kc + k)*D + d]
__global__ void enc_out_kernel(const T* __restrict__ x, T* __restrict__ hout, int Kc, int Kt,
                               int k0, long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (D / 4);
    const int d = (int)(i % (D / 4)) * 4;
    const size_t f = (size_t)(r / Kc) * Kt + k0 + r % Kc;
    fs::store4(hout + f * D + d, fs::load4(x + r * D + d));
  }
}

// LayerNorm of a row held by a warp (eps 1e-5), scaled and shifted
__device__ __forceinline__ void ln_row(float (&v)[NV], const T* __restrict__ scale,
                                       const T* __restrict__ bias) {
  const int c0 = lane_id() * NV;
  const float mu = row_sum(v) / D;
  float d2[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) d2[i] = (v[i] - mu) * (v[i] - mu);
  const float rs = rsqrtf(row_sum(d2) / D + 1e-5f);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = (v[i] - mu) * rs * fs::ldg(scale + c0 + i) + fs::ldg(bias + c0 + i);
}

// v = x + a (a may be null), written to sum when it is not null; y1 =
// LN(v; s1, b1); y2 = LN(y1; s2, b2) when s2 is not null.  One warp per row.
// The bf16 form rounds v before it is written and normed, and y1 before
// the second norm, as the TPU kernel rounds x after each add and each LN.
__global__ void __launch_bounds__(256)
add_ln_kernel(const T* __restrict__ x, const float* __restrict__ a, T* __restrict__ sum,
              const T* __restrict__ s1, const T* __restrict__ b1, T* __restrict__ y1,
              const T* __restrict__ s2, const T* __restrict__ b2, T* __restrict__ y2,
              long long R) {
  DTF_FOR_ROWS(r, R) {
    float v[NV];
    load_row(x + r * D, v);
    if (a) {
      float av[NV];
      load_row(a + r * D, av);
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = fs::rnd<T>(v[i] + av[i]);
    }
    if (sum) store_row(sum + r * D, v);
    ln_row(v, s1, b1);
    store_row(y1 + r * D, v);
    if (s2) {
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = fs::rnd<T>(v[i]);
      ln_row(v, s2, b2);
      store_row(y2 + r * D, v);
    }
  }
}

#ifdef FS_BF16
// The bf16 layer's first kernel of a slice: s0 (every (layer, lane)'s
// incoming count, as s0_kernel), x = the slice's rows of h0 and gate = 1 -
// flush (as enc_in_kernel), t = round(LN_0(x)) (as add_ln_kernel); one warp
// a row
__global__ void __launch_bounds__(256)
enc_in_ln_kernel(const T* __restrict__ h0, const float* __restrict__ flush, T* __restrict__ x,
                 float* __restrict__ gate, const T* __restrict__ lns, const T* __restrict__ lnb,
                 T* __restrict__ t, const T* __restrict__ s, float* __restrict__ s0, int nls,
                 int Kc, int Kt, int k0, long long R) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nls; i += gridDim.x * blockDim.x)
    s0[i] = fs::f32(s[(size_t)i * H]);
  DTF_FOR_ROWS(r, R) {
    const size_t f = (size_t)(r / Kc) * Kt + k0 + r % Kc;
    float v[NV];
    load_row(h0 + f * D, v);
    store_row(x + r * D, v);
    if (lane_id() == 0) gate[r] = 1.f - flush[f];
    ln_row(v, lns, lnb);
    store_row(t + r * D, v);
  }
}

// A half FF, out projection or pw2 over few rows after its kPart runs (scan16.cuh):
// v = round(x + s (sum_z P[z] + bias)), the runs' float32 sums P (Z, R, D)
// (every run's row in flight at once) added in the order of z (the same
// bits whatever order the blocks ran in); then kAddLn's norms: dbl 0, x = v
// and t = round(LN1(v)); dbl 1, x = round(LN1(v)) and t = round(LN2(x)) when
// s2 is not null.  One warp per row.
template <int Z>
__global__ void __launch_bounds__(256)
add_ln_parts_kernel(const float* __restrict__ P, const T* __restrict__ bias, float s, T* x,
                    const T* __restrict__ s1, const T* __restrict__ b1,
                    const T* __restrict__ s2, const T* __restrict__ b2, int dbl, T* t,
                    long long R) {
  DTF_FOR_ROWS(r, R) {
    float v[NV], a[NV], p[Z][NV];
#pragma unroll
    for (int z = 0; z < Z; ++z) load_row(P + ((size_t)z * R + r) * D, p[z]);  // all in flight
#pragma unroll
    for (int i = 0; i < NV; ++i) a[i] = p[0][i];
#pragma unroll
    for (int z = 1; z < Z; ++z)
#pragma unroll
      for (int i = 0; i < NV; ++i) a[i] += p[z][i];
    load_row(x + r * D, v);
    const int c0 = lane_id() * NV;
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = fs::rnd<T>(v[i] + (a[i] + fs::ldg(bias + c0 + i)) * s);
    if (!dbl) store_row(x + r * D, v);
    ln_row(v, s1, b1);
    if (dbl) {
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = fs::rnd<T>(v[i]);
      store_row(x + r * D, v);
      if (!s2) continue;
      ln_row(v, s2, b2);
    }
    store_row(t + r * D, v);
  }
}

// add_ln_parts_kernel over Z = 2, 4, 8 or 16 runs
int add_ln_parts(int Z, int grid, cudaStream_t st, const float* P, const T* bias, float sc, T* x,
                 const T* s1, const T* b1, const T* s2, const T* b2, int dbl, T* t, long long R) {
  switch (Z) {
#define EFS_PARTS(z)                                                                       \
  case z:                                                                                  \
    add_ln_parts_kernel<z><<<grid, 256, 0, st>>>(P, bias, sc, x, s1, b1, s2, b2, dbl, t, R); \
    break;
    EFS_PARTS(2)
    EFS_PARTS(4)
    EFS_PARTS(8)
    EFS_PARTS(16)
#undef EFS_PARTS
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// A step()'s recurrence (K = 1) of frame_ret.cuh's exact form with the
// group norm (eps 1e-6) and silu gate of ret_tc_kernel's epilogue: one block
// of DK threads per (lane, head), thread v holding row v of the state
// KV = kv sqrt(s0) in float32 registers:
//   out_v = (q . KV_v + (q . k~) v_v) rsqrt(s0 + 1), normed over the head,
//   gated_v = round(silu(g_v) round(norm_v)),
//   KV_v += gate v_v k~, kv = round(KV rsqrt(max(s0 + gate, 1))), s = s0 + gate.
// The tensor-core form's 64-frame tiles would hold one frame here; these
// blocks read their 8 KB of state once and write it once.  Rows of qkvg:
// one per lane (stride 4 D).
template <int NDK>
__global__ void __launch_bounds__(NDK)
ret_step16_kernel(const T* __restrict__ qkvg, const float* __restrict__ gate,
                  T* __restrict__ gated, T* __restrict__ kv, T* __restrict__ s,
                  const float* __restrict__ s0) {
  static_assert(NDK % 32 == 0 && NDK <= 64, "whole warps over a head");
  __shared__ float qs[NDK], ks[NDK], red[2][NDK / 32];
  const int seq = blockIdx.x, b = seq / H, h = seq % H, v = threadIdx.x;
  const T* row = qkvg + (size_t)b * 4 * D + h * NDK;
  qs[v] = fs::f32(row[v]);
  ks[v] = fs::f32(row[D + v]);
  const float vv = fs::f32(row[2 * D + v]), gg = fs::f32(row[3 * D + v]);
  const float ga = gate[b], srun = s0[b], sc = sqrtf(srun);
  float kvr[NDK];
  const uint4* src = reinterpret_cast<const uint4*>(kv + ((size_t)seq * NDK + v) * NDK);
#pragma unroll
  for (int i = 0; i < NDK / 8; ++i) {
    const uint4 u = src[i];
    const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w4[e]));
      kvr[8 * i + 2 * e] = f.x * sc, kvr[8 * i + 2 * e + 1] = f.y * sc;
    }
  }
  __syncthreads();
  float r0 = 0.f, qk = 0.f;
#pragma unroll
  for (int k = 0; k < NDK; ++k) {
    r0 = fmaf(qs[k], kvr[k], r0);
    qk = fmaf(qs[k], ks[k], qk);
  }
  const float o = (r0 + qk * vv) * rsqrtf(srun + 1.f);
  const int w = v >> 5;
  float sum = fs::warp_sum(o);
  if ((v & 31) == 0) red[0][w] = sum;
  __syncthreads();
  sum = 0.f;
#pragma unroll
  for (int i = 0; i < NDK / 32; ++i) sum += red[0][i];
  const float mu = sum / NDK;
  float d2 = fs::warp_sum((o - mu) * (o - mu));
  if ((v & 31) == 0) red[1][w] = d2;
  __syncthreads();
  d2 = 0.f;
#pragma unroll
  for (int i = 0; i < NDK / 32; ++i) d2 += red[1][i];
  const float rs = rsqrtf(d2 / NDK + 1e-6f);
  gated[(size_t)b * D + h * NDK + v] = fs::As<T>::from(fs::silu(gg) * fs::rnd<T>((o - mu) * rs));
  const float s1 = srun + ga, norm = rsqrtf(fmaxf(s1, 1.f)), gv = ga * vv;
  uint4* dst = reinterpret_cast<uint4*>(kv + ((size_t)seq * NDK + v) * NDK);
#pragma unroll
  for (int i = 0; i < NDK / 8; ++i) {
    uint32_t w4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 8 * i + 2 * e;
      const __nv_bfloat162 p = __floats2bfloat162_rn((kvr[k] + gv * ks[k]) * norm,
                                                     (kvr[k + 1] + gv * ks[k + 1]) * norm);
      w4[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
    dst[i] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
  }
  if (v == 0) s[seq] = fs::As<T>::from(s1);
}
#endif

// The conv module's middle for one lane (blockIdx.x) and kCg channels
// (blockIdx.y) over the slice: GLU of pw1's output (P float: pw (R, 2D);
// P = T: pw is the GLU output (R, D), formed in pw1's epilogue), the causal
// depthwise conv as a gather over S (see the note at the top; S in shared
// memory, (kc + Kc) x kCg), the folded BatchNorm and silu into out (R, D).
// The window at the start of the slice comes from the carried history
// (ring (B, kc-1, D) with a zero slot 0) on the first slice, else from win
// (B, kc, D); the window after it goes to win, or on the last slice its last
// kc - 1 slots to ring.
// 128 channels a block where they divide D, else 64 (at D 256 and 128
// lanes, 256 blocks: one wave at the register window's 71 registers a
// thread), two or four runs of frames a channel; a kernel of up to
// kMaxTaps taps is held in registers with its window
constexpr int kCg = D % 128 ? 64 : 128;
static_assert(D % kCg == 0, "the conv's channel groups tile D");
constexpr int kMaxTaps = 16;

template <typename P>
__global__ void __launch_bounds__(256)
conv_kernel(const P* __restrict__ pw, const float* __restrict__ gate,
            const T* __restrict__ dw, const T* __restrict__ bna, const T* __restrict__ bnb,
            T* __restrict__ out, T* ring, float* win, int Kc, int kc, bool first, bool last) {
  extern __shared__ __align__(16) float sm[];
  float* S = sm;                                      // (kc + Kc, kCg)
  int* pos = reinterpret_cast<int*>(S + (kc + Kc) * kCg);  // (Kc) n_k
  float* gs = reinterpret_cast<float*>(pos + Kc);          // (Kc) the gates
  const int b = blockIdx.x, d0 = blockIdx.y * kCg, tid = threadIdx.x, nt = blockDim.x;
  const float* g = gate + (size_t)b * Kc;
  if (tid < 32) {  // kept frames up to and including each frame: a warp's scan, 32 at a time
    int n = 0;
#pragma unroll 4
    for (int k0 = 0; k0 < Kc; k0 += 32) {
      const int k = k0 + tid;
      const float gk = k < Kc ? g[k] : 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, gk != 0.f);
      if (k < Kc) {
        pos[k] = n + __popc(m & (0xffffffffu >> (31 - tid)));
        gs[k] = gk;
      }
      n += __popc(m);
    }
  }
  for (int i = tid; i < kc * kCg; i += nt) {
    const int j = i / kCg, c = i % kCg;
    S[i] = first ? (j == 0 ? 0.f : fs::f32(ring[((size_t)b * (kc - 1) + j - 1) * D + d0 + c]))
                 : win[((size_t)b * kc + j) * D + d0 + c];
  }
  __syncthreads();
  // a kept frame's GLU output goes to S[kc - 1 + n_k]: 16-byte loads (4
  // channels of pw1's float32 a and b, or 8 of the bf16 GLU output), a
  // thread's kGather of them in flight together
  constexpr int kVec = std::is_same<P, float>::value ? 4 : 8, kGather = 8;
  const int nvec = Kc * (kCg / kVec);
  for (int i0 = tid; i0 < nvec; i0 += kGather * nt) {
    float v[kGather][kVec];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int i = i0 + u * nt, k = i / (kCg / kVec), c = (i % (kCg / kVec)) * kVec;
      if (i >= nvec || gs[k] == 0.f) continue;
      if constexpr (std::is_same<P, float>::value) {
        const float* p = pw + ((size_t)b * Kc + k) * 2 * D + d0 + c;
        const float4 a = *reinterpret_cast<const float4*>(p);
        const float4 z = *reinterpret_cast<const float4*>(p + D);
        v[u][0] = a.x * fs::sigmoid(z.x), v[u][1] = a.y * fs::sigmoid(z.y);
        v[u][2] = a.z * fs::sigmoid(z.z), v[u][3] = a.w * fs::sigmoid(z.w);
      } else {
        const uint4 q = *reinterpret_cast<const uint4*>(pw + ((size_t)b * Kc + k) * D + d0 + c);
        const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w4[e]));
          v[u][2 * e] = f.x, v[u][2 * e + 1] = f.y;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int i = i0 + u * nt, k = i / (kCg / kVec), c = (i % (kCg / kVec)) * kVec;
      if (i >= nvec || gs[k] == 0.f) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e) S[(kc - 1 + pos[k]) * kCg + c + e] = fs::rnd<T>(v[u][e]);
    }
  }
  __syncthreads();
  const int c = tid % kCg, d = d0 + c;
  if (kc <= kMaxTaps) {
    // a thread's channel over a run of consecutive frames: frame k reads
    // S[n_k .. n_k + kc - 1], and n_k grows by 0 or 1 from a frame to the
    // next, so the window is held in registers (right-aligned, its newest
    // value at the end) and shifts by one slot at each kept frame; the taps
    // are right-aligned too, zeros before them, so every output is the same
    // fmaf chain over j = 0 .. kc - 1 from 0 as below (a zero tap adds 0)
    const int runs = nt / kCg, per = (Kc + runs - 1) / runs;
    const int k0 = (tid / kCg) * per, k1 = min(Kc, k0 + per);
    float tap[kMaxTaps], w[kMaxTaps];
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      const int j = i - (kMaxTaps - kc);
      tap[i] = j >= 0 && k0 < k1 ? fs::ldg(dw + (size_t)j * D + d) : 0.f;
    }
    const float ba = k0 < k1 ? fs::ldg(bna + d) : 0.f, bb = k0 < k1 ? fs::ldg(bnb + d) : 0.f;
    int p = k0 < k1 ? pos[k0] : 0;
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      const int j = i - (kMaxTaps - kc);
      w[i] = j >= 0 && k0 < k1 ? S[(p + j) * kCg + c] : 0.f;
    }
    for (int k = k0; k < k1; ++k) {
      if (pos[k] != p) {  // one more kept frame: the window moves on by one
        p = pos[k];
#pragma unroll
        for (int i = 0; i < kMaxTaps - 1; ++i) w[i] = w[i + 1];
        w[kMaxTaps - 1] = S[(p + kc - 1) * kCg + c];
      }
      float y = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) y = fmaf(w[i], tap[i], y);
      y = y * ba + bb;
      out[((size_t)b * Kc + k) * D + d] = fs::As<T>::from(fs::silu(y));
    }
  } else {
    for (int i = tid; i < Kc * kCg; i += nt) {
      const int k = i / kCg;
      const float* sp = S + pos[k] * kCg + c;
      float y = 0.f;
      for (int j = 0; j < kc; ++j) y = fmaf(sp[j * kCg], fs::ldg(dw + (size_t)j * D + d), y);
      y = y * fs::ldg(bna + d) + fs::ldg(bnb + d);
      out[((size_t)b * Kc + k) * D + d] = fs::As<T>::from(fs::silu(y));
    }
  }
  const int n = pos[Kc - 1];
  for (int i = tid; i < kc * kCg; i += nt) {
    const int j = i / kCg, cc = i % kCg;
    const float v = S[(n + j) * kCg + cc];
    if (!last)
      win[((size_t)b * kc + j) * D + d0 + cc] = v;
    else if (j > 0)
      ring[((size_t)b * (kc - 1) + j - 1) * D + d0 + cc] = fs::As<T>::from(v);
  }
}

struct Bufs {
  float *x0, *x1, *t, *t2, *a, *big, *gate, *s0, *win, *part;
  float *wt, *ffp;           // the bf16 layer's transposed weights and runs' sums, or null
  float *h0, *flush, *hout;  // the staged operands of a graph call
};

#ifdef FS_BF16
// scan16.cuh's layer takes D = 256 and F a multiple of 64, and runs every
// slice at that width
inline bool layer16(int F) { return D == 256 && F % d16::kFS == 0; }
// Where a slice's 128-row tiles leave most SMs idle (a step()'s 128 rows
// are one tile), each half FF runs over runs of its hidden slices and the
// out projection and pw2 over runs of their k tiles (kPart), each followed
// by a row kernel that adds the runs' float32 sums in a fixed order: the
// most runs (a power of two, at most `most`, dividing `slices`) whose
// blocks still make one wave of the card's SMs; 1 for no split
constexpr int kMaxFfnSplits = 16;        // of a half FF's F / 64 hidden slices
constexpr int kMaxKSplits = D / d16::kWBK;  // of a 256-wide product's k tiles
inline int splits_for(long long R, int most, int slices) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  const long long tiles = (R + d16::kWBM - 1) / d16::kWBM;
  int s = 1;
  while (2 * s <= most && slices % (2 * s) == 0 && tiles * 2 * s <= sms) s *= 2;
  return s;
}
inline int ffn_splits(long long R, int F) { return splits_for(R, kMaxFfnSplits, F / d16::kFS); }
inline int k_splits(long long R) { return splits_for(R, kMaxKSplits, D / d16::kWBK); }
// floats of the runs' sums over a slice of R rows (0 without a split)
inline size_t parts_floats(long long R, int F) {
  const int runs = std::max(ffn_splits(R, F), k_splits(R));
  return runs > 1 ? (size_t)runs * R * D : 0;
}
// a K = 1 call's recurrence: ret_step16_kernel where a head is whole warps
constexpr bool kStepRet = DK % 32 == 0 && DK <= 64;
// bf16 elements of one layer's transposed weights: qkvg, ro, pw1, pw2 (8 D^2),
// f1a, f1b, f2a, f2b (4 D F)
inline size_t wt_layer(int F) { return (size_t)8 * D * D + (size_t)4 * D * F; }
#endif

// the captured graphs, by their call's arguments, the most recent last
struct Graph {
  std::vector<uintptr_t> key;
  cudaGraphExec_t exec;
};
std::vector<Graph> g_graphs;
constexpr size_t kMaxGraphs = 8;

size_t carve(float* base, int B, int K, int L, int F, int kc, bool graph, Bufs* b) {
  const size_t R = (size_t)B * (K < kSlice ? K : kSlice);
  Carve c{base};
  for (float** p : {&b->x0, &b->x1, &b->t, &b->t2, &b->a}) *p = c.take(R * D);
  b->big = c.take(R * (F > 4 * D ? F : 4 * D));
  b->gate = c.take(R);
  b->s0 = c.take((size_t)L * B);
  b->win = c.take((size_t)L * B * kc * D);
  b->part = c.take(tc::kSplitFloats);  // a product of few rows split along k
  b->wt = b->ffp = nullptr;
#ifdef FS_BF16
  if (layer16(F)) {
    b->wt = c.take((L * wt_layer(F) + 1) / 2);
    // the runs' sums of a whole slice or of the last, shorter one
    const size_t np = std::max(parts_floats((long long)R, F),
                               parts_floats((long long)B * (K % kSlice), F));
    if (np) b->ffp = c.take(np);
  }
#endif
  if (graph) {
    b->h0 = c.take((size_t)B * K * D);
    b->flush = c.take((size_t)B * K);
    b->hout = c.take((size_t)B * K * D);
  }
  return c.used;
}

#ifdef FS_BF16
// the transposed weights' blocks at base, one (L, N, K) block each: qkvg,
// ro, pw1 (a and b interleaved), pw2, f1a, f1b, f2a, f2b; written on st
// when `write`
int transposed(const EncWeights& w, float* base, int L, int F, const T* (&wt)[8], bool write,
               cudaStream_t st) {
  const T* src[8] = {w.wqkvg, w.wro, w.wpw1, w.wpw2, w.wf1a, w.wf1b, w.wf2a, w.wf2b};
  const int kin[8] = {D, D, D, D, D, F, D, F}, nout[8] = {4 * D, D, 2 * D, D, F, D, F, D};
  T* p = reinterpret_cast<T*>(base);
  for (int i = 0; i < 8; ++i) {
    wt[i] = p;
    if (write) {
      const int err = i == 2 ? d16::transpose16<true>(src[i], p, L, kin[i], nout[i], st)
                             : d16::transpose16(src[i], p, L, kin[i], nout[i], st);
      if (err) return err;
    }
    p += (size_t)L * kin[i] * nout[i];
  }
  return 0;
}
#endif

// the launch sequence of one call; with `transpose`, the bf16 layer's
// weights are transposed into the workspace first (a graph's are written
// outside it)
int enqueue(const EncWeights& w, const T* h0, const float* flush, T* hout, T* kv, T* s, T* ring,
            float* ws, int B, int K, int L, int F, int kc, float ffac, bool transpose,
            cudaStream_t st) {
  Bufs bf;
  carve(ws, B, K, L, F, kc, false, &bf);
#ifdef FS_BF16
  // the TPU kernel scales the bf16 k by dk^-1/2 in bf16
  const float kscale = __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt((double)DK))));
#else
  const float kscale = (float)(1.0 / sqrt((double)DK));
#endif
  const size_t kvl = (size_t)B * H * DK * DK;  // one layer's state
  const size_t rsmem = sizeof(float) * ret_smem_floats();
  const size_t csmem = sizeof(float) * (kc + kSlice) * kCg + 2 * sizeof(int) * kSlice;
  int err;
#define EFS_TRY(call) \
  if ((err = (call)) != 0) return err
  EFS_TRY(cudaFuncSetAttribute(ret_block_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rsmem));
  EFS_TRY(cudaFuncSetAttribute(conv_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)csmem));
#ifdef FS_BF16
  EFS_TRY(cudaFuncSetAttribute(conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)csmem));
  EFS_TRY(cudaFuncSetAttribute(d16::ret_tc_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d16::ret_tc_smem_bytes()));
  const T* wt[8] = {};
  if (bf.wt) EFS_TRY(transposed(w, bf.wt, L, F, wt, transpose, st));
#endif
  // the workspace's row buffers: x0, x1, t, t2 and big hold T (big: pw1's
  // float32 output in the conv module); a holds a float32 product on its
  // way into an add
  T *x0 = reinterpret_cast<T*>(bf.x0), *x1 = reinterpret_cast<T*>(bf.x1);
  T *t = reinterpret_cast<T*>(bf.t), *t2 = reinterpret_cast<T*>(bf.t2);
  T* big = reinterpret_cast<T*>(bf.big);
  for (int k0 = 0; k0 < K; k0 += kSlice) {
    const int Kc = K - k0 < kSlice ? K - k0 : kSlice;
    const long long R = (long long)B * Kc;
    const long long n4 = R * (D / 4);
    const int copy_grid = (int)lmin((n4 + 255) / 256, 132 * 16);
    const bool first = k0 == 0, last = k0 + Kc >= K;
    T *x = x0, *y = x1;
    const int rg = row_grid(R);
#ifdef FS_BF16
    const bool fused = bf.wt != nullptr;
    if (fused) {
      enc_in_ln_kernel<<<rg, 256, 0, st>>>(h0, flush, x0, bf.gate, w.lns, w.lnb, t, s, bf.s0,
                                           L * B, Kc, K, k0, R);
      EFS_TRY(cudaGetLastError());
    } else
#endif
    {
      s0_kernel<T><<<(L * B + 255) / 256, 256, 0, st>>>(s, bf.s0, L * B);
      EFS_TRY(cudaGetLastError());
      enc_in_kernel<<<copy_grid, 256, 0, st>>>(h0, flush, x0, bf.gate, Kc, K, k0, n4);
      EFS_TRY(cudaGetLastError());
      add_ln_kernel<<<rg, 256, 0, st>>>(x, nullptr, nullptr, w.lns, w.lnb, t, nullptr, nullptr,
                                        nullptr, R);
      EFS_TRY(cudaGetLastError());
    }
#ifdef FS_BF16
    const int fsplits = ffn_splits(R, F), ksplits = k_splits(R);
    T* glu = reinterpret_cast<T*>(bf.a);
    for (int l = 0; fused && l < L; ++l) {
      const T* lns = w.lns + (size_t)l * 5 * D;
      const T* lnb = w.lnb + (size_t)l * 5 * D;
      const size_t dd = (size_t)D * D, df = (size_t)D * F;
      // a half FF from t = LN(x): x = round(x + ffac (...)), then the norms
      // (dbl 0: t = LN_i(x); dbl 1: x = LN_i(x), t = the next layer's LN_0(x))
      auto half_ff = [&](const T* w1t, const T* b1, const T* w2t, const T* b2, int i, int dbl) {
        const bool next = dbl && l + 1 < L;
        d16::Epi16 ep{b2, 0, 0, ffac, x, lns + i * D, lnb + i * D};
        ep.out2 = t;
        ep.lns2 = next ? lns + 5 * D : nullptr;
        ep.lnb2 = next ? lnb + 5 * D : nullptr;
        ep.dbl = dbl;
        ep.part = bf.ffp;
        const int e = d16::ffn16_enc(t, w1t, b1, w2t, ep, x, (int)R, F, fsplits, st);
        if (e || fsplits == 1) return e;
        return add_ln_parts(fsplits, rg, st, bf.ffp, b2, ffac, x, ep.lns, ep.lnb, ep.lns2, ep.lnb2,
                            dbl, t, R);
      };
      EFS_TRY(half_ff(wt[4] + l * df, w.bf1a + (size_t)l * F, wt[5] + l * df,
                      w.bf1b + (size_t)l * D, 1, 0));
      // x = round(x + (A W + bias)), t = LN_i(x): over few rows its k tiles
      // run over ksplits blocks a row tile, then a row kernel
      auto add_norm = [&](const T* A, const T* wtl, const T* bias, int i) {
        if (ksplits == 1)
          return d16::linear16_addln(A, wtl, bias, x, lns + i * D, lnb + i * D, t, (int)R, st);
        const int e = d16::linear16_part(A, wtl, bf.ffp, (int)R, D, ksplits, st);
        if (e) return e;
        return add_ln_parts(ksplits, rg, st, bf.ffp, bias, 1.f, x, lns + i * D, lnb + i * D,
                            nullptr, nullptr, 0, t, R);
      };
      EFS_TRY(d16::linear16(t, wt[0] + l * 4 * dd, w.bqkvg + (size_t)l * 4 * D, big, (int)R,
                            4 * D, st, D, 2 * D, kscale));
      T* kvp = kv + l * kvl;
      T* sp = s + (size_t)l * B * H;
      const float* s0p = bf.s0 + l * B;
      if (kStepRet && K == 1)
        ret_step16_kernel<kStepRet ? DK : 32><<<B * H, DK, 0, st>>>(big, bf.gate, t2, kvp, sp,
                                                                   s0p);
      else
        d16::ret_tc_kernel<4><<<B * H, 128, d16::ret_tc_smem_bytes(), st>>>(big, bf.gate, t2, kvp,
                                                                        sp, s0p, 1, Kc, Kc, 0);
      EFS_TRY(cudaGetLastError());
      EFS_TRY(add_norm(t2, wt[1] + l * dd, w.bro + (size_t)l * D, 2));
      EFS_TRY(d16::linear16_glu(t, wt[2] + l * 2 * dd, w.bpw1 + (size_t)l * 2 * D, glu, (int)R,
                                2 * D, st));
      conv_kernel<T><<<dim3(B, D / kCg), 256, csmem, st>>>(
          glu, bf.gate, w.dw + (size_t)l * kc * D, w.bna + (size_t)l * D, w.bnb + (size_t)l * D,
          t2, ring + (size_t)l * B * (kc - 1) * D, bf.win + (size_t)l * B * kc * D, Kc, kc, first,
          last);
      EFS_TRY(cudaGetLastError());
      EFS_TRY(add_norm(t2, wt[3] + l * dd, w.bpw2 + (size_t)l * D, 3));
      EFS_TRY(half_ff(wt[6] + l * df, w.bf2a + (size_t)l * F, wt[7] + l * df,
                      w.bf2b + (size_t)l * D, 4, 1));
    }
    for (int l = 0; !fused && l < L; ++l) {
#else
    for (int l = 0; l < L; ++l) {
#endif
      const T* lns = w.lns + (size_t)l * 5 * D;
      const T* lnb = w.lnb + (size_t)l * 5 * D;
      auto add_ln = [&](int i) {  // x += a, t = LN_i(x)
        add_ln_kernel<<<rg, 256, 0, st>>>(x, bf.a, y, lns + i * D, lnb + i * D, t, nullptr,
                                          nullptr, nullptr, R);
        T* tmp = x;
        x = y;
        y = tmp;
        return (int)cudaGetLastError();
      };
      // ---- half feed-forward #1 ----
      EFS_TRY(tc::launch_linear<tc::kSilu>(t, D, w.wf1a + (size_t)l * D * F, F,
                                           w.bf1a + (size_t)l * F, big, F, (int)R, F, D, st,
                                           0, 0, 1.f, bf.part));
      EFS_TRY(tc::launch_linear(big, F, w.wf1b + (size_t)l * F * D, D, w.bf1b + (size_t)l * D,
                                bf.a, D, (int)R, D, F, st, 0, D, ffac, bf.part));
      EFS_TRY(add_ln(1));
      // ---- retention ----
      EFS_TRY(tc::launch_linear(t, D, w.wqkvg + (size_t)l * D * 4 * D, 4 * D,
                                w.bqkvg + (size_t)l * 4 * D, big, 4 * D, (int)R, 4 * D, D, st,
                                D, 2 * D, kscale, bf.part));
      ret_block_kernel<T><<<B * H, 256, rsmem, st>>>(big, bf.gate, bf.a, kv + l * kvl,
                                                  s + (size_t)l * B * H, bf.s0 + l * B, 1, Kc,
                                                  Kc, 0);
      EFS_TRY(cudaGetLastError());
      EFS_TRY(gate_fwd(bf.a, big + 3 * D, 4 * D, t2, R, st));
      EFS_TRY(tc::launch_linear(t2, D, w.wro + (size_t)l * D * D, D, w.bro + (size_t)l * D,
                                bf.a, D, (int)R, D, D, st, 0, 0, 1.f, bf.part));
      EFS_TRY(add_ln(2));
      // ---- causal depthwise conv module ----
      EFS_TRY(tc::launch_linear(t, D, w.wpw1 + (size_t)l * D * 2 * D, 2 * D,
                                w.bpw1 + (size_t)l * 2 * D, bf.big, 2 * D, (int)R, 2 * D, D, st,
                                0, 0, 1.f, bf.part));
      conv_kernel<float><<<dim3(B, D / kCg), 256, csmem, st>>>(
          bf.big, bf.gate, w.dw + (size_t)l * kc * D, w.bna + (size_t)l * D,
          w.bnb + (size_t)l * D, t2, ring + (size_t)l * B * (kc - 1) * D,
          bf.win + (size_t)l * B * kc * D, Kc, kc, first, last);
      EFS_TRY(cudaGetLastError());
      EFS_TRY(tc::launch_linear(t2, D, w.wpw2 + (size_t)l * D * D, D, w.bpw2 + (size_t)l * D,
                                bf.a, D, (int)R, D, D, st, 0, 0, 1.f, bf.part));
      EFS_TRY(add_ln(3));
      // ---- half feed-forward #2, the final LN (and the next layer's first) ----
      EFS_TRY(tc::launch_linear<tc::kSilu>(t, D, w.wf2a + (size_t)l * D * F, F,
                                           w.bf2a + (size_t)l * F, big, F, (int)R, F, D, st,
                                           0, 0, 1.f, bf.part));
      EFS_TRY(tc::launch_linear(big, F, w.wf2b + (size_t)l * F * D, D, w.bf2b + (size_t)l * D,
                                bf.a, D, (int)R, D, F, st, 0, D, ffac, bf.part));
      const bool more = l + 1 < L;
      add_ln_kernel<<<rg, 256, 0, st>>>(x, bf.a, nullptr, lns + 4 * D, lnb + 4 * D, y,
                                        more ? lns + 5 * D : nullptr, more ? lnb + 5 * D : nullptr,
                                        t, R);
      EFS_TRY(cudaGetLastError());
      T* tmp = x;
      x = y;
      y = tmp;
    }
    enc_out_kernel<<<copy_grid, 256, 0, st>>>(x, hout, Kc, K, k0, n4);
    EFS_TRY(cudaGetLastError());
  }
#undef EFS_TRY
  return 0;
}

}  // namespace

// floats of workspace enc_frame_scan_launch needs, with or without `graph`
// (0 for a width or head count this build does not take)
extern "C" size_t enc_frame_scan_workspace(int B, int K, int L, int D_, int H_, int F, int kc,
                                           int graph) {
  Bufs b;
  return D_ == D && H_ == H ? carve(nullptr, B, K, L, F, kc, graph != 0, &b) : 0;
}

// weights: kNumWeights device pointers in EncWeights order.  h0, hout (B, K,
// D); flush (B, K) float32; kv (L, B, H, dv, dk), s (L, B, H) and ring (L, B,
// kc-1, D) updated in place; ws of enc_frame_scan_workspace floats.  D and H
// are this build's (DTF_D, DTF_D / CR_DK), the element type of the rest T
// (bf16 with FS_BF16, else float).  With `graph`, the sequence runs as
// a CUDA graph captured for these weights, state and workspace (at most
// kMaxGraphs kept), h0 and flush copied into the workspace before it and h
// out of it after; `graph` 2 also writes the bf16 layer's transposed weights
// into the workspace first (the caller asks for it whenever the workspace
// does not hold these weights' copies).  Returns the first CUDA error of
// the launches.
extern "C" int enc_frame_scan_launch(const void* const* weights, const T* h0,
                                     const float* flush, T* hout, T* kv, T* s, T* ring, float* ws,
                                     int B, int K, int L, int F, int kc, float ffac, int graph,
                                     void* stream) {
  static_assert(sizeof(EncWeights) == kNumWeights * sizeof(void*), "EncWeights");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EncWeights w;
  const T** dst = reinterpret_cast<const T**>(&w);
  for (int i = 0; i < kNumWeights; ++i) dst[i] = static_cast<const T*>(weights[i]);
  if (!graph)
    return enqueue(w, h0, flush, hout, kv, s, ring, ws, B, K, L, F, kc, ffac, true, st);
  Bufs bf;
  carve(ws, B, K, L, F, kc, true, &bf);
  T *sh0 = reinterpret_cast<T*>(bf.h0), *shout = reinterpret_cast<T*>(bf.hout);
  const size_t hbytes = sizeof(T) * B * K * D;
  cudaError_t e = cudaMemcpyAsync(sh0, h0, hbytes, cudaMemcpyDeviceToDevice, st);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(bf.flush, flush, sizeof(float) * B * K, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
#ifdef FS_BF16
  if (graph == 2 && bf.wt) {  // the weights' transposed copies, outside the graph
    const T* wt[8];
    if (const int err = transposed(w, bf.wt, L, F, wt, true, st)) return err;
  }
#endif
  uint32_t fbits;
  std::memcpy(&fbits, &ffac, sizeof fbits);
  std::vector<uintptr_t> key;
  for (int i = 0; i < kNumWeights; ++i) key.push_back(reinterpret_cast<uintptr_t>(weights[i]));
  for (const void* p : {(const void*)kv, (const void*)s, (const void*)ring, (const void*)ws})
    key.push_back(reinterpret_cast<uintptr_t>(p));
  for (int v : {B, K, L, F, kc}) key.push_back((uintptr_t)v);
  key.push_back(fbits);
  cudaGraphExec_t exec = nullptr;
  for (size_t i = 0; i < g_graphs.size(); ++i) {
    if (g_graphs[i].key != key) continue;
    const Graph hit = g_graphs[i];
    g_graphs.erase(g_graphs.begin() + i);
    g_graphs.push_back(hit);
    exec = hit.exec;
    break;
  }
  if (!exec) {
    // captured on a stream of its own (the caller's may be the legacy
    // default stream, which cannot capture), replayed on the caller's
    cudaStream_t cap;
    if ((e = cudaStreamCreateWithFlags(&cap, cudaStreamNonBlocking)) != cudaSuccess) return e;
    if ((e = cudaStreamBeginCapture(cap, cudaStreamCaptureModeThreadLocal)) != cudaSuccess) {
      cudaStreamDestroy(cap);
      return e;
    }
    const int err =
        enqueue(w, sh0, bf.flush, shout, kv, s, ring, ws, B, K, L, F, kc, ffac, false, cap);
    cudaGraph_t g = nullptr;
    e = cudaStreamEndCapture(cap, &g);
    cudaStreamDestroy(cap);
    if (err != 0 || e != cudaSuccess) {
      if (g) cudaGraphDestroy(g);
      return err != 0 ? err : e;
    }
    e = cudaGraphInstantiate(&exec, g, 0);
    cudaGraphDestroy(g);
    if (e != cudaSuccess) return e;
    if (g_graphs.size() == kMaxGraphs) {
      cudaGraphExecDestroy(g_graphs.front().exec);
      g_graphs.erase(g_graphs.begin());
    }
    g_graphs.push_back({key, exec});
  }
  if ((e = cudaGraphLaunch(exec, st)) != cudaSuccess) return e;
  return cudaMemcpyAsync(hout, shout, hbytes, cudaMemcpyDeviceToDevice, st);
}
