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
#include <cstdint>
#include <cstring>
#include <vector>

#include "frame_ret.cuh"
#include "tc_f32.cuh"
#ifdef FS_BF16
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

// The conv module's middle for one lane (blockIdx.x) and kCg channels
// (blockIdx.y) over the slice: GLU of pw1's output (pw (R, 2D)), the causal
// depthwise conv as a gather over S (see the note at the top; S in shared
// memory, (kc + Kc) x kCg), the folded BatchNorm and silu into out (R, D).
// The window at the start of the slice comes from the carried history
// (ring (B, kc-1, D) with a zero slot 0) on the first slice, else from win
// (B, kc, D); the window after it goes to win, or on the last slice its last
// kc - 1 slots to ring.
constexpr int kCg = 32;

__global__ void __launch_bounds__(256)
conv_kernel(const float* __restrict__ pw, const float* __restrict__ gate,
            const T* __restrict__ dw, const T* __restrict__ bna, const T* __restrict__ bnb,
            T* __restrict__ out, T* ring, float* win, int Kc, int kc, bool first, bool last) {
  extern __shared__ __align__(16) float sm[];
  float* S = sm;                                      // (kc + Kc, kCg)
  int* pos = reinterpret_cast<int*>(S + (kc + Kc) * kCg);  // (Kc) n_k
  const int b = blockIdx.x, d0 = blockIdx.y * kCg, tid = threadIdx.x, nt = blockDim.x;
  const float* g = gate + (size_t)b * Kc;
  if (tid == 0) {  // kept frames up to and including each frame, in frame order
    int n = 0;
    for (int k = 0; k < Kc; ++k) {
      n += g[k] != 0.f;
      pos[k] = n;
    }
  }
  for (int i = tid; i < kc * kCg; i += nt) {
    const int j = i / kCg, c = i % kCg;
    S[i] = first ? (j == 0 ? 0.f : fs::f32(ring[((size_t)b * (kc - 1) + j - 1) * D + d0 + c]))
                 : win[((size_t)b * kc + j) * D + d0 + c];
  }
  __syncthreads();
  for (int i = tid; i < Kc * kCg; i += nt) {  // a kept frame's GLU output goes to S[kc - 1 + n_k]
    const int k = i / kCg, c = i % kCg;
    if (g[k] != 0.f) {
      const float* p = pw + ((size_t)b * Kc + k) * 2 * D + d0 + c;
      S[(kc - 1 + pos[k]) * kCg + c] = fs::rnd<T>(p[0] * fs::sigmoid(p[D]));
    }
  }
  __syncthreads();
  for (int i = tid; i < Kc * kCg; i += nt) {
    const int k = i / kCg, c = i % kCg, d = d0 + c;
    const float* s = S + pos[k] * kCg + c;
    float y = 0.f;
    for (int j = 0; j < kc; ++j) y = fmaf(s[j * kCg], fs::ldg(dw + (size_t)j * D + d), y);
    y = y * fs::ldg(bna + d) + fs::ldg(bnb + d);
    out[((size_t)b * Kc + k) * D + d] = fs::As<T>::from(fs::silu(y));
  }
  const int n = pos[Kc - 1];
  for (int i = tid; i < kc * kCg; i += nt) {
    const int j = i / kCg, c = i % kCg;
    const float v = S[(n + j) * kCg + c];
    if (!last)
      win[((size_t)b * kc + j) * D + d0 + c] = v;
    else if (j > 0)
      ring[((size_t)b * (kc - 1) + j - 1) * D + d0 + c] = fs::As<T>::from(v);
  }
}

struct Bufs {
  float *x0, *x1, *t, *t2, *a, *big, *gate, *s0, *win, *part;
  float *h0, *flush, *hout;  // the staged operands of a graph call
};

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
  if (graph) {
    b->h0 = c.take((size_t)B * K * D);
    b->flush = c.take((size_t)B * K);
    b->hout = c.take((size_t)B * K * D);
  }
  return c.used;
}

// the launch sequence of one call
int enqueue(const EncWeights& w, const T* h0, const float* flush, T* hout, T* kv, T* s, T* ring,
            float* ws, int B, int K, int L, int F, int kc, float ffac, cudaStream_t st) {
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
  const size_t csmem = sizeof(float) * (kc + kSlice) * kCg + sizeof(int) * kSlice;
  int err;
#define EFS_TRY(call) \
  if ((err = (call)) != 0) return err
  EFS_TRY(cudaFuncSetAttribute(ret_block_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rsmem));
  EFS_TRY(cudaFuncSetAttribute(conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)csmem));
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
    s0_kernel<T><<<(L * B + 255) / 256, 256, 0, st>>>(s, bf.s0, L * B);
    EFS_TRY(cudaGetLastError());
    enc_in_kernel<<<copy_grid, 256, 0, st>>>(h0, flush, x0, bf.gate, Kc, K, k0, n4);
    EFS_TRY(cudaGetLastError());
    T *x = x0, *y = x1;
    const int rg = row_grid(R);
    add_ln_kernel<<<rg, 256, 0, st>>>(x, nullptr, nullptr, w.lns, w.lnb, t, nullptr, nullptr,
                                      nullptr, R);
    EFS_TRY(cudaGetLastError());
    for (int l = 0; l < L; ++l) {
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
      conv_kernel<<<dim3(B, D / kCg), 256, csmem, st>>>(
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
// out of it after.  Returns the first CUDA error of the launches.
extern "C" int enc_frame_scan_launch(const void* const* weights, const T* h0,
                                     const float* flush, T* hout, T* kv, T* s, T* ring, float* ws,
                                     int B, int K, int L, int F, int kc, float ffac, int graph,
                                     void* stream) {
  static_assert(sizeof(EncWeights) == kNumWeights * sizeof(void*), "EncWeights");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EncWeights w;
  const T** dst = reinterpret_cast<const T**>(&w);
  for (int i = 0; i < kNumWeights; ++i) dst[i] = static_cast<const T*>(weights[i]);
  if (!graph) return enqueue(w, h0, flush, hout, kv, s, ring, ws, B, K, L, F, kc, ffac, st);
  Bufs bf;
  carve(ws, B, K, L, F, kc, true, &bf);
  T *sh0 = reinterpret_cast<T*>(bf.h0), *shout = reinterpret_cast<T*>(bf.hout);
  const size_t hbytes = sizeof(T) * B * K * D;
  cudaError_t e = cudaMemcpyAsync(sh0, h0, hbytes, cudaMemcpyDeviceToDevice, st);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(bf.flush, flush, sizeof(float) * B * K, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
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
        enqueue(w, sh0, bf.flush, shout, kv, s, ring, ws, B, K, L, F, kc, ffac, cap);
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
