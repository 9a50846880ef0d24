// Frame scan of the LS-EEND attractor decoder on Hopper, float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/dec_frame_scan_pallas.py
// (dec_frame_scan, its _kernel): one launch runs K frames of every lane
// through all L fusion layers.  Per frame and slot: a gamma = 1 recurrent
// retention step (output from the would-be-updated state, carry gated by
// the lane's `valid`) -> LN -> multi-head attention across the C slots of
// the lane -> LN -> relu FFN -> LN; then the l2-normed attractor times the
// l2-normed embedding gives the slot's logit.
//
// What bounds it on the card: operations.  About 67 MFLOP per lane-frame at
// the production config (D 256, F 2048, L 2, C 10), against 1.3 MB of
// carried retention state per lane.  The TPU kernel's point was holding the
// whole decoder state (84 MB in bf16) in VMEM across the block; at 128
// lanes in float32 it is 168 MB, more than Hopper's 50 MB L2, and a block
// has 227 KB of shared memory.
//
// Design: one thread block per lane, covering all C slots, because the slot
// attention couples them in every layer of every frame.  The frames loop
// inside the launch.  x (C, D) and the intermediates, the FFN hidden state
// (C, F) included (80 KB at the production config), live in dynamic shared
// memory; each weight is read once per frame from L2 and used for the C
// rows.  The lane's kv slice (L, C, H, dv, dk) is read and written in global
// memory on every frame, in the unnormalized form: ~2.6 MB per lane-frame
// of device-memory traffic, which the state's size forces on this design.
// The slot count is a compile-time constant (FS_NSLOTS) so the C
// accumulators of a weight column stay in registers.
#include "frame_scan_common.cuh"

#ifndef FS_NSLOTS
#error "build with -DFS_NSLOTS=<number of attractor slots>"
#endif

namespace {

using namespace fs;

constexpr int C = FS_NSLOTS;

struct DecWeights {
  // stacked over layers, (in, out) layouts:
  const float *wqkvg, *bqkvg, *wro, *bro;  // (L, D, 4D), (L, 4D), (L, D, D), (L, D)
  const float *wmi, *bmi, *wmo, *bmo;      // (L, D, 3D), (L, 3D), (L, D, D), (L, D)
  const float *wf1, *bf1, *wf2, *bf2;      // (L, D, F), (L, F), (L, F, D), (L, D)
  const float *lns, *lnb;                  // (L, 3, D): norm11, norm21, norm22
};
constexpr int kNumWeights = 14;

__host__ __device__ inline int dec_smem_floats(int L, int D, int H, int F) {
  const int big = F > 4 * D ? F : 4 * D;
  return 2 * C * D + C * big + pad4(C * C * H) + pad4(C * H) + pad4(L * C);
}

__global__ void __launch_bounds__(kThreads)
dec_frame_scan_kernel(DecWeights w, const float* __restrict__ embp,
                      const float* __restrict__ embn, const float* __restrict__ valid,
                      const float* __restrict__ pe, float* __restrict__ logits,
                      float* kv, float* s, int B, int K, int L, int D, int H, int dk,
                      int F, float kscale) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int dv = D / H, hd = D / H;
  const int bw = F > 4 * D ? F : 4 * D;
  float* x = sm;                       // (C, D) the lane's slot rows
  float* t1 = x + C * D;               // (C, D) head outputs / attention
  float* big = t1 + C * D;             // (C, bw) qkvg, attention qkv, FFN hidden
  float* sc = big + C * bw;            // (C, H, C) slot attention weights
  float* qk = sc + pad4(C * C * H);    // (C, H)
  float* s_cur = qk + pad4(C * H);     // (L, C) valid steps so far
  const float inv_sqrt_hd = rsqrtf((float)hd);

  for (int i = tid; i < L * C; i += nt)
    s_cur[i] = s[(((size_t)(i / C) * B + b) * C + i % C) * H];
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const size_t fr = (size_t)b * K + k;
    const float vt = valid[fr];
    for (int i = tid; i < C * D; i += nt) x[i] = embp[fr * D + i % D] + pe[i];
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const float* lns = w.lns + (size_t)l * 3 * D;
      const float* lnb = w.lnb + (size_t)l * 3 * D;
      // ---- time-axis retention, one recurrent step per slot ----
      linear_rows<C, kNone, false>(w.wqkvg + (size_t)l * D * 4 * D,
                                   w.bqkvg + (size_t)l * 4 * D, x, D, big, 4 * D, D,
                                   4 * D, 1.f);
      __syncthreads();
      qk_rows(big, 4 * D, qk, C, D, H, dk, kscale);
      __syncthreads();
      retention_rows(big, 4 * D, t1, C, D, H, dk, dv,
                     kv + ((size_t)l * B + b) * C * H * dv * dk, s_cur + l * C, vt,
                     qk, kscale, k == 0, k == K - 1);
      __syncthreads();
      ln_rows(t1, dv, t1, dv, C * H, dv, nullptr, nullptr, 1e-6f);  // group norm
      __syncthreads();
      for (int i = tid; i < C * D; i += nt) t1[i] *= silu(big[(i / D) * 4 * D + 3 * D + i % D]);
      for (int i = tid; i < C; i += nt) s_cur[l * C + i] += vt;
      __syncthreads();
      linear_rows<C, kNone, true>(w.wro + (size_t)l * D * D, w.bro + (size_t)l * D, t1, D,
                                  x, D, D, D, 1.f);
      __syncthreads();
      ln_rows(x, D, x, D, C, D, lns, lnb, 1e-5f);
      __syncthreads();
      // ---- attention across the C slots of the lane ----
      linear_rows<C, kNone, false>(w.wmi + (size_t)l * D * 3 * D,
                                   w.bmi + (size_t)l * 3 * D, x, D, big, 3 * D, D, 3 * D,
                                   1.f);
      __syncthreads();
      for (int t = tid; t < C * H * C; t += nt) {
        const int c1 = t / (H * C), h = (t / C) % H, c2 = t % C;
        const float* q = big + c1 * 3 * D + h * hd;
        const float* kk = big + c2 * 3 * D + D + h * hd;
        float a = 0.f;
        for (int j = 0; j < hd; ++j) a = fmaf(q[j], kk[j], a);
        sc[t] = a * inv_sqrt_hd;
      }
      __syncthreads();
      for (int t = tid; t < C * H; t += nt) {  // softmax over c2
        float* row = sc + t * C;
        float m = row[0];
        for (int c2 = 1; c2 < C; ++c2) m = fmaxf(m, row[c2]);
        float z = 0.f;
        for (int c2 = 0; c2 < C; ++c2) {
          row[c2] = expf(row[c2] - m);
          z += row[c2];
        }
        const float inv = 1.f / z;
        for (int c2 = 0; c2 < C; ++c2) row[c2] *= inv;
      }
      __syncthreads();
      for (int i = tid; i < C * D; i += nt) {
        const int c1 = i / D, d = i % D, h = d / hd;
        const float* p = sc + (c1 * H + h) * C;
        float a = 0.f;
        for (int c2 = 0; c2 < C; ++c2) a = fmaf(p[c2], big[c2 * 3 * D + 2 * D + d], a);
        t1[i] = a;
      }
      __syncthreads();
      linear_rows<C, kNone, true>(w.wmo + (size_t)l * D * D, w.bmo + (size_t)l * D, t1, D,
                                  x, D, D, D, 1.f);
      __syncthreads();
      ln_rows(x, D, x, D, C, D, lns + D, lnb + D, 1e-5f);
      __syncthreads();
      // ---- relu feed-forward ----
      linear_rows<C, kRelu, false>(w.wf1 + (size_t)l * D * F, w.bf1 + (size_t)l * F, x, D,
                                   big, F, D, F, 1.f);
      __syncthreads();
      linear_rows<C, kNone, true>(w.wf2 + (size_t)l * F * D, w.bf2 + (size_t)l * D, big, F,
                                  x, D, F, D, 1.f);
      __syncthreads();
      ln_rows(x, D, x, D, C, D, lns + 2 * D, lnb + 2 * D, 1e-5f);
      __syncthreads();
    }
    // ---- logits: l2-normed attractor . l2-normed embedding ----
    for (int c = warp; c < C; c += nw) {
      float n2 = 0.f, dot = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float v = x[c * D + d];
        n2 = fmaf(v, v, n2);
        dot = fmaf(embn[fr * D + d], v, dot);
      }
      n2 = warp_sum(n2);
      dot = warp_sum(dot);
      if (lane == 0) logits[fr * C + c] = dot * rsqrtf(n2);
    }
    __syncthreads();
  }

  for (int i = tid; i < L * C * H; i += nt) {
    const int l = i / (C * H), c = (i / H) % C, h = i % H;
    s[(((size_t)l * B + b) * C + c) * H + h] = s_cur[l * C + c];
  }
}

}  // namespace

// weights: kNumWeights device pointers in DecWeights order.  kv (L, B*C, H,
// dv, dk) and s (L, B*C, H) are updated in place.  Returns
// cudaGetLastError() after the launch.
extern "C" int dec_frame_scan_launch(const void* const* weights, const float* embp,
                                     const float* embn, const float* valid,
                                     const float* pe, float* logits, float* kv, float* s,
                                     int B, int K, int L, int D, int H, int dk, int F,
                                     float kscale, void* stream) {
  static_assert(sizeof(DecWeights) == kNumWeights * sizeof(void*), "DecWeights");
  DecWeights w;
  const float** dst = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < kNumWeights; ++i) dst[i] = static_cast<const float*>(weights[i]);
  const size_t smem = sizeof(float) * dec_smem_floats(L, D, H, F);
  cudaError_t err = cudaFuncSetAttribute(
      dec_frame_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dec_frame_scan_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, embp, embn, valid, pe, logits, kv, s, B, K, L, D, H, dk, F, kscale);
  return cudaGetLastError();
}
