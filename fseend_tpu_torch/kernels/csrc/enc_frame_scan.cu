// Frame scan of the LS-EEND conformer encoder on Hopper, float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/enc_frame_scan_pallas.py
// (enc_frame_scan, its _kernel): one launch runs K frames of every lane
// through all L conformer blocks (half FF (silu) -> pre-LN recurrent gamma=1
// retention -> LN, pw1, GLU, causal depthwise conv over a k-slot ring,
// folded BatchNorm, silu, pw2 -> half FF -> LN), with a per-lane flush that
// gates the retention update and keeps the ring.
//
// What bounds it on the card: operations.  About 12.9 MFLOP per lane-frame
// at the production config (D 256, F 1024, L 4), against 0.5 MB of carried
// retention state per lane.  The TPU kernel held all lanes' state in its
// ~120 MB VMEM across the block; a Hopper SM has 227 KB of shared memory,
// and the state of 128 lanes is 34 MB of kv plus 8 MB of rings.
//
// Design: one thread block per lane, 256 threads, looping over the K frames
// inside the launch.  The lane's activations and its L conv rings (64 KB at
// the production config) stay in shared memory for the whole launch; its
// retention kv (256 KB) is read and written in global memory on every frame,
// carried in the unnormalized form (one FMA per element per frame).  Each
// weight is read once per frame per lane from L2, used for one row: the
// matrix-vector products are bound by L2 bandwidth, not by the FMA rate.
// Several lanes per block (weight reuse), tensor cores and bf16 are later
// work.
#include "frame_scan_common.cuh"

namespace {

using namespace fs;

struct EncWeights {
  // stacked over layers, (in, out) layouts:
  const float *lns, *lnb;                    // (L, 5, D): ff1, ret, conv, ff2, final
  const float *wf1a, *bf1a, *wf1b, *bf1b;    // (L, D, F), (L, F), (L, F, D), (L, D)
  const float *wqkvg, *bqkvg, *wro, *bro;    // (L, D, 4D), (L, 4D), (L, D, D), (L, D)
  const float *wpw1, *bpw1, *dw, *bna, *bnb; // (L, D, 2D), (L, 2D), (L, k, D), (L, D) x2
  const float *wpw2, *bpw2;                  // (L, D, D), (L, D)
  const float *wf2a, *bf2a, *wf2b, *bf2b;    // as ff1
};
constexpr int kNumWeights = 21;

__host__ __device__ inline int enc_smem_floats(int L, int D, int H, int F, int kc) {
  const int hb = F > 4 * D ? F : 4 * D;
  return 2 * D + pad4(hb) + L * kc * D + pad4(L) + pad4(H);
}

__global__ void __launch_bounds__(kThreads)
enc_frame_scan_kernel(EncWeights w, const float* __restrict__ h0,
                      const float* __restrict__ flush, float* __restrict__ hout,
                      float* kv, float* s, float* ring_g, int B, int K, int L,
                      int D, int H, int dk, int F, int kc, float ffac, float kscale) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int dv = D / H;
  float* x = sm;                                    // (D) the lane's activation
  float* t1 = x + D;                                // (D) normed input / head outputs
  float* hb = t1 + D;                               // (max(F, 4D)) hidden / qkvg
  float* ring = hb + pad4(F > 4 * D ? F : 4 * D);   // (L, kc, D) conv windows
  float* s_cur = ring + L * kc * D;                 // (L) valid steps so far
  float* qk = s_cur + pad4(L);                      // (H)

  // the carried (kc-1)-frame history goes to ring slots 1..kc-1; slot 0 is
  // the slot that falls out at the next shift (zero, as the TPU packer had it)
  for (int i = tid; i < L * kc * D; i += nt) {
    const int l = i / (kc * D), j = (i / D) % kc, d = i % D;
    ring[i] = j == 0 ? 0.f : ring_g[(((size_t)l * B + b) * (kc - 1) + (j - 1)) * D + d];
  }
  for (int l = tid; l < L; l += nt) s_cur[l] = s[((size_t)l * B + b) * H];
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const size_t fr = (size_t)b * K + k;
    const float fl = flush[fr];
    const float mg = 1.f - fl;  // retention update gate
    for (int d = tid; d < D; d += nt) x[d] = h0[fr * D + d];
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const float* lns = w.lns + (size_t)l * 5 * D;
      const float* lnb = w.lnb + (size_t)l * 5 * D;
      // ---- half feed-forward #1 ----
      ln_rows(x, D, t1, D, 1, D, lns, lnb, 1e-5f);
      __syncthreads();
      linear_rows<1, kSilu, false>(w.wf1a + (size_t)l * D * F, w.bf1a + (size_t)l * F,
                                   t1, D, hb, F, D, F, 1.f);
      __syncthreads();
      linear_rows<1, kNone, true>(w.wf1b + (size_t)l * F * D, w.bf1b + (size_t)l * D,
                                  hb, F, x, D, F, D, ffac);
      __syncthreads();
      // ---- retention (pre-LN), one recurrent step ----
      ln_rows(x, D, t1, D, 1, D, lns + D, lnb + D, 1e-5f);
      __syncthreads();
      linear_rows<1, kNone, false>(w.wqkvg + (size_t)l * D * 4 * D,
                                   w.bqkvg + (size_t)l * 4 * D, t1, D, hb, 4 * D, D,
                                   4 * D, 1.f);
      __syncthreads();
      qk_rows(hb, 4 * D, qk, 1, D, H, dk, kscale);
      __syncthreads();
      retention_rows(hb, 4 * D, t1, 1, D, H, dk, dv,
                     kv + ((size_t)l * B + b) * H * dv * dk, s_cur + l, mg, qk,
                     kscale, k == 0, k == K - 1);
      __syncthreads();
      ln_rows(t1, dv, t1, dv, H, dv, nullptr, nullptr, 1e-6f);  // group norm
      __syncthreads();
      for (int i = tid; i < D; i += nt) t1[i] *= silu(hb[3 * D + i]);
      if (tid == 0) s_cur[l] += mg;
      __syncthreads();
      linear_rows<1, kNone, true>(w.wro + (size_t)l * D * D, w.bro + (size_t)l * D, t1,
                                  D, x, D, D, D, 1.f);
      __syncthreads();
      // ---- causal depthwise conv module ----
      ln_rows(x, D, t1, D, 1, D, lns + 2 * D, lnb + 2 * D, 1e-5f);
      __syncthreads();
      linear_rows<1, kNone, false>(w.wpw1 + (size_t)l * D * 2 * D,
                                   w.bpw1 + (size_t)l * 2 * D, t1, D, hb, 2 * D, D,
                                   2 * D, 1.f);
      __syncthreads();
      for (int d = tid; d < D; d += nt) {  // one thread owns channel d's ring
        float* rg = ring + (size_t)l * kc * D + d;
        const float* dwl = w.dw + (size_t)l * kc * D + d;
        float y = 0.f;
        if (fl != 0.f) {  // flushed: the ring stays, y reads it as it is
          for (int j = 0; j < kc; ++j) y = fmaf(rg[j * D], __ldg(dwl + j * D), y);
        } else {
          for (int j = 0; j + 1 < kc; ++j) {
            const float v = rg[(j + 1) * D];
            rg[j * D] = v;
            y = fmaf(v, __ldg(dwl + j * D), y);
          }
          const float glu = hb[d] * sigmoid(hb[D + d]);
          rg[(kc - 1) * D] = glu;
          y = fmaf(glu, __ldg(dwl + (kc - 1) * D), y);
        }
        y = y * __ldg(w.bna + (size_t)l * D + d) + __ldg(w.bnb + (size_t)l * D + d);
        t1[d] = silu(y);
      }
      __syncthreads();
      linear_rows<1, kNone, true>(w.wpw2 + (size_t)l * D * D, w.bpw2 + (size_t)l * D,
                                  t1, D, x, D, D, D, 1.f);
      __syncthreads();
      // ---- half feed-forward #2, final LN ----
      ln_rows(x, D, t1, D, 1, D, lns + 3 * D, lnb + 3 * D, 1e-5f);
      __syncthreads();
      linear_rows<1, kSilu, false>(w.wf2a + (size_t)l * D * F, w.bf2a + (size_t)l * F,
                                   t1, D, hb, F, D, F, 1.f);
      __syncthreads();
      linear_rows<1, kNone, true>(w.wf2b + (size_t)l * F * D, w.bf2b + (size_t)l * D,
                                  hb, F, x, D, F, D, ffac);
      __syncthreads();
      ln_rows(x, D, x, D, 1, D, lns + 4 * D, lnb + 4 * D, 1e-5f);
      __syncthreads();
    }
    for (int d = tid; d < D; d += nt) hout[fr * D + d] = x[d];
  }

  for (int i = tid; i < L * kc * D; i += nt) {
    const int l = i / (kc * D), j = (i / D) % kc, d = i % D;
    if (j > 0) ring_g[(((size_t)l * B + b) * (kc - 1) + (j - 1)) * D + d] = ring[i];
  }
  for (int i = tid; i < L * H; i += nt) s[((size_t)(i / H) * B + b) * H + i % H] = s_cur[i / H];
}

}  // namespace

// weights: kNumWeights device pointers in EncWeights order.  kv (L, B, H,
// dv, dk), s (L, B, H) and ring (L, B, kc-1, D) are updated in place.
// Returns cudaGetLastError() after the launch.
extern "C" int enc_frame_scan_launch(const void* const* weights, const float* h0,
                                     const float* flush, float* hout, float* kv,
                                     float* s, float* ring, int B, int K, int L,
                                     int D, int H, int dk, int F, int kc, float ffac,
                                     float kscale, void* stream) {
  static_assert(sizeof(EncWeights) == kNumWeights * sizeof(void*), "EncWeights");
  EncWeights w;
  const float** dst = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < kNumWeights; ++i) dst[i] = static_cast<const float*>(weights[i]);
  const size_t smem = sizeof(float) * enc_smem_floats(L, D, H, F, kc);
  cudaError_t err = cudaFuncSetAttribute(
      enc_frame_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  enc_frame_scan_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, h0, flush, hout, kv, s, ring, B, K, L, D, H, dk, F, kc, ffac, kscale);
  return cudaGetLastError();
}
