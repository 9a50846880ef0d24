// A whole retention layer with carried chunk state on Hopper, float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/retention_layer_pallas.py
// (_forward and its _kernel; fused_retention_layer): the q/k/v/g projections
// (+bias, k scaled by dk^-1/2), the chunkwise core per head with per-head
// decay, the per-head group norm (eps 1e-6, non-affine), the silu(g) gate and
// the out projection (+bias).  x (B, T, D) and the state in, y (B, T, D) and
// the new state out.
//
// What bounds it on the card: operations.  Per frame 2 D (2D + 2F) + 2 F D
// for the projections (10 D^2 at F = D) and H ((L + 1)(dk + dv) + 4 dk dv)
// for the core, against 8 D bytes of x and y.
//
// The TPU kernel is one call that keeps q, k, v, g and the core's output in
// its 100 MB of VMEM.  A Hopper block has 227 KB, and the projections want
// many rows per weight tile while the core wants one (batch, head) row per
// block, so one launch of this file is three kernels on the caller's stream
// around one workspace ws (B*T, 2D + 2F) = q | k | v | g:
//   1. linear_kernel: ws = x Wqkvg^T + b, the k columns scaled;
//   2. cr::core_kernel<FINISH>: the chunkwise core (chunk_retention_core.cuh)
//      reading q, k, v from ws, with the group norm and the gate in its
//      epilogue, written over the head's g columns;
//   3. linear_kernel: y = ws[g columns] Wo^T + bo.
// So q, k, v and g make one round trip through device memory (L2 for the
// encoder's sizes); the core's output and the gated output make none beyond
// the g columns.  linear_kernel (linear.cuh) is a shared-memory tiled
// product, 128 x 128 output tile and 8 x 8 values per thread, weights in
// torch's (out, in) layout (both operands contiguous along the summed index).
#include "chunk_retention_core.cuh"
#include "linear.cuh"

#ifndef CR_DK
#error "define CR_DK and CR_DV (the key and value dims of a head)"
#endif

// gamma (H); x, y (B, T, D) with D = H * CR_DK; wqkvg (2D + 2F, D) = q | k | v |
// g rows and wo (D, F) in torch's (out, in) layout, F = H * CR_DV; ws (B*T,
// 2D + 2F) scratch; kv0, kvf (B, H, CR_DK, CR_DV); s0, sf (B, H).  T % L == 0,
// B*T <= 128 * 65535.  Returns the first CUDA error of the three launches.
extern "C" int retention_layer_launch(const float* gamma, const float* x,
                                      const float* wqkvg, const float* bqkvg,
                                      const float* wo, const float* bo, float* ws,
                                      float* y, const float* kv0, const float* s0,
                                      float* kvf, float* sf, int B, int T, int L, int H,
                                      float kscale, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int D = H * CR_DK, F = H * CR_DV, W = 2 * D + 2 * F, M = B * T;
  int err = lin::launch_linear(x, D, wqkvg, bqkvg, ws, W, M, W, D, stream, D, 2 * D, kscale);
  if (err != 0) return err;
  float* g = ws + 2 * D + F;
  cr::CoreArgs a{ws, ws + D, ws + 2 * D, W, W, W, g, W, gamma, H,
                 kv0, s0, kvf, sf, H, T, L};
  err = cr::launch_core<CR_DK, CR_DV, true>(a, B * H, stream);
  if (err != 0) return err;
  return lin::launch_linear(g, W, wo, bo, y, D, M, D, F, stream);
}
