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
// for the core, against 8 D bytes of x and y; on the tensor cores at three
// TF32 passes.
//
// The TPU kernel is one call that keeps q, k, v, g and the core's output in
// its 100 MB of VMEM.  A Hopper block has 227 KB, and the projections want
// many rows per weight tile while the core wants (batch, head) rows, so one
// launch of this file is a sequence of kernels on the caller's stream around
// one workspace ws (B*T, 2D + 2F) = q | k | v | g:
//   1. tc::linear_kernel (tc_f32.cuh, 3xTF32 in the precise form): ws =
//      x Wqkvg + b, the k columns scaled;
//   2. the chunkwise core of chunk_retention_tc.cuh reading q, k, v from ws
//      (the state pass, the scan over chunks when T > L, the output pass),
//      with the group norm and the gate in the output pass's epilogue,
//      written over the head's g columns;
//   3. tc::linear_kernel, precise form: y = ws[g columns] Wo + bo.
// The precise form (each 32-deep k tile's sum added on the FMA pipe, the
// small parts rounded to nearest) because the plain form's truncating
// accumulator, over the projections' 256-deep sums, drifts by ~1e-5 of q,
// k, v and g, which the gate and the out projection carry into y: 1.4e-4
// from plain at the encoder's shape, against 1e-4 allowed.
// The weights come in the (in, out) layout the products read (Wqkvg (D,
// 2D + 2F), Wo (F, D)), packed once per server.  So q, k, v and g make one
// round trip through device memory (L2 for the encoder's sizes); the core's
// output and the gated output make none beyond the g columns.
#include "chunk_retention_tc.cuh"

#ifndef CR_DK
#error "define CR_DK and CR_DV (the key and value dims of a head)"
#endif

// gamma (H); x, y (B, T, D) with D = H * CR_DK; wqkvg (D, 2D + 2F) = q | k | v
// | g columns and wo (F, D) in the (in, out) layout, F = H * CR_DV; ws (B*T,
// 2D + 2F) scratch; scratch (B * H * (T/L) * (CR_DK * CR_DV + 1)) floats when
// T > L, else may be null; kv0, kvf (B, H, CR_DK, CR_DV); s0, sf (B, H).
// T % L == 0, B*T <= 128 * 65535.  Returns the first CUDA error of the
// launches.
extern "C" int retention_layer_launch(const float* gamma, const float* x,
                                      const float* wqkvg, const float* bqkvg,
                                      const float* wo, const float* bo, float* ws,
                                      float* scratch, float* y, const float* kv0,
                                      const float* s0, float* kvf, float* sf, int B, int T,
                                      int L, int H, float kscale, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int D = H * CR_DK, F = H * CR_DV, W = 2 * D + 2 * F, M = B * T;
  int err = tc::launch_linear<tc::kNone, false, true>(x, D, wqkvg, W, bqkvg, ws, W, M, W, D,
                                                      stream, D, 2 * D, kscale);
  if (err != 0) return err;
  float* g = ws + 2 * D + F;
  crt::Args a{};
  a.q = ws, a.k = ws + D, a.v = ws + 2 * D, a.ldq = W, a.ldk = W, a.ldv = W;
  a.out = g, a.ldo = W, a.gamma = gamma, a.gmod = H;
  a.kv0 = kv0, a.s0 = s0, a.kvf = kvf, a.sf = sf;
  a.kvbuf = scratch;
  a.cbuf = scratch ? scratch + (size_t)B * H * (T / L) * CR_DK * CR_DV : nullptr;
  a.H = H, a.T = T, a.L = L;
  err = crt::launch_core<CR_DK, CR_DV, true>(a, B * H, stream);
  if (err != 0) return err;
  return tc::launch_linear<tc::kNone, false, true>(g, W, wo, D, bo, y, D, M, D, F, stream);
}
