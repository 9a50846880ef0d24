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
//
// The bf16 form (built with FS_BF16; the float32 build is the code above
// unchanged): x, the weights, y, the workspace and the incoming and stored
// state (kv, scale) are bf16, rounded where retention_layer_pallas.py rounds
// (its :66-80, 123-154).  Bound: the projections' operations at the bf16
// peak (989 TFLOP/s) and the core's bytes.  Which widths take which path,
// at compile time by the head dims and by shape (D) in the entry point,
// which kernels/retention_layer.py's _launch sizes the workspace for:
//   - CR_DK = CR_DV = 64 and D % 128 == 0 (the LS decoder's and encoder's
//     D 256, H 4): ret16.cuh's layer, the products on wgmma (wg16.cuh),
//     the core with bf16 tiles and its float32 operands as three bf16
//     terms, the output and (at T = L) the new state from one launch, the
//     gated value in a workspace of its own; design notes there;
//   - any other head dims (value_factor 2's dv 128, the tests' 16 and 32)
//     or D (192: the 192-wide out projection is no multiple of wgmma's
//     128-wide tile): both projections one bf16 mma.sync pass with float32
//     accumulation (tc_bf16.cuh) and chunk_retention_tc.cuh's bf16 core
//     (bf16 scores, 3xTF32 on float32 tiles for the rest).
#include "chunk_retention_tc.cuh"
#if defined(FS_BF16) && CR_DK == 64 && CR_DV == 64
#include "ret16.cuh"
#endif

#ifndef CR_DK
#error "define CR_DK and CR_DV (the key and value dims of a head)"
#endif

#ifdef FS_BF16
using E = fs::bf16;
#else
using E = float;
#endif

// gamma (H) float32; x, y (B, T, D) with D = H * CR_DK; wqkvg (D, 2D + 2F) =
// q | k | v | g columns and wo (F, D) in the (in, out) layout, F = H *
// CR_DV; ws (B*T, 2D + 2F) scratch; scratch (B * H * (T/L) * (CR_DK * CR_DV
// + 1)) floats when T > L, else may be null; kv0, kvf (B, H, CR_DK, CR_DV);
// s0, sf (B, H).  All but gamma and scratch of the element type E (bf16 with
// FS_BF16, else float).  T % L == 0, B*T <= 128 * 65535.  On ret16.cuh's
// path ws holds (B*T, W) then (B*T, F), (W, D) and (D, F) more (see there).
// Returns the first CUDA error of the launches.
extern "C" int retention_layer_launch(const float* gamma, const E* x, const E* wqkvg,
                                      const E* bqkvg, const E* wo, const E* bo, E* ws,
                                      float* scratch, E* y, const E* kv0, const E* s0, E* kvf,
                                      E* sf, int B, int T, int L, int H, float kscale,
                                      void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int D = H * CR_DK, F = H * CR_DV, W = 2 * D + 2 * F, M = B * T;
#if defined(FS_BF16) && CR_DK == 64 && CR_DV == 64
  if (D % 128 == 0)  // retention_layer.py: _ret16
    return r16::layer16(gamma, x, wqkvg, bqkvg, wo, bo, ws, scratch, y, kv0, s0, kvf, sf, B, T,
                        L, H, kscale, stream);
#endif
#ifdef FS_BF16
  int err = tc::launch_linear(x, D, wqkvg, W, bqkvg, ws, W, M, W, D, stream, D, 2 * D, kscale);
#else
  int err = tc::launch_linear<tc::kNone, false, true>(x, D, wqkvg, W, bqkvg, ws, W, M, W, D,
                                                      stream, D, 2 * D, kscale);
#endif
  if (err != 0) return err;
  E* g = ws + 2 * D + F;
  crt::ArgsE<E> a{};
  a.q = ws, a.k = ws + D, a.v = ws + 2 * D, a.ldq = W, a.ldk = W, a.ldv = W;
  a.out = g, a.ldo = W, a.gamma = gamma, a.gmod = H;
  a.kv0 = kv0, a.s0 = s0, a.kvf = kvf, a.sf = sf;
  a.kvbuf = scratch;
  a.cbuf = scratch ? scratch + (size_t)B * H * (T / L) * CR_DK * CR_DV : nullptr;
  a.H = H, a.T = T, a.L = L;
  err = crt::launch_core<CR_DK, CR_DV, true>(a, B * H, stream);
  if (err != 0) return err;
#ifdef FS_BF16
  return tc::launch_linear(g, W, wo, D, bo, y, D, M, D, F, stream);
#else
  return tc::launch_linear<tc::kNone, false, true>(g, W, wo, D, bo, y, D, M, D, F, stream);
#endif
}
