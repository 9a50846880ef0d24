// One decoder fusion layer in training semantics, forward, on Hopper,
// float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/dec_train_fusion_pallas.py
// (_fwd_call and its _fwd_kernel): on the slot-major grid x (B, C, T, D),
// gamma = 1 chunkwise retention over T per (b, c, head) from a zero state,
// group norm and silu gate, out projection, dropout, residual, LayerNorm;
// attention across the C slots of each frame with dropout on its weights,
// out projection, dropout, residual, LayerNorm; relu FFN with dropout on the
// hidden and the output, residual, LayerNorm.  Writes y and, for the
// backward, the state each chunk reads (kvs, ss).
//
// What bounds it on the card: operations.  Per (frame, slot) row the
// products take 2 D (4D + D + 3D + D + 2F) operations (3.4 MFLOP at D 256,
// F 2048) plus the core's H ((L + 1)(dk + dv) + 4 dk dv) and the slot
// attention's 4 C D, against 8 D bytes of x and y.
//
// The TPU kernel keeps a whole chunk's activations in VMEM and makes one
// pass.  A Hopper block has 227 KB and the chunk of (C, L, F) hidden values
// alone is 10 MB at the production shape, so this file is a sequence of the
// repository's kernels on the caller's stream around one workspace, each
// activation making one round trip through device memory (L2 in part):
//   1. lin::linear_kernel  qkvg = x Wqkvg^T + b, k columns scaled by dk^-1/2
//   2. cr::core_kernel     the chunkwise core (chunk_retention_core.cuh), one
//                          block per (b, c, head), writing the checkpoints
//   3. gate_fwd            silu(g) * groupnorm(core output)
//   4. linear, add_drop_ln out projection; dropout, residual, LayerNorm
//   5. linear, slot_attn   q | k | v, attention over the C slots per warp
//   6. linear, add_drop_ln
//   7. linear, relu_drop, linear, add_drop_ln   the FFN
// Dropout masks are the JAX kernel's counter hash, computed where they are
// applied (dec_train_fusion_common.cuh), so no mask is stored.
#include "dec_train_fusion_common.cuh"

using namespace dtf;

namespace {

struct FwdBufs {
  float *qkvg, *oh, *gated, *a, *x1, *qkv, *attn, *s, *x2, *h, *f;
  float *zkv, *ones, *kvf, *sf;
};

size_t carve_fwd(float* base, int BC, int T, int F, FwdBufs* b) {
  const size_t R = (size_t)BC * T, rows = (size_t)BC * H;
  Carve c{base};
  b->qkvg = c.take(R * 4 * D);
  b->oh = c.take(R * D);
  b->gated = c.take(R * D);
  b->a = c.take(R * D);
  b->x1 = c.take(R * D);
  b->qkv = c.take(R * 3 * D);
  b->attn = c.take(R * D);
  b->s = c.take(R * D);
  b->x2 = c.take(R * D);
  b->h = c.take(R * F);
  b->f = c.take(R * D);
  b->zkv = c.take(rows * DK * DK);
  b->kvf = c.take(rows * DK * DK);
  b->ones = c.take(rows);
  b->sf = c.take(rows);
  return c.used;
}

}  // namespace

// floats of workspace dtf_forward needs for BC = B*C sequences of T frames
extern "C" size_t dtf_fwd_workspace(int BC, int T, int H_, int F) {
  FwdBufs b;
  return H_ == H ? carve_fwd(nullptr, BC, T, F, &b) : 0;
}

// x, y (B, C, T, D); the 14 weights in torch's (out, in) layout (lns, lnb
// (3, D)); kvs (B, T/L, H, C, DK, DK) and ss (B, T/L, H, C), both null for
// no checkpoints; ws of dtf_fwd_workspace floats.  T % L == 0, F % 16 == 0.
// Returns the first CUDA error of the launches.
extern "C" int dtf_forward(const float* x, const float* wqkvg, const float* bqkvg,
                           const float* wro, const float* bro, const float* wmi,
                           const float* bmi, const float* wmo, const float* bmo,
                           const float* wf1, const float* bf1, const float* wf2,
                           const float* bf2, const float* lns, const float* lnb, float* y,
                           float* kvs, float* ss, float* ws, int B, int C, int T, int L, int F,
                           unsigned seed, unsigned thr, float mult, void* stream_) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const int BC = B * C, R = BC * T;
  const Drop dp{seed, thr, mult, C, T, L};
  const float kscale = (float)(1.0 / sqrt((double)DK));
  FwdBufs b;
  carve_fwd(ws, BC, T, F, &b);
  int err;
#define DTF_TRY(call) \
  if ((err = (call)) != 0) return err
  DTF_TRY(lin::launch_linear(x, D, wqkvg, bqkvg, b.qkvg, 4 * D, R, 4 * D, D, st, D, 2 * D, kscale));
  DTF_TRY(retention_fwd(b.qkvg, b.oh, b.zkv, b.ones, b.kvf, b.sf, kvs, ss, BC, T, L, C, st));
  DTF_TRY(gate_fwd(b.oh, b.qkvg + 3 * D, 4 * D, b.gated, R, st));
  DTF_TRY(lin::launch_linear(b.gated, D, wro, bro, b.a, D, R, D, D, st));
  DTF_TRY(add_drop_ln(x, b.a, lns, lnb, nullptr, b.x1, R, dp, kRet, st));
  DTF_TRY(lin::launch_linear(b.x1, D, wmi, bmi, b.qkv, 3 * D, R, 3 * D, D, st));
  DTF_TRY(slot_attn(b.qkv, nullptr, b.attn, B, dp, false, st));
  DTF_TRY(lin::launch_linear(b.attn, D, wmo, bmo, b.s, D, R, D, D, st));
  DTF_TRY(add_drop_ln(b.x1, b.s, lns + D, lnb + D, nullptr, b.x2, R, dp, kMha, st));
  DTF_TRY(lin::launch_linear(b.x2, D, wf1, bf1, b.h, F, R, F, D, st));
  DTF_TRY(relu_drop(b.h, b.h, b.h, R, F, dp, st));
  DTF_TRY(lin::launch_linear(b.h, F, wf2, bf2, b.f, D, R, D, F, st));
  DTF_TRY(add_drop_ln(b.x2, b.f, lns + 2 * D, lnb + 2 * D, nullptr, y, R, dp, kFfo, st));
#undef DTF_TRY
  return 0;
}
