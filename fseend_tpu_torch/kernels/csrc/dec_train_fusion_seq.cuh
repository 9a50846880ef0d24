// The forward sequence of one decoder fusion layer in training semantics,
// float32, shared by dtf_forward (dec_train_fusion_fwd.cu) and the
// recompute of dtf_backward (dec_train_fusion_bwd.cu), so that the
// activations the backward recomputes are the forward's to the bit.
//
// On the slot-major grid x (B, C, T, D) (rows r = (b*C + c)*T + t), each
// activation one round trip through device memory:
//   1. mm            qkvg = x Wqkvg + b, k columns scaled by dk^-1/2
//   2. retention_fwd the chunkwise core (chunk_retention_core.cuh), one block
//                    per (b, c, head), writing the checkpoints when asked
//   3. gate_fwd      silu(g) * groupnorm(core output)
//   4. mm, add_drop_ln   out projection; dropout, residual, LayerNorm
//   5. mm, slot_attn     q | k | v, attention over the C slots per warp
//   6. mm, add_drop_ln
//   7. mm, relu_drop, mm, add_drop_ln   the FFN
// Every product runs on the tensor cores in tc_f32.cuh's precise 3xTF32
// form (each 32-deep k tile's sum added on the FMA pipe, the small parts
// rounded to nearest), with the weights transposed to (in, out); a product
// of few output tiles is split along k into the caller's scratch and its
// partials added in a fixed order.
#pragma once

#include "dec_train_fusion_common.cuh"
#include "tc_f32.cuh"

namespace dtf {

// The layer's products over R rows of contiguous operands: C (R, N) = (A (R,
// K) W (K, N) + bias) * sc(n), and dx (R, D) += A (R, K) W (K, D), an input
// gradient with W in torch's (out, in) layout
inline int mm(const float* A, const float* W, const float* bias, float* C, int R, int N, int K,
              cudaStream_t st, float* part, int s_lo = 0, int s_hi = 0, float s = 1.f) {
  return tc::launch_linear<tc::kNone, false, true>(A, K, W, N, bias, C, N, R, N, K, st, s_lo,
                                                   s_hi, s, part);
}

inline int mm_add(const float* A, const float* W, float* dx, int R, int K, cudaStream_t st,
                  float* part) {
  return tc::launch_linear<tc::kNone, true, true>(A, K, W, D, nullptr, dx, D, R, D, K, st, 0, 0,
                                                  1.f, part);
}

// the weights: the products' transposed (in, out), the biases, lns and lnb
// (3, D)
struct SeqWeights {
  const float *tqkvg, *bqkvg, *tro, *bro, *tmi, *bmi, *tmo, *bmo, *tf1, *bf1, *tf2, *bf2;
  const float *lns, *lnb;
};

// The buffers the sequence writes.  r1, r2, r3 (the LayerNorms' pre-norm
// sums, for the backward), y, and kvs / ss (the per-chunk checkpoints) may
// be null; hdrop may be hpre (relu and dropout in place).  zkv, ones, kvf,
// sf are the core's per-(sequence, head) scratch, part tc::kSplitFloats
// floats for a split along k.
struct SeqBufs {
  float *qkvg, *oh, *gated, *a, *x1, *qkv, *attn, *s, *x2, *hpre, *hdrop, *f;
  float *r1, *r2, *r3, *y, *kvs, *ss;
  float *zkv, *ones, *kvf, *sf, *part;
};

// Returns the first CUDA error of the launches.
inline int forward_seq(const float* x, const SeqWeights& w, const SeqBufs& b, int B, int C,
                       int T, int L, int F, const Drop& dp, cudaStream_t st) {
  const int BC = B * C, R = BC * T;
  const float kscale = (float)(1.0 / sqrt((double)DK));
  int err;
#define DTF_TRY(call) \
  if ((err = (call)) != 0) return err
  DTF_TRY(mm(x, w.tqkvg, w.bqkvg, b.qkvg, R, 4 * D, D, st, b.part, D, 2 * D, kscale));
  DTF_TRY(retention_fwd(b.qkvg, b.oh, b.zkv, b.ones, b.kvf, b.sf, b.kvs, b.ss, BC, T, L, C, st));
  DTF_TRY(gate_fwd(b.oh, b.qkvg + 3 * D, 4 * D, b.gated, R, st));
  DTF_TRY(mm(b.gated, w.tro, w.bro, b.a, R, D, D, st, b.part));
  DTF_TRY(add_drop_ln(x, b.a, w.lns, w.lnb, b.r1, b.x1, R, dp, kRet, st));
  DTF_TRY(mm(b.x1, w.tmi, w.bmi, b.qkv, R, 3 * D, D, st, b.part));
  DTF_TRY(slot_attn(b.qkv, nullptr, b.attn, B, dp, false, st));
  DTF_TRY(mm(b.attn, w.tmo, w.bmo, b.s, R, D, D, st, b.part));
  DTF_TRY(add_drop_ln(b.x1, b.s, w.lns + D, w.lnb + D, b.r2, b.x2, R, dp, kMha, st));
  DTF_TRY(mm(b.x2, w.tf1, w.bf1, b.hpre, R, F, D, st, b.part));
  DTF_TRY(relu_drop(b.hpre, b.hpre, b.hdrop, R, F, dp, st));
  DTF_TRY(mm(b.hdrop, w.tf2, w.bf2, b.f, R, D, F, st, b.part));
  DTF_TRY(add_drop_ln(b.x2, b.f, w.lns + 2 * D, w.lnb + 2 * D, b.r3, b.y, R, dp, kFfo, st));
#undef DTF_TRY
  return 0;
}

}  // namespace dtf
