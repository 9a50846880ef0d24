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
//
// The bf16 form (forward_seq16, built with FS_BF16) runs the same steps on
// bf16 x and weights at dec_train_fusion_pallas.py:150-297's rounding
// points: every product is one bf16 tensor-core pass (tc_bf16.cuh) with
// float32 accumulation; q | k | v come out rounded (k scaled by a bf16
// dk^-1/2 and rounded again) beside the float32 g, which a second launch
// over g's columns of the same weights writes; the core is the bf16 form of
// chunk_retention_core.cuh (float32 output and checkpoints); the gated
// value, the slot attention's q | k | v and output and the FFN hidden are
// bf16; the residual stream and the LayerNorms stay float32, each LN's
// output also written rounded for the next product.
#pragma once

#include "dec_train_fusion_common.cuh"
#include "tc_f32.cuh"
#ifdef FS_BF16
#include "tc_bf16.cuh"
#endif

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
  DTF_TRY(retention_fwd(b.qkvg, 4 * D, b.oh, b.zkv, b.ones, b.kvf, b.sf, b.kvs, b.ss, BC, T, L, C,
                        st));
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

#ifdef FS_BF16
using fs::bf16;

// the bf16 weights: the products' transposed (in, out), the biases, lns and
// lnb (3, D)
struct SeqWeights16 {
  const bf16 *tqkvg, *bqkvg, *tro, *bro, *tmi, *bmi, *tmo, *bmo, *tf1, *bf1, *tf2, *bf2;
  const bf16 *lns, *lnb;
};

// The buffers of the bf16 sequence.  qkv (R, 3D) the retention's q | k | v
// and g (R, D) its gate's float32 pre-activation; br (R, D) each sublayer's
// float32 output before its residual; x1, x2 the float32 LayerNorm outputs
// and x1lo, x2lo their bf16 copies; mqkv (R, 3D) the slot attention's q | k
// | v.  r1, r2, r3 and y may be null.
struct SeqBufs16 {
  bf16 *qkv, *gated, *x1lo, *mqkv, *attn, *x2lo, *hdrop, *y;
  float *g, *oh, *br, *x1, *x2, *hpre, *r1, *r2, *r3, *kvs, *ss;
  float *zkv, *ones, *kvf, *sf, *part;
};

// A bf16 product of the layer, C (+)= A W + bias over R rows (tc_bf16.cuh's
// precise form; TO float or bf16)
template <bool ACC = false, typename TO>
inline int lin16(const bf16* A, int lda, const bf16* W, int ldw, const bf16* bias, TO* C,
                 int ldc, int R, int N, int K, cudaStream_t st, int s_lo, int s_hi, float s,
                 float* part) {
  return tc::launch_linear<tc::kNone, ACC, true>(A, lda, W, ldw, bias, C, ldc, R, N, K, st, s_lo,
                                                 s_hi, s, part);
}

// dk^-1/2 rounded to bf16, as the TPU kernel's kscale (:175)
inline float kscale_bf16() {
  return __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt((double)DK))));
}

// Returns the first CUDA error of the launches.
inline int forward_seq16(const bf16* x, const SeqWeights16& w, const SeqBufs16& b, int B, int C,
                         int T, int L, int F, const Drop& dp, cudaStream_t st) {
  const int BC = B * C, R = BC * T;
  int err;
#define DTF_TRY(call) \
  if ((err = (call)) != 0) return err
  DTF_TRY(lin16(x, D, w.tqkvg, 4 * D, w.bqkvg, b.qkv, 3 * D, R, 3 * D, D, st, D, 2 * D,
                kscale_bf16(), b.part));
  DTF_TRY(lin16(x, D, w.tqkvg + 3 * D, 4 * D, w.bqkvg + 3 * D, b.g, D, R, D, D, st, 0, 0, 1.f,
                b.part));
  DTF_TRY(retention_fwd(b.qkv, 3 * D, b.oh, b.zkv, b.ones, b.kvf, b.sf, b.kvs, b.ss, BC, T, L, C,
                        st));
  DTF_TRY(gate_fwd(b.oh, b.g, D, b.gated, R, st));
  DTF_TRY(lin16(b.gated, D, w.tro, D, w.bro, b.br, D, R, D, D, st, 0, 0, 1.f, b.part));
  DTF_TRY(add_drop_ln(x, b.br, w.lns, w.lnb, b.r1, b.x1, R, dp, kRet, st, b.x1lo));
  DTF_TRY(lin16(b.x1lo, D, w.tmi, 3 * D, w.bmi, b.mqkv, 3 * D, R, 3 * D, D, st, 0, 0, 1.f,
                b.part));
  DTF_TRY(slot_attn(b.mqkv, nullptr, b.attn, B, dp, false, st));
  DTF_TRY(lin16(b.attn, D, w.tmo, D, w.bmo, b.br, D, R, D, D, st, 0, 0, 1.f, b.part));
  DTF_TRY(add_drop_ln(b.x1, b.br, w.lns + D, w.lnb + D, b.r2, b.x2, R, dp, kMha, st, b.x2lo));
  DTF_TRY(lin16(b.x2lo, D, w.tf1, F, w.bf1, b.hpre, F, R, F, D, st, 0, 0, 1.f, b.part));
  DTF_TRY(relu_drop(b.hpre, b.hpre, b.hdrop, R, F, dp, st));
  DTF_TRY(lin16(b.hdrop, F, w.tf2, D, w.bf2, b.br, D, R, D, F, st, 0, 0, 1.f, b.part));
  DTF_TRY(add_drop_ln(b.x2, b.br, w.lns + 2 * D, w.lnb + 2 * D, b.r3, b.y, R, dp, kFfo, st));
#undef DTF_TRY
  return 0;
}
#endif

}  // namespace dtf
