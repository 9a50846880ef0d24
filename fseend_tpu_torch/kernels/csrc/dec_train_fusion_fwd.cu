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
// alone is 10 MB at the production shape, so this file runs the forward
// sequence of dec_train_fusion_seq.cuh (shared with the backward's
// recompute) on the caller's stream around one workspace, each activation
// making one round trip through device memory (L2 in part): its products on
// the tensor cores in tc_f32.cuh's precise 3xTF32 form, the chunkwise core
// (chunk_retention_core.cuh) writing the checkpoints, and the row kernels of
// dec_train_fusion_common.cuh.  Dropout masks are the JAX kernel's counter
// hash, computed where they are applied, so no mask is stored.
//
// The bf16 form (built with FS_BF16; the float32 build is the code above
// unchanged) takes bf16 x and weights and writes a bf16 y, with the
// checkpoints float32 (dec_train_fusion_pallas.py:574-617): the sequence's
// bf16 form (forward_seq16), its products one bf16 tensor-core pass each.
// Bound: the same operations at the bf16 peak (989 TFLOP/s).  At the
// production width (D 256, head dim 64, F a multiple of 128) the bf16 form
// runs dtf_tc16.cuh's forward instead (wgmma products with fused
// epilogues, the chunk-parallel core on the tensor cores), which needs the
// checkpoint buffers (kvs, ss) on every call; other widths, whose rows the
// 128-wide product tiles do not divide, keep forward_seq16.
#include "dec_train_fusion_seq.cuh"
#if defined(FS_BF16) && DTF_D == 256 && CR_DK == 64
#define DTF_TC16 1
#include "dtf_tc16.cuh"
#endif

using namespace dtf;

namespace {

#ifdef FS_BF16
using E = fs::bf16;

#ifdef DTF_TC16
inline bool tc16_width(int F) { return F % 128 == 0; }

// the transposed weights (out, in), then the activations
size_t carve_fwd_tc16(float* base, int BC, int T, int F, t16::Bufs16* b, bf16** wt) {
  const size_t R = (size_t)BC * T;
  Carve c{base};
  *b = t16::Bufs16{};
  const size_t n[6] = {(size_t)4 * D * D, (size_t)D * D, (size_t)3 * D * D, (size_t)D * D,
                       (size_t)F * D, (size_t)D * F};
  for (int i = 0; i < 6; ++i) wt[i] = c.take16(n[i]);
  b->qkv = c.take16(R * 3 * D);
  b->mqkv = c.take16(R * 3 * D);
  for (bf16** p : {&b->gated, &b->x1lo, &b->attn, &b->x2lo}) *p = c.take16(R * D);
  for (float** p : {&b->g, &b->x1, &b->x2}) *p = c.take(R * D);
  return c.used;
}
#endif

size_t carve_fwd16(float* base, int BC, int T, int F, SeqBufs16* b) {
  const size_t R = (size_t)BC * T, rows = (size_t)BC * H;
  Carve c{base};
  *b = SeqBufs16{};
  b->qkv = c.take16(R * 3 * D);
  b->mqkv = c.take16(R * 3 * D);
  for (bf16** p : {&b->gated, &b->x1lo, &b->attn, &b->x2lo}) *p = c.take16(R * D);
  for (float** p : {&b->g, &b->oh, &b->br, &b->x1, &b->x2}) *p = c.take(R * D);
  b->hpre = c.take(R * F);
  b->hdrop = c.take16(R * F);
  b->zkv = c.take(rows * DK * DK);
  b->kvf = c.take(rows * DK * DK);
  b->ones = c.take(rows);
  b->sf = c.take(rows);
  b->part = c.take(tc::kSplitFloats);
  return c.used;
}
#else
using E = float;

size_t carve_fwd(float* base, int BC, int T, int F, SeqBufs* b) {
  const size_t R = (size_t)BC * T, rows = (size_t)BC * H;
  Carve c{base};
  *b = SeqBufs{};
  b->qkvg = c.take(R * 4 * D);
  for (float** p : {&b->oh, &b->gated, &b->a, &b->x1}) *p = c.take(R * D);
  b->qkv = c.take(R * 3 * D);
  for (float** p : {&b->attn, &b->s, &b->x2}) *p = c.take(R * D);
  b->hpre = b->hdrop = c.take(R * F);  // relu and dropout in place
  b->f = c.take(R * D);
  b->zkv = c.take(rows * DK * DK);
  b->kvf = c.take(rows * DK * DK);
  b->ones = c.take(rows);
  b->sf = c.take(rows);
  b->part = c.take(tc::kSplitFloats);  // a product's partial sums along k
  return c.used;
}
#endif

}  // namespace

// floats of workspace dtf_forward needs for BC = B*C sequences of T frames
extern "C" size_t dtf_fwd_workspace(int BC, int T, int H_, int F) {
#ifdef FS_BF16
#ifdef DTF_TC16
  if (tc16_width(F)) {
    t16::Bufs16 b;
    bf16* wt[6];
    return H_ == H ? carve_fwd_tc16(nullptr, BC, T, F, &b, wt) : 0;
  }
#endif
  SeqBufs16 b;
  return H_ == H ? carve_fwd16(nullptr, BC, T, F, &b) : 0;
#else
  SeqBufs b;
  return H_ == H ? carve_fwd(nullptr, BC, T, F, &b) : 0;
#endif
}

// x, y (B, C, T, D); t* the transposes (in, out) of wqkvg, wro, wmi, wmo,
// wf1, wf2 and b* their biases; lns, lnb (3, D); kvs (B, T/L, H, C, DK, DK)
// and ss (B, T/L, H, C), both null for no checkpoints (not on the bf16
// production-width path, whose chunks read their states there); ws of
// dtf_fwd_workspace floats.  x, y and the weights of the element type E
// (bf16 with FS_BF16, else float); kvs, ss and ws float32.  T % L == 0, F %
// 16 == 0.  Returns the first CUDA error of the launches.
extern "C" int dtf_forward(const E* x, const E* tqkvg, const E* bqkvg, const E* tro,
                           const E* bro, const E* tmi, const E* bmi, const E* tmo, const E* bmo,
                           const E* tf1, const E* bf1, const E* tf2, const E* bf2, const E* lns,
                           const E* lnb, E* y, float* kvs, float* ss, float* ws, int B, int C,
                           int T, int L, int F, unsigned seed, unsigned thr, float mult,
                           void* stream_) {
#ifdef FS_BF16
#ifdef DTF_TC16
  if (tc16_width(F)) {
    if (!kvs || !ss) return cudaErrorInvalidValue;  // the chunks read their states there
    cudaStream_t st = static_cast<cudaStream_t>(stream_);
    t16::Bufs16 b;
    bf16* wt[6];
    carve_fwd_tc16(ws, B * C, T, F, &b, wt);
    b.y = y;
    b.kvs = kvs;
    b.ss = ss;
    // the products read W^T, (out, in): the six weights transposed once a call
    const E* t[6] = {tqkvg, tro, tmi, tmo, tf1, tf2};
    const int K[6] = {D, D, D, D, D, F}, N[6] = {4 * D, D, 3 * D, D, F, D};
    for (int i = 0; i < 6; ++i)
      if (int err = d16::transpose16(t[i], wt[i], 1, K[i], N[i], st)) return err;
    const t16::W16 w{wt[0], bqkvg, wt[1], bro, wt[2], bmi, wt[3], bmo, wt[4], bf1, wt[5], bf2,
                     lns, lnb};
    return t16::forward_tc16(x, w, b, B, C, T, L, F, Drop{seed, thr, mult, C, T, L}, true, st);
  }
#endif
  SeqBufs16 b;
  carve_fwd16(ws, B * C, T, F, &b);
  b.y = y;
  b.kvs = kvs;
  b.ss = ss;
  const SeqWeights16 w{tqkvg, bqkvg, tro, bro, tmi, bmi, tmo, bmo, tf1, bf1, tf2, bf2, lns, lnb};
  return forward_seq16(x, w, b, B, C, T, L, F, Drop{seed, thr, mult, C, T, L},
                       static_cast<cudaStream_t>(stream_));
#else
  SeqBufs b;
  carve_fwd(ws, B * C, T, F, &b);
  b.y = y;
  b.kvs = kvs;
  b.ss = ss;
  const SeqWeights w{tqkvg, bqkvg, tro, bro, tmi, bmi, tmo, bmo, tf1, bf1, tf2, bf2, lns, lnb};
  return forward_seq(x, w, b, B, C, T, L, F, Drop{seed, thr, mult, C, T, L},
                     static_cast<cudaStream_t>(stream_));
#endif
}
