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
#include "dec_train_fusion_seq.cuh"

using namespace dtf;

namespace {

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

}  // namespace

// floats of workspace dtf_forward needs for BC = B*C sequences of T frames
extern "C" size_t dtf_fwd_workspace(int BC, int T, int H_, int F) {
  SeqBufs b;
  return H_ == H ? carve_fwd(nullptr, BC, T, F, &b) : 0;
}

// x, y (B, C, T, D); t* the transposes (in, out) of wqkvg, wro, wmi, wmo,
// wf1, wf2 and b* their biases; lns, lnb (3, D); kvs (B, T/L, H, C, DK, DK)
// and ss (B, T/L, H, C), both null for no checkpoints; ws of
// dtf_fwd_workspace floats.  T % L == 0, F % 16 == 0.  Returns the first
// CUDA error of the launches.
extern "C" int dtf_forward(const float* x, const float* tqkvg, const float* bqkvg,
                           const float* tro, const float* bro, const float* tmi,
                           const float* bmi, const float* tmo, const float* bmo,
                           const float* tf1, const float* bf1, const float* tf2,
                           const float* bf2, const float* lns, const float* lnb, float* y,
                           float* kvs, float* ss, float* ws, int B, int C, int T, int L, int F,
                           unsigned seed, unsigned thr, float mult, void* stream_) {
  SeqBufs b;
  carve_fwd(ws, B * C, T, F, &b);
  b.y = y;
  b.kvs = kvs;
  b.ss = ss;
  const SeqWeights w{tqkvg, bqkvg, tro, bro, tmi, bmi, tmo, bmo, tf1, bf1, tf2, bf2, lns, lnb};
  return forward_seq(x, w, b, B, C, T, L, F, Drop{seed, thr, mult, C, T, L},
                     static_cast<cudaStream_t>(stream_));
}
