// One decoder fusion layer in training semantics, backward, on Hopper,
// float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/dec_train_fusion_pallas.py
// (_bwd_call and its _bwd_kernel): from x, dy, the per-chunk state
// checkpoints (kvs, ss) and the dropout seed, dx and the 14 weight
// gradients of the layer that dtf_forward computes.
//
// What bounds it on the card: operations, about three times the forward's:
// the forward is recomputed once, and every product of the backward is two
// (the input gradient and the weight gradient).
//
// The TPU kernel recomputes each chunk's forward in VMEM inside its reverse
// sweep.  Here the recompute runs first, over the whole layer, with the
// forward's kernels into a workspace (x, dy and the checkpoints are all the
// backward reads from the forward, as in the JAX contract), and the
// backward then runs layer-wide, in reverse:
//   ln_bwd (LN3) -> wgrad, colsum, linear (FFN out) -> relu_drop (the same
//   kernel: mask * relu') -> wgrad, colsum, linear accumulated (FFN in) ->
//   ln_bwd (LN2) -> ... slot_attn backward ... -> ln_bwd (LN1) -> out
//   projection -> gate_bwd -> core_bwd_kernel -> the q | k | v | g products.
// Weight gradients are G += A^T X over all B*C*T rows (lin::wgrad_kernel,
// row slices added with atomics), so their last bits vary from run to run.
//
// core_bwd_kernel is the retention core's backward: one block per (b, c,
// head), the chunks in reverse, carrying dS, the cotangent of the state
// after the chunk, in shared memory (zero after the last chunk).  Chunk n's
// k and v gradients take dS_n alone; the chunk's cross read adds
// qid^T (doh / all) to make dS_{n-1}.  The row sums, the incoming scale and
// their max are constants (the reference detaches them).  The masked
// L x L products of the chunk (S = mask * Q K^T and its gradient) go to a
// per-block scratch in device memory (L2 at L = 128), and each gradient
// element is one thread's complete sum, so no element is added to twice.
#include "dec_train_fusion_common.cuh"

using namespace dtf;

namespace {

struct CoreBwdArgs {
  const float *q, *k, *v;  // rows of stride ldq (the q | k | v columns of qkvg)
  int ldq;
  float* p;  // doh in (stride ldp), doh / all out
  int ldp;
  float *dq, *dk, *dv;  // stride ldq
  const float *kvs, *ss;
  float* scratch;  // 2 L L floats per block
  int C, T, L;
  float kscale;
};

template <int DK_>
__global__ void __launch_bounds__(256) core_bwd_kernel(CoreBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* dS = sm;             // (DK, DK) the state cotangent
  float* KV = dS + DK_ * DK_;  // (DK, DK) the state the chunk read
  float* all = KV + DK_ * DK_;  // (L)
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int T = a.T, L = a.L, N = T / L, ld = a.ldq;
  float* S = a.scratch + (size_t)bh * 2 * L * L;
  float* Dm = S + (size_t)L * L;
  const float sqL = sqrtf((float)L), wlast = (float)(1.0 / sqrt((double)L));

  for (int i = tid; i < DK_ * DK_; i += nt) dS[i] = 0.f;
  for (int n = N - 1; n >= 0; --n) {
    const size_t row0 = (size_t)b * T + (size_t)n * L;
    const float* q = a.q + row0 * ld + h * DK_;
    const float* k = a.k + row0 * ld + h * DK_;
    const float* v = a.v + row0 * ld + h * DK_;
    float* P = a.p + row0 * a.ldp + h * DK_;
    float* dq = a.dq + row0 * ld + h * DK_;
    float* dk = a.dk + row0 * ld + h * DK_;
    float* dv = a.dv + row0 * ld + h * DK_;
    const size_t slot = (((size_t)(b / a.C) * N + n) * H + h) * a.C + b % a.C;
    __syncthreads();  // the last chunk is done with KV, all and the scratch
    for (int i = tid; i < DK_ * DK_; i += nt) KV[i] = a.kvs[slot * DK_ * DK_ + i];
    const float s_in = a.ss[slot];
    // S = mask * Q K^T
    for (int e = tid; e < L * L; e += nt) {
      const int i = e / L, j = e % L;
      float acc = 0.f;
      if (j <= i) {
        for (int c = 0; c < DK_; ++c) acc = fmaf(q[(size_t)i * ld + c], k[(size_t)j * ld + c], acc);
        acc *= 1.f / sqrtf(i + 1.f);
      }
      S[e] = acc;
    }
    __syncthreads();
    for (int i = tid; i < L; i += nt) {
      float r = 0.f;
      for (int j = 0; j <= i; ++j) r += fabsf(S[(size_t)i * L + j]);
      all[i] = fmaxf(fmaxf(r, 1.f), s_in);
    }
    __syncthreads();
    for (int e = tid; e < L * DK_; e += nt) P[(size_t)(e / DK_) * a.ldp + e % DK_] /= all[e / DK_];
    __syncthreads();
    // Dm = mask * P V^T
    for (int e = tid; e < L * L; e += nt) {
      const int i = e / L, j = e % L;
      float acc = 0.f;
      if (j <= i) {
        for (int c = 0; c < DK_; ++c) acc = fmaf(P[(size_t)i * a.ldp + c], v[(size_t)j * ld + c], acc);
        acc *= 1.f / sqrtf(i + 1.f);
      }
      Dm[e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < L * DK_; e += nt) {
      const int i = e / DK_, c = e % DK_;
      // dq: the inner path, then the cross read of the incoming state
      float g = 0.f, cr = 0.f;
      for (int j = 0; j <= i; ++j) g = fmaf(Dm[(size_t)i * L + j], k[(size_t)j * ld + c], g);
      for (int u = 0; u < DK_; ++u) cr = fmaf(P[(size_t)i * a.ldp + u], KV[c * DK_ + u], cr);
      dq[(size_t)i * ld + c] = g + cr * (sqL / sqrtf(i + 1.f));
      // dk (frame j = i) and dv: the inner path, then the state update's
      float gk = 0.f, gv = 0.f, sk = 0.f, sv = 0.f;
      for (int r = i; r < L; ++r) {
        gk = fmaf(Dm[(size_t)r * L + i], q[(size_t)r * ld + c], gk);
        gv = fmaf(S[(size_t)r * L + i], P[(size_t)r * a.ldp + c], gv);
      }
      for (int u = 0; u < DK_; ++u) {
        sk = fmaf(v[(size_t)i * ld + u], dS[c * DK_ + u], sk);
        sv = fmaf(k[(size_t)i * ld + u], dS[u * DK_ + c], sv);
      }
      dk[(size_t)i * ld + c] = (gk + sk * wlast) * a.kscale;
      dv[(size_t)i * ld + c] = gv + sv * wlast;
    }
    __syncthreads();  // every read of dS_n is done
    for (int e = tid; e < DK_ * DK_; e += nt) {
      const int c = e / DK_, u = e % DK_;
      float acc = 0.f;
      for (int i = 0; i < L; ++i)
        acc = fmaf(q[(size_t)i * ld + c] * (sqL / sqrtf(i + 1.f)), P[(size_t)i * a.ldp + u], acc);
      dS[e] += acc;
    }
  }
}

struct BwdBufs {
  float *qkvg, *oh, *gated, *a, *r1, *x1, *qkv, *attn, *s, *r2, *x2, *hpre, *hdrop, *f, *r3;
  float *g2, *gF, *dqkv, *dqkvg, *doh, *scratch;
  float *zkv, *ones, *kvf, *sf;
};

size_t carve_bwd(float* base, int BC, int T, int L, int F, BwdBufs* b) {
  const size_t R = (size_t)BC * T, rows = (size_t)BC * H;
  Carve c{base};
  b->qkvg = c.take(R * 4 * D);
  for (float** p : {&b->oh, &b->gated, &b->a, &b->r1, &b->x1}) *p = c.take(R * D);
  b->qkv = c.take(R * 3 * D);
  for (float** p : {&b->attn, &b->s, &b->r2, &b->x2}) *p = c.take(R * D);
  b->hpre = c.take(R * F);
  b->hdrop = c.take(R * F);
  for (float** p : {&b->f, &b->r3, &b->g2, &b->doh}) *p = c.take(R * D);
  b->gF = c.take(R * F);
  b->dqkv = c.take(R * 3 * D);
  b->dqkvg = c.take(R * 4 * D);
  b->scratch = c.take(rows * 2 * L * L);
  b->zkv = c.take(rows * DK * DK);
  b->kvf = c.take(rows * DK * DK);
  b->ones = c.take(rows);
  b->sf = c.take(rows);
  return c.used;
}

}  // namespace

// floats of workspace dtf_backward needs
extern "C" size_t dtf_bwd_workspace(int BC, int T, int L, int H_, int F) {
  BwdBufs b;
  return H_ == H ? carve_bwd(nullptr, BC, T, L, F, &b) : 0;
}

// x, dy, dx (B, C, T, D); kvs, ss as dtf_forward writes them; w* the 14
// weights and t* the transposes (in, out) of wqkvg, wro, wmi, wmo, wf1, wf2;
// g* the 14 gradients, zero on entry, in the weights' layouts.  Returns the
// first CUDA error of the launches.
extern "C" int dtf_backward(const float* x, const float* dy, const float* kvs, const float* ss,
                            const float* wqkvg, const float* bqkvg, const float* wro,
                            const float* bro, const float* wmi, const float* bmi,
                            const float* wmo, const float* bmo, const float* wf1,
                            const float* bf1, const float* wf2, const float* bf2,
                            const float* lns, const float* lnb, const float* tqkvg,
                            const float* tro, const float* tmi, const float* tmo,
                            const float* tf1, const float* tf2, float* dx, float* gqkvg,
                            float* gbqkvg, float* gro, float* gbro, float* gmi, float* gbmi,
                            float* gmo, float* gbmo, float* gf1, float* gbf1, float* gf2,
                            float* gbf2, float* glns, float* glnb, float* ws, int B, int C,
                            int T, int L, int F, unsigned seed, unsigned thr, float mult,
                            void* stream_) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const int BC = B * C, R = BC * T;
  const Drop dp{seed, thr, mult, C, T, L};
  const float kscale = (float)(1.0 / sqrt((double)DK));
  BwdBufs b;
  carve_bwd(ws, BC, T, L, F, &b);
  int err;
#define DTF_TRY(call) \
  if ((err = (call)) != 0) return err
  // ---- recompute the forward ----
  DTF_TRY(lin::launch_linear(x, D, wqkvg, bqkvg, b.qkvg, 4 * D, R, 4 * D, D, st, D, 2 * D, kscale));
  DTF_TRY(retention_fwd(b.qkvg, b.oh, b.zkv, b.ones, b.kvf, b.sf, nullptr, nullptr, BC, T, L, C,
                        st));
  DTF_TRY(gate_fwd(b.oh, b.qkvg + 3 * D, 4 * D, b.gated, R, st));
  DTF_TRY(lin::launch_linear(b.gated, D, wro, bro, b.a, D, R, D, D, st));
  DTF_TRY(add_drop_ln(x, b.a, lns, lnb, b.r1, b.x1, R, dp, kRet, st));
  DTF_TRY(lin::launch_linear(b.x1, D, wmi, bmi, b.qkv, 3 * D, R, 3 * D, D, st));
  DTF_TRY(slot_attn(b.qkv, nullptr, b.attn, B, dp, false, st));
  DTF_TRY(lin::launch_linear(b.attn, D, wmo, bmo, b.s, D, R, D, D, st));
  DTF_TRY(add_drop_ln(b.x1, b.s, lns + D, lnb + D, b.r2, b.x2, R, dp, kMha, st));
  DTF_TRY(lin::launch_linear(b.x2, D, wf1, bf1, b.hpre, F, R, F, D, st));
  DTF_TRY(relu_drop(b.hpre, b.hpre, b.hdrop, R, F, dp, st));
  DTF_TRY(lin::launch_linear(b.hdrop, F, wf2, bf2, b.f, D, R, D, F, st));
  DTF_TRY(add_drop_ln(b.x2, b.f, lns + 2 * D, lnb + 2 * D, b.r3, nullptr, R, dp, kFfo, st));
  // ---- backward; dx carries the residual stream's gradient ----
  // LN3 and the FFN
  DTF_TRY(ln_bwd(dy, b.r3, lns + 2 * D, dx, b.g2, glns + 2 * D, glnb + 2 * D, R, dp, kFfo, st));
  DTF_TRY(lin::launch_wgrad(b.g2, D, b.hdrop, F, gf2, R, D, F, st));
  DTF_TRY(lin::launch_colsum(b.g2, D, gbf2, R, D, st));
  DTF_TRY(lin::launch_linear(b.g2, D, tf2, nullptr, b.gF, F, R, F, D, st));
  DTF_TRY(relu_drop(b.gF, b.hpre, b.gF, R, F, dp, st));
  DTF_TRY(lin::launch_wgrad(b.gF, F, b.x2, D, gf1, R, F, D, st));
  DTF_TRY(lin::launch_colsum(b.gF, F, gbf1, R, F, st));
  DTF_TRY(lin::launch_linear<true>(b.gF, F, tf1, nullptr, dx, D, R, D, F, st));
  // LN2 and the slot attention
  DTF_TRY(ln_bwd(dx, b.r2, lns + D, dx, b.g2, glns + D, glnb + D, R, dp, kMha, st));
  DTF_TRY(lin::launch_wgrad(b.g2, D, b.attn, D, gmo, R, D, D, st));
  DTF_TRY(lin::launch_colsum(b.g2, D, gbmo, R, D, st));
  DTF_TRY(lin::launch_linear(b.g2, D, tmo, nullptr, b.a, D, R, D, D, st));
  DTF_TRY(slot_attn(b.qkv, b.a, b.dqkv, B, dp, true, st));
  DTF_TRY(lin::launch_wgrad(b.dqkv, 3 * D, b.x1, D, gmi, R, 3 * D, D, st));
  DTF_TRY(lin::launch_colsum(b.dqkv, 3 * D, gbmi, R, 3 * D, st));
  DTF_TRY(lin::launch_linear<true>(b.dqkv, 3 * D, tmi, nullptr, dx, D, R, D, 3 * D, st));
  // LN1, the out projection and the gate
  DTF_TRY(ln_bwd(dx, b.r1, lns, dx, b.g2, glns, glnb, R, dp, kRet, st));
  DTF_TRY(lin::launch_wgrad(b.g2, D, b.gated, D, gro, R, D, D, st));
  DTF_TRY(lin::launch_colsum(b.g2, D, gbro, R, D, st));
  DTF_TRY(lin::launch_linear(b.g2, D, tro, nullptr, b.a, D, R, D, D, st));
  DTF_TRY(gate_bwd(b.a, b.oh, b.qkvg + 3 * D, 4 * D, b.dqkvg + 3 * D, 4 * D, b.doh, R, st));
  // the retention core, then its projections
  CoreBwdArgs ca{b.qkvg, b.qkvg + D, b.qkvg + 2 * D, 4 * D, b.doh, D,
                 b.dqkvg, b.dqkvg + D, b.dqkvg + 2 * D, kvs, ss, b.scratch, C, T, L, kscale};
  const int smem = (int)sizeof(float) * (2 * DK * DK + L);
  cudaError_t e = cudaFuncSetAttribute(core_bwd_kernel<DK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  core_bwd_kernel<DK><<<BC * H, 256, smem, st>>>(ca);
  DTF_TRY(cudaGetLastError());
  DTF_TRY(lin::launch_wgrad(b.dqkvg, 4 * D, x, D, gqkvg, R, 4 * D, D, st));
  DTF_TRY(lin::launch_colsum(b.dqkvg, 4 * D, gbqkvg, R, 4 * D, st));
  DTF_TRY(lin::launch_linear<true>(b.dqkvg, 4 * D, tqkvg, nullptr, dx, D, R, D, 4 * D, st));
#undef DTF_TRY
  return 0;
}
