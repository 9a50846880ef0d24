// Frame scan of the LS-EEND attractor decoder on Hopper, float32, computed
// layer by layer over the whole K-frame block.
//
// Replaces the TPU kernel fseend_tpu/kernels/dec_frame_scan_pallas.py
// (dec_frame_scan, its _kernel): one call runs K frames of every lane
// through all L fusion layers.  Per frame and slot: a gamma = 1 recurrent
// retention step (output from the would-be-updated state, carry gated by
// the lane's `valid`) -> group norm and silu gate -> out projection, add,
// LN -> attention across the C slots of the lane -> out projection, add,
// LN -> relu FFN, add, LN; then the l2-normed attractor times the l2-normed
// embedding gives the slot's logit.
//
// What bounds it on the card: operations.  About 67 MFLOP per lane-frame at
// the production config (D 256, F 2048, L 2, C 10), 1.1 TFLOP per block of
// 128 lanes x 128 frames: 16.4 ms of the FMA pipe, about 6.7 ms of the
// tensor cores at three TF32 passes (tc_f32.cuh).  The TPU kernel's point
// was holding the whole decoder state (84 MB in bf16) in VMEM across the
// block; at 128 lanes in float32 it is 168 MB, more than Hopper's 50 MB L2.
//
// The key fact: inside the decoder the only dependence between frames is
// the time-retention carry.  Each frame's input is embp[b, k] + pe[c]; the
// slot attention, the FFN and the norms work within one frame.  So the block
// is computed layer-major over the rows r = (b*C + c)*Kc + k (slot-major, as
// the training fusion layer's grid): every linear layer is one matrix
// product over B*C*Kc rows, reading its weights once per slice of frames,
// and the retention state is read and written once per layer and slice.  The
// recurrence stays exact (ret_block_kernel, frame_ret.cuh, with g_j =
// valid[b, j]): the arithmetic of the plain version and the TPU kernel's
// identity, not the renormalized chunkwise form.
//
// One call is this sequence of kernels on the caller's stream around one
// workspace (frames in slices of at most kSlice that carry the state, so
// the workspace stays B*C*kSlice rows whatever K is):
//   s0_kernel          the incoming s of head 0 of every (layer, lane, slot)
//   x0_kernel          x = embp[b, k] + pe[c]
//   per layer:
//     tc::linear       qkvg = x W_qkvg + b (k columns scaled by dk^-1/2)
//     ret_block_kernel the exact recurrence above, 64 frames per chunk
//     gate_fwd         silu(g) * groupnorm(out) (eps 1e-6)
//     tc::linear, add_drop_ln    out projection, add, LN
//     tc::linear, slot_attn      q | k | v, attention across the C slots
//     tc::linear, add_drop_ln    out projection, add, LN
//     tc::linear x 2, add_drop_ln   relu FFN, add, LN
//   logits_kernel      l2norm(x) . embn
// The row kernels are the training fusion layer's (dec_train_fusion_common
// .cuh) at dropout 0: their mask multiplier is exactly 1.
//
// The bf16 form (built with FS_BF16; the float32 build is the code above
// unchanged): the weights, embp, embn, pe, the activations between layers
// and the stored state (kv, s) are bf16; every product is one bf16
// tensor-core pass with float32 accumulation (tc_bf16.cuh); the norms, the
// softmax, the gate and the recurrence run in float32.  The data is rounded
// to bf16 where the TPU kernel rounds it (dec_frame_scan_pallas.py:111,
// 125, 132, 135, 138, 152, 157, 160, 163, 166): x = embp + pe, q | k | v |
// g, the group norm's output and the gated value, each LN's output, the
// slot attention's q | k | v, its products q k and p v and probabilities
// and its output, the FFN's hidden layer; the out projections' and the
// FFN's second product stay float32 into the residual add.  The state is
// carried in float32 within a call (frame_ret.cuh).  The logits are float32.
// Bound: 1.1 TFLOP a block at 128 lanes x 128 frames, 1.1 ms of the bf16
// tensor cores.  At D = 256 over a block of at least kFusedRows rows the
// bf16 form runs dec_scan16.cuh's layer instead (its products on wgmma with
// the residual add and LayerNorm in their epilogues, the FFN pair fused,
// the recurrence on the tensor cores with the group norm and gate in its
// epilogue, the slot attention without bank conflicts); a step() (B*C rows)
// and other widths keep the sequence above, whose products split along k
// when they have few rows.
#include "frame_ret.cuh"
#include "tc_f32.cuh"
#ifdef FS_BF16
#include "dec_scan16.cuh"
#include "tc_bf16.cuh"
using T = fs::bf16;
#else
using T = float;
#endif

using namespace dtf;
using namespace frs;

namespace {

struct DecWeights {
  // stacked over layers, (in, out) layouts:
  const T *wqkvg, *bqkvg, *wro, *bro;  // (L, D, 4D), (L, 4D), (L, D, D), (L, D)
  const T *wmi, *bmi, *wmo, *bmo;      // (L, D, 3D), (L, 3D), (L, D, D), (L, D)
  const T *wf1, *bf1, *wf2, *bf2;      // (L, D, F), (L, F), (L, F, D), (L, D)
  const T *lns, *lnb;                  // (L, 3, D): norm11, norm21, norm22
};
constexpr int kNumWeights = 14;
#ifdef FS_BF16
constexpr long long kFusedRows = 2048;
#endif

// x[(bc*Kc + k)*D + d] = embp[(b*Kt + k0 + k)*D + d] + pe[c*D + d]
__global__ void x0_kernel(const T* __restrict__ embp, const T* __restrict__ pe,
                          T* __restrict__ x, int C, int Kc, int Kt, int k0, long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (D / 4);
    const int d = (int)(i % (D / 4)) * 4;
    const int bc = (int)(r / Kc), k = (int)(r % Kc), b = bc / C, c = bc % C;
    const float4 e = fs::load4(embp + ((size_t)b * Kt + k0 + k) * D + d);
    const float4 p = fs::load4(pe + (size_t)c * D + d);
    fs::store4(x + r * D + d, make_float4(e.x + p.x, e.y + p.y, e.z + p.z, e.w + p.w));
  }
}

// logits[(b*Kt + k0 + k)*C + c] = (x_r / |x_r|) . embn[b, k0 + k], one warp per row
__global__ void __launch_bounds__(256)
logits_kernel(const T* __restrict__ x, const T* __restrict__ embn,
              float* __restrict__ logits, int C, int Kc, int Kt, int k0, long long R) {
  DTF_FOR_ROWS(r, R) {
    const int bc = (int)(r / Kc), k = (int)(r % Kc), b = bc / C, c = bc % C;
    const size_t f = (size_t)b * Kt + k0 + k;
    float v[NV], e[NV], sq[NV];
    load_row(x + r * D, v);
    load_row(embn + f * D, e);
#pragma unroll
    for (int i = 0; i < NV; ++i) sq[i] = v[i] * v[i], e[i] *= v[i];
    const float n2 = row_sum(sq), dot = row_sum(e);
    if (lane_id() == 0) logits[f * C + c] = dot * rsqrtf(n2);
  }
}

struct Bufs {
  float *x0, *x1, *t1, *t2, *big, *s0, *part;
  float* wt;  // the bf16 form's transposed weights (wg16_kernel's operands), or null
};

#ifdef FS_BF16
// dec_scan16.cuh's layer takes D = 256 and F a multiple of 64, and the
// weights transposed once a call
inline bool layer16(int F) { return D == 256 && F % d16::kFS == 0; }
// bf16 elements of one layer's transposed weights: qkvg, ro, mi, mo, f1, f2
inline size_t wt_layer(int F) { return (size_t)9 * D * D + 2 * (size_t)D * F; }
#endif

size_t carve(float* base, int B, int K, int C, int L, int F, Bufs* b) {
  const size_t R = (size_t)B * C * (K < kSlice ? K : kSlice);
  Carve c{base};
  b->x0 = c.take(R * D);
  b->x1 = c.take(R * D);
  b->t1 = c.take(R * D);
  b->t2 = c.take(R * D);
  b->big = c.take(R * (F > 4 * D ? F : 4 * D));
  b->s0 = c.take((size_t)L * B * C);
  b->part = c.take(tc::kSplitFloats);  // a product of few rows split along k
  b->wt = nullptr;
#ifdef FS_BF16
  if (layer16(F) && (long long)R >= kFusedRows) b->wt = c.take((L * wt_layer(F) + 1) / 2);
#endif
  return c.used;
}

}  // namespace

// floats of workspace dec_frame_scan_launch needs (0 for a width or head
// count this build does not take)
extern "C" size_t dec_frame_scan_workspace(int B, int K, int C, int L, int D_, int H_, int F) {
  Bufs b;
  return D_ == D && H_ == H ? carve(nullptr, B, K, C, L, F, &b) : 0;
}

// weights: kNumWeights device pointers in DecWeights order.  embp, embn (B,
// K, D); valid (B, K) float32; pe (C, D); logits (B, K, C) float32; kv (L,
// B*C, H, dv, dk) and s (L, B*C, H), updated in place; ws of
// dec_frame_scan_workspace floats.  D and H are this build's (DTF_D, DTF_D /
// CR_DK), the element type of the rest T (bf16 with FS_BF16, else float).
// Returns the first CUDA error of the launches.
extern "C" int dec_frame_scan_launch(const void* const* weights, const T* embp, const T* embn,
                                     const float* valid, const T* pe, float* logits, T* kv,
                                     T* s, float* ws, int B, int K, int C, int L, int F,
                                     void* stream) {
  static_assert(sizeof(DecWeights) == kNumWeights * sizeof(void*), "DecWeights");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DecWeights w;
  const T** dst = reinterpret_cast<const T**>(&w);
  for (int i = 0; i < kNumWeights; ++i) dst[i] = static_cast<const T*>(weights[i]);
  Bufs bf;
  carve(ws, B, K, C, L, F, &bf);
  const int BC = B * C;
#ifdef FS_BF16
  // the TPU kernel scales the bf16 k by dk^-1/2 in bf16
  const float kscale = __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt((double)DK))));
#else
  const float kscale = (float)(1.0 / sqrt((double)DK));
#endif
  const size_t kvl = (size_t)BC * H * DK * DK;  // one layer's state
  const size_t rsmem = sizeof(float) * ret_smem_floats();
  int err;
#define DFS_TRY(call) \
  if ((err = (call)) != 0) return err
  DFS_TRY(cudaFuncSetAttribute(ret_block_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rsmem));
#ifdef FS_BF16
  DFS_TRY(cudaFuncSetAttribute(d16::ret_tc_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d16::ret_tc_smem_bytes()));
#endif
  // the workspace's row buffers: x0, x1 and big hold T; t1 and t2 hold a
  // float32 product on its way into an add (a*) or T (h*)
  T *x0 = reinterpret_cast<T*>(bf.x0), *x1 = reinterpret_cast<T*>(bf.x1);
  T* big = reinterpret_cast<T*>(bf.big);
  float *at1 = bf.t1, *at2 = bf.t2;
  T *ht1 = reinterpret_cast<T*>(bf.t1), *ht2 = reinterpret_cast<T*>(bf.t2);
#ifdef FS_BF16
  // the transposed weights, one (L, N, K) block each: qkvg, ro, mi, mo, f1, f2
  T* wt[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (bf.wt) {
    const T* src[6] = {w.wqkvg, w.wro, w.wmi, w.wmo, w.wf1, w.wf2};
    const int kin[6] = {D, D, D, D, D, F}, nout[6] = {4 * D, D, 3 * D, D, F, D};
    T* p = reinterpret_cast<T*>(bf.wt);
    for (int i = 0; i < 6; ++i) {
      wt[i] = p;
      DFS_TRY(d16::transpose16(src[i], p, L, kin[i], nout[i], st));
      p += (size_t)L * kin[i] * nout[i];
    }
  }
  // layer l's slice of wt[i]
  auto wtl = [&](int i, int l, size_t per) -> const T* { return wt[i] + l * per; };
#endif
  for (int k0 = 0; k0 < K; k0 += kSlice) {
    const int Kc = K - k0 < kSlice ? K - k0 : kSlice;
    const long long R = (long long)BC * Kc;
    const Drop dp{0u, 0u, 1.f, C, Kc, Kc};  // no dropout: every multiplier is 1
    s0_kernel<T><<<(L * BC + 255) / 256, 256, 0, st>>>(s, bf.s0, L * BC);
    DFS_TRY(cudaGetLastError());
    const long long n4 = R * (D / 4);
    x0_kernel<<<(int)lmin((n4 + 255) / 256, 132 * 16), 256, 0, st>>>(embp, pe, x0, C, Kc, K, k0,
                                                                      n4);
    DFS_TRY(cudaGetLastError());
    T *x = x0, *y = x1;
#ifdef FS_BF16
    const bool fused = bf.wt && R >= kFusedRows;
    for (int l = 0; fused && l < L; ++l) {
      const T* lns = w.lns + (size_t)l * 3 * D;
      const T* lnb = w.lnb + (size_t)l * 3 * D;
      DFS_TRY(d16::linear16(x, wtl(0, l, (size_t)D * 4 * D), w.bqkvg + (size_t)l * 4 * D, big,
                            (int)R, 4 * D, st, D, 2 * D, kscale));
      d16::ret_tc_kernel<3><<<BC * H, 128, d16::ret_tc_smem_bytes(), st>>>(
          big, valid, ht1, kv + l * kvl, s + (size_t)l * BC * H, bf.s0 + l * BC, C, Kc, K, k0);
      DFS_TRY(cudaGetLastError());
      DFS_TRY(d16::linear16_ln(ht1, wtl(1, l, (size_t)D * D), w.bro + (size_t)l * D, x, lns, lnb,
                               y, (int)R, st));
      DFS_TRY(d16::linear16(y, wtl(2, l, (size_t)D * 3 * D), w.bmi + (size_t)l * 3 * D, big,
                            (int)R, 3 * D, st));
      DFS_TRY(d16::slot_attn16(big, ht2, B, Drop{0u, 0u, 1.f, C, Kc, Kc}, st));
      DFS_TRY(d16::linear16_ln(ht2, wtl(3, l, (size_t)D * D), w.bmo + (size_t)l * D, y, lns + D,
                               lnb + D, x, (int)R, st));
      DFS_TRY(d16::ffn16(x, wtl(4, l, (size_t)D * F), w.bf1 + (size_t)l * F,
                         wtl(5, l, (size_t)F * D), w.bf2 + (size_t)l * D, lns + 2 * D, lnb + 2 * D,
                         y, (int)R, F, st));
      T* tmp = x;
      x = y;
      y = tmp;
    }
    for (int l = 0; !fused && l < L; ++l) {
#else
    for (int l = 0; l < L; ++l) {
#endif
      const T* lns = w.lns + (size_t)l * 3 * D;
      const T* lnb = w.lnb + (size_t)l * 3 * D;
      DFS_TRY(tc::launch_linear(x, D, w.wqkvg + (size_t)l * D * 4 * D, 4 * D,
                                w.bqkvg + (size_t)l * 4 * D, big, 4 * D, (int)R, 4 * D, D, st, D,
                                2 * D, kscale, bf.part));
      ret_block_kernel<T><<<BC * H, 256, rsmem, st>>>(big, valid, at1, kv + l * kvl,
                                                      s + (size_t)l * BC * H, bf.s0 + l * BC, C,
                                                      Kc, K, k0);
      DFS_TRY(cudaGetLastError());
      DFS_TRY(gate_fwd(at1, big + 3 * D, 4 * D, ht2, R, st));
      DFS_TRY(tc::launch_linear(ht2, D, w.wro + (size_t)l * D * D, D, w.bro + (size_t)l * D, at1,
                                D, (int)R, D, D, st, 0, 0, 1.f, bf.part));
      DFS_TRY(add_drop_ln(x, at1, lns, lnb, nullptr, y, R, dp, kRet, st));
      DFS_TRY(tc::launch_linear(y, D, w.wmi + (size_t)l * D * 3 * D, 3 * D,
                                w.bmi + (size_t)l * 3 * D, big, 3 * D, (int)R, 3 * D, D, st, 0,
                                0, 1.f, bf.part));
      DFS_TRY(slot_attn(big, nullptr, ht1, B, dp, false, st));
      DFS_TRY(tc::launch_linear(ht1, D, w.wmo + (size_t)l * D * D, D, w.bmo + (size_t)l * D, at2,
                                D, (int)R, D, D, st, 0, 0, 1.f, bf.part));
      DFS_TRY(add_drop_ln(y, at2, lns + D, lnb + D, nullptr, x, R, dp, kMha, st));
      DFS_TRY(tc::launch_linear<tc::kRelu>(x, D, w.wf1 + (size_t)l * D * F, F,
                                           w.bf1 + (size_t)l * F, big, F, (int)R, F, D, st, 0, 0,
                                           1.f, bf.part));
      DFS_TRY(tc::launch_linear(big, F, w.wf2 + (size_t)l * F * D, D, w.bf2 + (size_t)l * D, at1,
                                D, (int)R, D, F, st, 0, 0, 1.f, bf.part));
      DFS_TRY(add_drop_ln(x, at1, lns + 2 * D, lnb + 2 * D, nullptr, y, R, dp, kFfo, st));
      T* tmp = x;
      x = y;
      y = tmp;
    }
    logits_kernel<<<row_grid(R), 256, 0, st>>>(x, embn, logits, C, Kc, K, k0, R);
    DFS_TRY(cudaGetLastError());
  }
#undef DFS_TRY
  return 0;
}
