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
// recurrence stays exact (ret_block_kernel): for each (b, c, head), with
// g_j = valid[b, j], the state read as KV0 = kv * sqrt(s0) and k~ = k dk^-1/2,
//   out_k = (q_k KV0 + sum_{j<k} g_j (q_k . k~_j) v_j + (q_k . k~_k) v_k)
//           * rsqrt(s0 + sum_{j<k} g_j + 1)
//   KV    = KV0 + sum_j g_j v_j k~_j^T,   s = s0 + sum_j g_j,
// written back as kv = KV * rsqrt(max(s, 1)): the arithmetic of the plain
// version and the TPU kernel's identity, not the renormalized chunkwise form.
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
#include "dec_train_fusion_common.cuh"
#include "tc_f32.cuh"

using namespace dtf;

namespace {

constexpr int kSlice = 128;  // frames per slice of the block
constexpr int kT = 64;       // frames per retention chunk

struct DecWeights {
  // stacked over layers, (in, out) layouts:
  const float *wqkvg, *bqkvg, *wro, *bro;  // (L, D, 4D), (L, 4D), (L, D, D), (L, D)
  const float *wmi, *bmi, *wmo, *bmo;      // (L, D, 3D), (L, 3D), (L, D, D), (L, D)
  const float *wf1, *bf1, *wf2, *bf2;      // (L, D, F), (L, F), (L, F, D), (L, D)
  const float *lns, *lnb;                  // (L, 3, D): norm11, norm21, norm22
};
constexpr int kNumWeights = 14;

// s0[l*BC + bc] = s[(l*BC + bc)*H]: every head of a (layer, lane, slot)
// reads head 0's count, as the plain version does
__global__ void s0_kernel(const float* __restrict__ s, float* __restrict__ s0, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    s0[i] = s[(size_t)i * H];
}

// x[(bc*Kc + k)*D + d] = embp[(b*Kt + k0 + k)*D + d] + pe[c*D + d]
__global__ void x0_kernel(const float* __restrict__ embp, const float* __restrict__ pe,
                          float* __restrict__ x, int C, int Kc, int Kt, int k0, long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (D / 4);
    const int d = (int)(i % (D / 4)) * 4;
    const int bc = (int)(r / Kc), k = (int)(r % Kc), b = bc / C, c = bc % C;
    const float4 e = *reinterpret_cast<const float4*>(embp + ((size_t)b * Kt + k0 + k) * D + d);
    const float4 p = *reinterpret_cast<const float4*>(pe + (size_t)c * D + d);
    *reinterpret_cast<float4*>(x + r * D + d) =
        make_float4(e.x + p.x, e.y + p.y, e.z + p.z, e.w + p.w);
  }
}

// The exact gamma = 1 recurrence of one layer for one (b, c, head) per block,
// over the Kc frames of the slice in chunks of kT, on the FMA pipe: for a
// chunk, S = (Q K~^T) masked to (j < i: g_j, j == i: 1, j > i: 0), out =
// (Q KV^T + S V) * rsqrt(s + prefix + 1), then KV += (g V)^T K~.  KV (dv x
// dk, [v][k]) stays in shared memory for the slice.  256 threads as 16 x 16:
// thread (ty, tx) owns rows ty + 16a and columns tx + 16c of every tile, so
// that a warp reads neighbouring shared-memory words; tile rows are padded
// by one word.  A chunk of nr < kT frames (K = 1 for step()) computes only
// its ceil(nr / 16) groups of 16 rows.
constexpr int kLdh = DK + 1;  // row stride of the q, k~ and state tiles
constexpr int kLds = kT + 1;  // row stride of the S tile
constexpr int CV = DK / 16;   // head columns per thread
static_assert(DK % 16 == 0, "head dim a multiple of 16");

constexpr int ret_smem_floats() {
  return 2 * kT * kLdh + kT * kLds + kT * DK + DK * kLdh + 2 * kT;
}

struct RetTiles {
  float *Qs, *Ks, *Ss, *Vs, *KV, *gs, *ns;
};

// the chunk's out rows (RA groups of 16 rows are live): S, then Q KV^T + S V,
// scaled by ns; returns with Ss complete and every read of KV done (after
// the block-wide barrier inside)
template <int RA>
__device__ __forceinline__ void ret_chunk_out(const RetTiles& t, int nr, float* oh_rows,
                                              int tx, int ty) {
  float sv[RA][RA];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RA; ++c) sv[a][c] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < DK; ++kk) {
    float qa[RA], kb[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) qa[a] = t.Qs[(ty + 16 * a) * kLdh + kk];
#pragma unroll
    for (int c = 0; c < RA; ++c) kb[c] = t.Ks[(tx + 16 * c) * kLdh + kk];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c) sv[a][c] = fmaf(qa[a], kb[c], sv[a][c]);
  }
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RA; ++c) {
      const int i = ty + 16 * a, j = tx + 16 * c;
      const float m = j < i ? t.gs[j] : (j == i ? 1.f : 0.f);
      t.Ss[i * kLds + j] = sv[a][c] * m;
    }
  // the carried state's read: Q KV^T, rows i, value columns v = tx + 16c
  float acc[RA][CV];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < DK; ++kk) {
    float qa[RA], kb[CV];
#pragma unroll
    for (int a = 0; a < RA; ++a) qa[a] = t.Qs[(ty + 16 * a) * kLdh + kk];
#pragma unroll
    for (int c = 0; c < CV; ++c) kb[c] = t.KV[(tx + 16 * c) * kLdh + kk];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[a][c] = fmaf(qa[a], kb[c], acc[a][c]);
  }
  __syncthreads();  // Ss and ns are complete; nothing reads KV again in this chunk
  // the intra-chunk part: S V over the live frames
#pragma unroll 4
  for (int j = 0; j < nr; ++j) {
    float sa[RA], vb[CV];
#pragma unroll
    for (int a = 0; a < RA; ++a) sa[a] = t.Ss[(ty + 16 * a) * kLds + j];
#pragma unroll
    for (int c = 0; c < CV; ++c) vb[c] = t.Vs[j * DK + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[a][c] = fmaf(sa[a], vb[c], acc[a][c]);
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = ty + 16 * a;
    if (i >= nr) continue;
    float* o = oh_rows + (size_t)i * D;
#pragma unroll
    for (int c = 0; c < CV; ++c) o[tx + 16 * c] = acc[a][c] * t.ns[i];
  }
}

__global__ void __launch_bounds__(256)
ret_block_kernel(const float* __restrict__ qkvg, const float* __restrict__ valid,
                 float* __restrict__ oh, float* __restrict__ kv, float* __restrict__ s,
                 const float* __restrict__ s0, int C, int Kc, int Kt, int k0) {
  extern __shared__ __align__(16) float sm[];
  RetTiles t;
  t.Qs = sm;                      // (kT, kLdh)
  t.Ks = t.Qs + kT * kLdh;        // (kT, kLdh)  k~
  t.Ss = t.Ks + kT * kLdh;        // (kT, kLds)  masked q k~^T
  t.Vs = t.Ss + kT * kLds;        // (kT, DK)
  t.KV = t.Vs + kT * DK;          // (DK, kLdh)  [v][k]
  t.gs = t.KV + DK * kLdh;        // (kT)        gates of the chunk
  t.ns = t.gs + kT;               // (kT)        rsqrt(s + prefix + 1)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int seq = blockIdx.x, bc = seq / H, h = seq % H, b = bc / C;
  float srun = s0[bc];
  {
    const float sc = sqrtf(srun);
    const float* src = kv + (size_t)seq * DK * DK;
    for (int i = tid; i < DK * DK; i += 256) t.KV[(i / DK) * kLdh + i % DK] = src[i] * sc;
  }
  for (int n0 = 0; n0 < Kc; n0 += kT) {
    const int nr = min(kT, Kc - n0);
    const int live = (nr + 15) / 16 * 16;  // rows of the live row groups
    __syncthreads();  // the previous chunk is done with every tile
    const float* rows = qkvg + ((size_t)bc * Kc + n0) * 4 * D;
    for (int idx = tid; idx < live * (DK / 4); idx += 256) {
      const int i = idx / (DK / 4), c = (idx % (DK / 4)) * 4;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), kv4 = qv, vv = qv;
      if (i < nr) {
        const float* p = rows + (size_t)i * 4 * D + h * DK + c;
        qv = *reinterpret_cast<const float4*>(p);
        kv4 = *reinterpret_cast<const float4*>(p + D);
        vv = *reinterpret_cast<const float4*>(p + 2 * D);
      }
      float* q = t.Qs + i * kLdh + c;
      float* k = t.Ks + i * kLdh + c;
      q[0] = qv.x, q[1] = qv.y, q[2] = qv.z, q[3] = qv.w;
      k[0] = kv4.x, k[1] = kv4.y, k[2] = kv4.z, k[3] = kv4.w;
      *reinterpret_cast<float4*>(t.Vs + i * DK + c) = vv;
    }
    if (tid < kT) t.gs[tid] = tid < nr ? valid[(size_t)b * Kt + k0 + n0 + tid] : 0.f;
    __syncthreads();
    if (tid == 0) {  // the count each frame's output divides by, in frame order
      float run = srun;
      for (int i = 0; i < nr; ++i) {
        t.ns[i] = rsqrtf(run + 1.f);
        run += t.gs[i];
      }
    }
    float gsum = 0.f;
    for (int i = 0; i < nr; ++i) gsum += t.gs[i];
    float* oh_rows = oh + ((size_t)bc * Kc + n0) * D + h * DK;
    switch (live / 16) {
      case 1: ret_chunk_out<1>(t, nr, oh_rows, tx, ty); break;
      case 2: ret_chunk_out<2>(t, nr, oh_rows, tx, ty); break;
      case 3: ret_chunk_out<3>(t, nr, oh_rows, tx, ty); break;
      default: ret_chunk_out<4>(t, nr, oh_rows, tx, ty); break;
    }
    // the carry: KV[v][k] += sum_j g_j V[j][v] K~[j][k], v = ty + 16a, k = tx + 16c
#pragma unroll
    for (int a = 0; a < CV; ++a) {
      float up[CV];
#pragma unroll
      for (int c = 0; c < CV; ++c) up[c] = 0.f;
      for (int j = 0; j < nr; ++j) {
        const float gv = t.gs[j] * t.Vs[j * DK + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < CV; ++c) up[c] = fmaf(gv, t.Ks[j * kLdh + tx + 16 * c], up[c]);
      }
#pragma unroll
      for (int c = 0; c < CV; ++c) t.KV[(ty + 16 * a) * kLdh + tx + 16 * c] += up[c];
    }
    srun += gsum;
  }
  __syncthreads();
  const float norm = rsqrtf(fmaxf(srun, 1.f));
  float* dst = kv + (size_t)seq * DK * DK;
  for (int i = tid; i < DK * DK; i += 256) dst[i] = t.KV[(i / DK) * kLdh + i % DK] * norm;
  if (tid == 0) s[seq] = srun;
}

// logits[(b*Kt + k0 + k)*C + c] = (x_r / |x_r|) . embn[b, k0 + k], one warp per row
__global__ void __launch_bounds__(256)
logits_kernel(const float* __restrict__ x, const float* __restrict__ embn,
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
};

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
// K, D); valid (B, K); pe (C, D); logits (B, K, C); kv (L, B*C, H, dv, dk)
// and s (L, B*C, H), updated in place; ws of dec_frame_scan_workspace
// floats.  D and H are this build's (DTF_D, DTF_D / CR_DK).  Returns the
// first CUDA error of the launches.
extern "C" int dec_frame_scan_launch(const void* const* weights, const float* embp,
                                     const float* embn, const float* valid, const float* pe,
                                     float* logits, float* kv, float* s, float* ws, int B,
                                     int K, int C, int L, int F, void* stream) {
  static_assert(sizeof(DecWeights) == kNumWeights * sizeof(void*), "DecWeights");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DecWeights w;
  const float** dst = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < kNumWeights; ++i) dst[i] = static_cast<const float*>(weights[i]);
  Bufs bf;
  carve(ws, B, K, C, L, F, &bf);
  const int BC = B * C;
  const float kscale = (float)(1.0 / sqrt((double)DK));
  const size_t kvl = (size_t)BC * H * DK * DK;  // one layer's state
  const size_t rsmem = sizeof(float) * ret_smem_floats();
  int err;
#define DFS_TRY(call) \
  if ((err = (call)) != 0) return err
  DFS_TRY(cudaFuncSetAttribute(ret_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rsmem));
  for (int k0 = 0; k0 < K; k0 += kSlice) {
    const int Kc = K - k0 < kSlice ? K - k0 : kSlice;
    const long long R = (long long)BC * Kc;
    const Drop dp{0u, 0u, 1.f, C, Kc, Kc};  // no dropout: every multiplier is 1
    s0_kernel<<<(L * BC + 255) / 256, 256, 0, st>>>(s, bf.s0, L * BC);
    DFS_TRY(cudaGetLastError());
    const long long n4 = R * (D / 4);
    x0_kernel<<<(int)lmin((n4 + 255) / 256, 132 * 16), 256, 0, st>>>(embp, pe, bf.x0, C, Kc,
                                                                      K, k0, n4);
    DFS_TRY(cudaGetLastError());
    float *x = bf.x0, *y = bf.x1;
    for (int l = 0; l < L; ++l) {
      const float* lns = w.lns + (size_t)l * 3 * D;
      const float* lnb = w.lnb + (size_t)l * 3 * D;
      DFS_TRY(tc::launch_linear(x, D, w.wqkvg + (size_t)l * D * 4 * D, 4 * D,
                                w.bqkvg + (size_t)l * 4 * D, bf.big, 4 * D, (int)R, 4 * D, D,
                                st, D, 2 * D, kscale, bf.part));
      ret_block_kernel<<<BC * H, 256, rsmem, st>>>(bf.big, valid, bf.t1, kv + l * kvl,
                                                   s + (size_t)l * BC * H, bf.s0 + l * BC, C,
                                                   Kc, K, k0);
      DFS_TRY(cudaGetLastError());
      DFS_TRY(gate_fwd(bf.t1, bf.big + 3 * D, 4 * D, bf.t2, R, st));
      DFS_TRY(tc::launch_linear(bf.t2, D, w.wro + (size_t)l * D * D, D, w.bro + (size_t)l * D,
                                bf.t1, D, (int)R, D, D, st, 0, 0, 1.f, bf.part));
      DFS_TRY(add_drop_ln(x, bf.t1, lns, lnb, nullptr, y, R, dp, kRet, st));
      DFS_TRY(tc::launch_linear(y, D, w.wmi + (size_t)l * D * 3 * D, 3 * D,
                                w.bmi + (size_t)l * 3 * D, bf.big, 3 * D, (int)R, 3 * D, D,
                                st, 0, 0, 1.f, bf.part));
      DFS_TRY(slot_attn(bf.big, nullptr, bf.t1, B, dp, false, st));
      DFS_TRY(tc::launch_linear(bf.t1, D, w.wmo + (size_t)l * D * D, D, w.bmo + (size_t)l * D,
                                bf.t2, D, (int)R, D, D, st, 0, 0, 1.f, bf.part));
      DFS_TRY(add_drop_ln(y, bf.t2, lns + D, lnb + D, nullptr, x, R, dp, kMha, st));
      DFS_TRY(tc::launch_linear<tc::kRelu>(x, D, w.wf1 + (size_t)l * D * F, F,
                                           w.bf1 + (size_t)l * F, bf.big, F, (int)R, F, D,
                                           st, 0, 0, 1.f, bf.part));
      DFS_TRY(tc::launch_linear(bf.big, F, w.wf2 + (size_t)l * F * D, D, w.bf2 + (size_t)l * D,
                                bf.t1, D, (int)R, D, F, st, 0, 0, 1.f, bf.part));
      DFS_TRY(add_drop_ln(x, bf.t1, lns + 2 * D, lnb + 2 * D, nullptr, y, R, dp, kFfo, st));
      float* tmp = x;
      x = y;
      y = tmp;
    }
    logits_kernel<<<row_grid(R), 256, 0, st>>>(x, embn, logits, C, Kc, K, k0, R);
    DFS_TRY(cudaGetLastError());
  }
#undef DFS_TRY
  return 0;
}
