// The exact gamma = 1 retention recurrence of the two frame scans computed
// layer by layer over a block (dec_frame_scan.cu, enc_frame_scan.cu), float32.
//
// A block of K frames is walked in slices of at most kSlice frames that carry
// the state, so a caller's workspace stays (sequences) * kSlice rows whatever
// K is.  For each (sequence, head) -- a (lane, slot) of the decoder, a lane of
// the encoder -- with gates g_j, the state read as KV0 = kv * sqrt(s0) and
// k~ = k dk^-1/2:
//   out_k = (q_k KV0 + sum_{j<k} g_j (q_k . k~_j) v_j + (q_k . k~_k) v_k)
//           * rsqrt(s0 + sum_{j<k} g_j + 1)
//   KV    = KV0 + sum_j g_j v_j k~_j^T,   s = s0 + sum_j g_j,
// written back as kv = KV * rsqrt(max(s, 1)): the arithmetic of the plain
// versions and the TPU kernels' identity, not the renormalized chunkwise form.
// D, DK and H are the build's (dec_train_fusion_common.cuh).
//
// T is the element type of q | k~ | v | g, the stored state kv and the count
// s: float32, or bf16 for the bf16 forms.  Within a call the state is
// carried in float32 in shared memory and rounded to T once, when it is
// stored (kv and s both); a frame's output is float32 until the group norm
// (gate_fwd) rounds it.  The TPU kernels FMA the bf16 state every frame
// (dec_frame_scan_pallas.py:126-128, enc_frame_scan_pallas.py:101): that
// drops a frame's increment once the gamma = 1 sum is about 256 times it,
// while the carry here loses nothing within a call; the stored state is
// bf16 in both, and at K = 1 (step()) the two differ by one rounding.
#pragma once

#include "dec_train_fusion_common.cuh"

namespace frs {

using namespace dtf;

constexpr int kSlice = 128;  // frames per slice of the block
constexpr int kT = 64;       // frames per retention chunk

// s0[l*BC + bc] = s[(l*BC + bc)*H]: every head of a (layer, lane, slot)
// reads head 0's count, as the plain version does
template <typename T>
__global__ void s0_kernel(const T* __restrict__ s, float* __restrict__ s0, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    s0[i] = fs::f32(s[(size_t)i * H]);
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

// rows r = seq_of_row * Kc + k of qkvg (stride 4D: q | k~ | v | g) and oh (stride
// D); sequence bc = seq / H reads its gates at valid[(bc / C) * Kt + k0 + k]
template <typename T>
__global__ void __launch_bounds__(256)
ret_block_kernel(const T* __restrict__ qkvg, const float* __restrict__ valid,
                 float* __restrict__ oh, T* __restrict__ kv, T* __restrict__ s,
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
    const T* src = kv + (size_t)seq * DK * DK;
    for (int i = tid; i < DK * DK; i += 256) t.KV[(i / DK) * kLdh + i % DK] = fs::f32(src[i]) * sc;
  }
  for (int n0 = 0; n0 < Kc; n0 += kT) {
    const int nr = min(kT, Kc - n0);
    const int live = (nr + 15) / 16 * 16;  // rows of the live row groups
    __syncthreads();  // the previous chunk is done with every tile
    const T* rows = qkvg + ((size_t)bc * Kc + n0) * 4 * D;
    for (int idx = tid; idx < live * (DK / 4); idx += 256) {
      const int i = idx / (DK / 4), c = (idx % (DK / 4)) * 4;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), kv4 = qv, vv = qv;
      if (i < nr) {
        const T* p = rows + (size_t)i * 4 * D + h * DK + c;
        qv = fs::load4(p);
        kv4 = fs::load4(p + D);
        vv = fs::load4(p + 2 * D);
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
  T* dst = kv + (size_t)seq * DK * DK;
  for (int i = tid; i < DK * DK; i += 256)
    dst[i] = fs::As<T>::from(t.KV[(i / DK) * kLdh + i % DK] * norm);
  if (tid == 0) s[seq] = fs::As<T>::from(srun);
}

}  // namespace frs
