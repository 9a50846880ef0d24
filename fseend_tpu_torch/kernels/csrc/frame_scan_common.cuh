// Device helpers shared by the two frame-scan kernels (enc_frame_scan.cu,
// dec_frame_scan.cu).  Everything is float32.  Activations of the rows a
// block works on live in shared memory; weights are read from global memory
// (they stay in L2 across the blocks of a launch) in the (in, out) layout, so
// that the threads of a warp, one output column each, read neighbouring
// addresses.
#pragma once

#include <cuda_runtime.h>

namespace fs {

constexpr int kThreads = 256;

enum Act { kNone = 0, kRelu = 1, kSilu = 2 };

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

// Y[r][o] = act(b[o] + sum_i X[r][i] W[i][o])            (ADD = false)
// Y[r][o] += alpha * act(b[o] + sum_i X[r][i] W[i][o])   (ADD = true)
// for r < R, o < O.  W row-major (I, O) and b (O) in global memory; X (rows
// of stride ldx) and Y (stride ldy) in shared memory.  Needs I % 4 == 0 and
// 16-byte aligned X rows.  Each thread owns output columns o; every weight
// it loads is used for all R rows.
template <int R, int ACT, bool ADD>
__device__ __forceinline__ void linear_rows(const float* __restrict__ W,
                                            const float* __restrict__ b,
                                            const float* X, int ldx, float* Y,
                                            int ldy, int I, int O, float alpha) {
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const float* w = W + o;
#pragma unroll 4
    for (int i = 0; i < I; i += 4) {
      const float w0 = __ldg(w + (size_t)(i + 0) * O);
      const float w1 = __ldg(w + (size_t)(i + 1) * O);
      const float w2 = __ldg(w + (size_t)(i + 2) * O);
      const float w3 = __ldg(w + (size_t)(i + 3) * O);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(X + r * ldx + i);
        acc[r] = fmaf(xv.x, w0, acc[r]);
        acc[r] = fmaf(xv.y, w1, acc[r]);
        acc[r] = fmaf(xv.z, w2, acc[r]);
        acc[r] = fmaf(xv.w, w3, acc[r]);
      }
    }
    const float bo = __ldg(b + o);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = acc[r] + bo;
      if (ACT == kRelu) v = fmaxf(v, 0.f);
      if (ACT == kSilu) v = silu(v);
      if (ADD) {
        Y[r * ldy + o] += alpha * v;
      } else {
        Y[r * ldy + o] = v;
      }
    }
  }
}

// Layer norm of R rows of width D, one warp per row: mean, biased variance,
// (x - mean) * rsqrt(var + eps), then * scale + bias unless scale is null.
// X and Y may be the same buffer.
__device__ __forceinline__ void ln_rows(const float* X, int ldx, float* Y, int ldy,
                                        int R, int D, const float* __restrict__ scale,
                                        const float* __restrict__ bias, float eps) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    const float* x = X + r * ldx;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += x[d];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = x[d] - mu;
      v += c * c;
    }
    const float rs = rsqrtf(warp_sum(v) / D + eps);
    float* y = Y + r * ldy;
    for (int d = lane; d < D; d += 32) {
      const float t = (x[d] - mu) * rs;
      y[d] = scale ? t * __ldg(scale + d) + __ldg(bias + d) : t;
    }
  }
}

// qk[r*H + h] = q_rh . (k_rh * kscale) for the q | k | v | g rows of qkvg.
__device__ __forceinline__ void qk_rows(const float* qkvg, int ldq, float* qk, int R,
                                        int D, int H, int dk, float kscale) {
  for (int t = threadIdx.x; t < R * H; t += blockDim.x) {
    const int r = t / H, h = t % H;
    const float* q = qkvg + r * ldq + h * dk;
    const float* k = q + D;
    float a = 0.f;
    for (int j = 0; j < dk; ++j) a = fmaf(q[j], k[j] * kscale, a);
    qk[t] = a;
  }
}

// One gamma = 1 recurrent retention step for R rows of one lane, in the
// unnormalized form of the TPU kernels:
//   out  = (q . KV + (q . k) v) * rsqrt(s_old + 1)      (pre group norm)
//   KV  += v k^T * gate                                  (carry gated)
// KV rows live in global memory at kv + ((r*H + h)*dv + v)*dk.  The state
// that enters and leaves a launch is normalized: at the first frame KV is
// read as kv * sqrt(s_old), at the last it is written as KV * rsqrt(max(s, 1)).
// One warp per (r, h, v) row of KV; dk <= 64 (two values per lane); four
// rows per warp at a time so their loads are in flight together.
__device__ __forceinline__ void retention_rows(const float* qkvg, int ldq, float* out,
                                               int R, int D, int H, int dk, int dv,
                                               float* kv, const float* s_old,
                                               float gate, const float* qk,
                                               float kscale, bool first, bool last) {
  constexpr int U = 4;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int total = R * H * dv;
  const bool has0 = lane < dk, has1 = lane + 32 < dk;
  for (int base = (threadIdx.x >> 5) * U; base < total; base += nw * U) {
    float c0[U], c1[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u;
      c0[u] = 0.f;
      c1[u] = 0.f;
      if (row < total) {
        const float* p = kv + (size_t)row * dk;
        if (has0) c0[u] = p[lane];
        if (has1) c1[u] = p[lane + 32];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u;
      if (row >= total) break;  // uniform across the warp
      const int r = row / (H * dv), hv = row % (H * dv), h = hv / dv;
      const float so = s_old[r];
      const float in_scale = first ? sqrtf(so) : 1.f;
      const float out_norm = last ? rsqrtf(fmaxf(so + gate, 1.f)) : 1.f;
      const float* q = qkvg + r * ldq + h * dk;
      const float* k = q + D;
      const float vv = qkvg[r * ldq + 2 * D + hv];
      float* p = kv + (size_t)row * dk;
      float acc = 0.f;
      if (has0) {
        const float c = c0[u] * in_scale;
        acc = fmaf(q[lane], c, acc);
        p[lane] = (c + vv * (k[lane] * kscale * gate)) * out_norm;
      }
      if (has1) {
        const float c = c1[u] * in_scale;
        acc = fmaf(q[lane + 32], c, acc);
        p[lane + 32] = (c + vv * (k[lane + 32] * kscale * gate)) * out_norm;
      }
      acc = warp_sum(acc);
      if (lane == 0) out[r * D + hv] = (acc + qk[r * H + h] * vv) * rsqrtf(so + 1.f);
    }
  }
}

}  // namespace fs

extern "C" const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
