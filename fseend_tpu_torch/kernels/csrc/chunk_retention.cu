// Chunkwise retention core with carried state on Hopper, float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/retention_pallas.py
// (_forward_stateful and its _kernel; chunkwise_retention_stateful and, with
// gamma = 1 and a fresh state, chunkwise_retention): per (batch, head) row the
// intra-chunk decay-masked q k^T with its clamp-1 row renormalizer, the read
// of the carried (kv, scale) state, and the state update, chunk after chunk.
//
// What bounds it on the card: operations (per row and frame about
// (L + 1)(dk + dv) + 4 dk dv float32 operations against 4 (2 dk + 2 dv)
// bytes), on the tensor cores at three TF32 passes; at L = 128 the bytes come
// close.  The TPU kernel walks a row's chunks in sequence with the state in
// VMEM; here the state is formed by a scan over the chunks' summaries, so
// every (row, chunk, 64-query tile) is a block of its own and a call with few
// rows (8 at the LS encoder's batch pass) still fills the card.  The design
// is in chunk_retention_tc.cuh, which retention_layer.cu shares.
//
// The head dims are compile-time constants (CR_DK, CR_DV) so that every
// warp's accumulators stay in registers.
#include "chunk_retention_tc.cuh"

#ifndef CR_DK
#error "define CR_DK and CR_DV (the key and value dims of a head)"
#endif

// gamma (BH); q, k (BH, T, CR_DK); v, out (BH, T, CR_DV); kv0, kvf (BH, CR_DK,
// CR_DV); s0, sf (BH); scratch (BH * (T/L) * (CR_DK * CR_DV + 1)) floats when
// T > L, else may be null.  T % L == 0.  Returns the first CUDA error of the
// launches.
extern "C" int chunk_retention_launch(const float* gamma, const float* q, const float* k,
                                      const float* v, float* out, const float* kv0,
                                      const float* s0, float* kvf, float* sf, float* scratch,
                                      int BH, int T, int L, void* stream) {
  crt::Args a{};
  a.q = q, a.k = k, a.v = v, a.ldq = CR_DK, a.ldk = CR_DK, a.ldv = CR_DV;
  a.out = out, a.ldo = CR_DV, a.gamma = gamma, a.gmod = BH;
  a.kv0 = kv0, a.s0 = s0, a.kvf = kvf, a.sf = sf;
  a.kvbuf = scratch;
  a.cbuf = scratch ? scratch + (size_t)BH * (T / L) * CR_DK * CR_DV : nullptr;
  a.H = 1, a.T = T, a.L = L;
  return crt::launch_core<CR_DK, CR_DV, false>(a, BH, static_cast<cudaStream_t>(stream));
}
