// Chunkwise retention core with carried state on Hopper, float32.
//
// Replaces the TPU kernel fseend_tpu/kernels/retention_pallas.py
// (_forward_stateful and its _kernel; chunkwise_retention_stateful and, with
// gamma = 1 and a fresh state, chunkwise_retention): per (batch, head) row the
// intra-chunk decay-masked q k^T with its clamp-1 row renormalizer, the read
// of the carried (kv, scale) state, and the state update, chunk after chunk.
//
// What bounds it on the card: operations at the serving shapes (per row and
// frame about (L + 1)(dk + dv) + 4 dk dv float32 operations against
// 4 (2 dk + 2 dv) bytes), on the FMA pipe.  The arithmetic and the design
// (one block per row, chunks looped inside the launch, 64-frame tiles so
// that a 500-frame chunk never has to fit in shared memory, the state in
// shared memory, the incoming state left untouched) are in
// chunk_retention_core.cuh, which retention_layer.cu shares.
//
// The head dims are compile-time constants (CR_DK, CR_DV) so that every
// thread's tile of accumulators stays in registers.
#include "chunk_retention_core.cuh"

#ifndef CR_DK
#error "define CR_DK and CR_DV (the key and value dims of a head)"
#endif

// gamma (BH); q, k (BH, T, CR_DK); v, out (BH, T, CR_DV); kv0, kvf (BH, CR_DK,
// CR_DV); s0, sf (BH).  T % L == 0.  Returns cudaGetLastError().
extern "C" int chunk_retention_launch(const float* gamma, const float* q, const float* k,
                                      const float* v, float* out, const float* kv0,
                                      const float* s0, float* kvf, float* sf, int BH,
                                      int T, int L, void* stream) {
  cr::CoreArgs a{q, k, v, CR_DK, CR_DK, CR_DV, out, CR_DV, gamma, BH,
                 kv0, s0, kvf, sf, /*H=*/1, T, L};
  return cr::launch_core<CR_DK, CR_DV, false>(a, BH, static_cast<cudaStream_t>(stream));
}
