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
//
// The bf16 form (built with FS_BF16; the float32 build is the code above):
// q, k, v, out and the state (kv, scale) in and out are bf16, rounded where
// retention_pallas.py rounds (the output, :94-95; the stored state,
// :111-112), the state carried in float32 within the call.  Bound: the
// bytes (bf16 q, k, v read and out written once), the operations a few
// passes of 16 x 64 x 64 products per row on the bf16 tensor cores.  Which
// widths take which path, at compile time by the head dims:
//   - CR_DK = CR_DV = 64 (LS-EEND's, every main-path call): ret16.cuh's
//     core, bf16 k/v tiles by cp.async read with ldmatrix, the scores on
//     bf16 mma.sync, S V, the cross read and the state update with their
//     float32 operand as three bf16 terms, the output and (at T = L) the
//     new state from one launch; at T > L each chunk's summary on the same
//     terms, the fixed-order scan, then the output; design notes there;
//   - other head dims (the tests' 16 and 32): chunk_retention_tc.cuh's
//     bf16 form (bf16 scores, 3xTF32 on float32 tiles for the rest).
#include "chunk_retention_tc.cuh"
#if defined(FS_BF16) && CR_DK == 64 && CR_DV == 64
#include "ret16.cuh"
#endif

#ifndef CR_DK
#error "define CR_DK and CR_DV (the key and value dims of a head)"
#endif

#ifdef FS_BF16
using E = fs::bf16;
#else
using E = float;
#endif

// gamma (BH) float32; q, k (BH, T, CR_DK); v, out (BH, T, CR_DV); kv0, kvf
// (BH, CR_DK, CR_DV); s0, sf (BH); all but gamma and scratch of the element
// type E (bf16 with FS_BF16, else float).  scratch (BH * (T/L) * (CR_DK *
// CR_DV + 1)) floats when T > L, else may be null.  T % L == 0.  Returns the
// first CUDA error of the launches.
extern "C" int chunk_retention_launch(const float* gamma, const E* q, const E* k, const E* v,
                                      E* out, const E* kv0, const E* s0, E* kvf, E* sf,
                                      float* scratch, int BH, int T, int L, void* stream) {
  crt::ArgsE<E> a{};
  a.q = q, a.k = k, a.v = v, a.ldq = CR_DK, a.ldk = CR_DK, a.ldv = CR_DV;
  a.out = out, a.ldo = CR_DV, a.gamma = gamma, a.gmod = BH;
  a.kv0 = kv0, a.s0 = s0, a.kvf = kvf, a.sf = sf;
  a.kvbuf = scratch;
  a.cbuf = scratch ? scratch + (size_t)BH * (T / L) * CR_DK * CR_DV : nullptr;
  a.H = 1, a.T = T, a.L = L;
#if defined(FS_BF16) && CR_DK == 64 && CR_DV == 64
  return r16::core16<false>(a, nullptr, 0, BH, static_cast<cudaStream_t>(stream));
#else
  return crt::launch_core<CR_DK, CR_DV, false>(a, BH, static_cast<cudaStream_t>(stream));
#endif
}
