/* Native hot path of the FLAC decoder (fseend_tpu_torch/data/flac.py).
 *
 * The container/metadata/frame-header parsing stays in Python (it runs a
 * handful of times per frame); what lives here is the strictly bit-serial
 * per-sample work that dominates decode wall-clock on hour-long
 * recordings: Rice-partitioned residual decoding, VERBATIM sample reads,
 * and the FIXED/LPC integer prediction recurrences (the LPC one is
 * NOT vectorizable even in principle — the `>> shift` quantization is
 * applied inside the recurrence, so any float lfilter approximation
 * breaks bit-exactness).
 *
 * Mirrors flac.py::_Bits/_rice_residual/_decode_subframe semantics
 * EXACTLY (same reference anchor: the predict dataset's soundfile read,
 * FS-EEND/datasets/diarization_dataset_predict.py:66).  All functions
 * return the new bit position, or -1 on buffer overrun (the Python side
 * raises, matching the pure path's IndexError behavior).
 *
 * Built at first use by fseend_tpu_torch/data/_native.py with the system
 * C compiler into the repository's build/ (ctypes, no pybind11); the
 * pure-Python path remains as fallback and parity oracle
 * (tests/test_torch_port_data.py).
 */

#include <stdint.h>
#include <stddef.h>

typedef struct {
    const uint8_t *d;
    long long nbits;
    long long pos;
} bits_t;

static inline int rd(bits_t *b, int n, uint64_t *out) {
    if (b->pos + n > b->nbits) return -1;
    uint64_t v = 0;
    long long pos = b->pos;
    while (n > 0) {
        uint8_t byte = b->d[pos >> 3];
        int avail = 8 - (int)(pos & 7);
        int take = n < avail ? n : avail;
        int shift = avail - take;
        v = (v << take) | ((uint64_t)((byte >> shift) & ((1u << take) - 1u)));
        pos += take;
        n -= take;
    }
    b->pos = pos;
    *out = v;
    return 0;
}

static inline int rd_signed(bits_t *b, int n, int64_t *out) {
    uint64_t v;
    if (rd(b, n, &v)) return -1;
    if (n > 0 && (v >> (n - 1)))
        *out = (int64_t)v - ((int64_t)1 << n);
    else
        *out = (int64_t)v;
    return 0;
}

static inline int rd_unary(bits_t *b, int64_t *out) {
    int64_t count = 0;
    long long pos = b->pos;
    for (;;) {
        if (pos >= b->nbits) return -1;
        uint8_t byte = b->d[pos >> 3];
        int avail = 8 - (int)(pos & 7);
        uint8_t chunk = byte & ((1u << avail) - 1u);
        if (chunk == 0) {
            count += avail;
            pos += avail;
            continue;
        }
        /* highest set bit of chunk */
        int bl = 0;
        for (int t = chunk; t; t >>= 1) bl++;
        int lead = avail - bl;
        count += lead;
        pos += lead + 1;
        break;
    }
    b->pos = pos;
    *out = count;
    return 0;
}

/* Rice-partitioned residual (flac.py::_rice_residual).  out must hold
 * n - predictor_order entries. */
long long flac_rice_residual(const uint8_t *data, long long nbits,
                             long long bitpos, long long n,
                             int predictor_order, int param_bits,
                             int64_t *out) {
    bits_t b = {data, nbits, bitpos};
    uint64_t v;
    if (rd(&b, 4, &v)) return -1;
    int part_order = (int)v;
    long long n_parts = 1LL << part_order;
    long long idx = 0;
    uint64_t escape = (1ull << param_bits) - 1ull;
    for (long long p = 0; p < n_parts; p++) {
        long long count = (n >> part_order) - (p == 0 ? predictor_order : 0);
        /* malformed/malicious input: a partition shorter than the predictor
         * order gives count < 0 (idx would go negative -> OOB write), and a
         * bogus partition order can overrun the n - predictor_order output
         * buffer.  Reject both like any other bitstream overrun. */
        if (count < 0 || idx + count > n - predictor_order) return -1;
        uint64_t param;
        if (rd(&b, param_bits, &param)) return -1;
        if (param == escape) {
            uint64_t raw_bits;
            if (rd(&b, 5, &raw_bits)) return -1;
            for (long long i = 0; i < count; i++) {
                if (raw_bits) {
                    if (rd_signed(&b, (int)raw_bits, &out[idx + i])) return -1;
                } else {
                    out[idx + i] = 0;
                }
            }
        } else {
            int pbits = (int)param;
            for (long long i = 0; i < count; i++) {
                int64_t q;
                uint64_t r = 0;
                if (rd_unary(&b, &q)) return -1;
                if (pbits && rd(&b, pbits, &r)) return -1;
                uint64_t zz = ((uint64_t)q << pbits) | r;
                out[idx + i] = (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
            }
        }
        idx += count;
    }
    return b.pos;
}

/* n signed depth-bit samples (VERBATIM subframes). */
long long flac_read_verbatim(const uint8_t *data, long long nbits,
                             long long bitpos, long long n, int depth,
                             int64_t *out) {
    bits_t b = {data, nbits, bitpos};
    for (long long i = 0; i < n; i++)
        if (rd_signed(&b, depth, &out[i])) return -1;
    return b.pos;
}

/* FIXED predictor restore, in place: out[:order] holds warmup,
 * out[order:] holds residuals on entry. */
void flac_fixed_restore(int64_t *out, long long n, int order) {
    switch (order) {
    case 0:
        break;
    case 1:
        for (long long i = 1; i < n; i++) out[i] += out[i - 1];
        break;
    case 2:
        for (long long i = 2; i < n; i++)
            out[i] += 2 * out[i - 1] - out[i - 2];
        break;
    case 3:
        for (long long i = 3; i < n; i++)
            out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
    case 4:
        for (long long i = 4; i < n; i++)
            out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                      - out[i - 4];
        break;
    }
}

/* LPC restore, in place (quantized-coefficient recurrence with the
 * per-sample arithmetic shift — bit-exact integer math). */
void flac_lpc_restore(int64_t *out, long long n, int order,
                      const int32_t *coefs, int shift) {
    for (long long i = order; i < n; i++) {
        int64_t acc = 0;
        for (int j = 0; j < order; j++)
            acc += (int64_t)coefs[j] * out[i - 1 - j];
        out[i] += acc >> shift;
    }
}
