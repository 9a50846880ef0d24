"""PyTorch port, the encoder frame scan computed layer by layer over the
block (the algorithm of `fseend_tpu_torch/kernels/csrc/enc_frame_scan.cu`):
a plain PyTorch mirror of it, kept in this file, against the frame-by-frame
plain version `enc_frame_scan_plain` and against the JAX package's Pallas
kernel `enc_frame_scan` in interpret mode, on the same weights, inputs and
state.

The mirror runs each conformer block over all (lane, frame) rows of a slice
of frames at once, the slices carrying the state.  Its retention is the
exact recurrent form in chunks (gates g_j = 1 - flush[b, j]); its causal
depthwise conv is a gather: per lane S = [the conv window at the start of
the slice (0 and the carried history at the start of a call), then the GLU
outputs of the slice's kept (non-flushed) frames]; with n_k the kept frames
up to and including frame k, frame k reads S[n_k .. n_k + kc - 1], and the
window left is S[n .. n + kc - 1] for the last n.  Cases: K 1, 7 and 33 at
chunk 16 and slices of 32 (one frame, one partial chunk, two slices), conv
kernels 4 and 16, flushed frames at the start, in the middle and at the
tail of a block and in a random pattern, incoming counts s0 of 0 and above,
two calls in a row; against the Pallas kernel K 33 with kernel 16 (two
slices, three chunks, every flush pattern), one interpretation costing
seconds.

Tolerance: 1e-5 against the plain version, both run in float64 here so that
the comparison sees the algorithm and not float32's summation order (in
float32 the two differ by up to 1.5e-5 after two layers: products over
B*Kc rows and over B rows sum in other orders); 2e-4 against the Pallas
kernel in float32 (the port's tolerance against the JAX package).

The bf16 form's layer (`csrc/scan16.cuh`, eight kernels a layer) has a
mirror of its own, `enc_block_mirror16`: the residual add rounded and its
LayerNorm in the products' epilogues (the mean, then the squared
deviations), the group norm and gate after the recurrence, pw1's a and b
columns interleaved in groups of 8 and the GLU formed from them, the
FFN's second product summed over slices of its hidden layer, bf16
rounding at the plain version's points.  Held on one 5-frame call against
`enc_frame_scan_plain` in bf16 by chip_smoke.py's bf16 guard (the drift
rule, not a float32 computation, within half of the bf16 plain version's
mean distance from float32) and against the Pallas kernel in interpret
mode on the same bf16 operands by the JAX package's drift rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fseend_tpu.kernels import enc_frame_scan_pallas as JEFS
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)
B, D, H, L = 5, 64, 4, 2
FF = 4 * D
DK = D // H
CHUNK, SLICE = 16, 32
FFAC = 0.5
JAX_CASES = ((33, 16),)                          # (K, conv kernel) interpreted once each
ATOL_PLAIN, ATOL_JAX = 1e-5, 2e-4


def _weights(rng, kc: int) -> EFS.EncWeights:
    """Random conformer-block weights in the port's (in, out) layouts, the
    BatchNorm folded to a non-trivial (a, b)."""
    def r(*shape, scale):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32)

    def ff():
        return (r(L, D, FF, scale=D ** -0.5), r(L, FF, scale=0.1),
                r(L, FF, D, scale=FF ** -0.5), r(L, D, scale=0.1))

    f1, f2 = ff(), ff()
    return EFS.EncWeights(
        1.0 + r(L, 5, D, scale=0.1), r(L, 5, D, scale=0.1), *f1,
        r(L, D, 4 * D, scale=D ** -0.5), r(L, 4 * D, scale=0.1),
        r(L, D, D, scale=D ** -0.5), r(L, D, scale=0.1),
        r(L, D, 2 * D, scale=D ** -0.5), r(L, 2 * D, scale=0.1),
        r(L, kc, D, scale=kc ** -0.5),
        torch.as_tensor(rng.uniform(0.5, 1.5, (L, D)), dtype=torch.float32),
        r(L, D, scale=0.1), r(L, D, D, scale=D ** -0.5), r(L, D, scale=0.1), *f2)


def _flush(rng, K: int) -> np.ndarray:
    """Lane 0 never flushed; lane 1 flushed for its first frames, then not;
    lane 2 flushed in the middle; lane 3 flushed from a frame to the end;
    lane 4 a random pattern."""
    fl = np.zeros((B, K), np.float32)
    fl[1, :min(3, K)] = 1.0
    fl[2, K // 3:2 * K // 3 + 1] = 1.0
    fl[3, K // 2:] = 1.0
    fl[4] = rng.integers(0, 2, K)
    return fl


def _case(K: int, kc: int, seed: int):
    """Inputs and state of one call; incoming counts 0, 3, 40, 7 and 1 per
    lane (every head of a lane shares its count, as a running model's state
    does)."""
    rng = np.random.default_rng(seed)
    h0 = torch.as_tensor(rng.standard_normal((B, K, D)), dtype=torch.float32)
    s0 = np.array([0.0, 3.0, 40.0, 7.0, 1.0], np.float32)
    s = torch.as_tensor(np.broadcast_to(s0[None, :, None], (L, B, H)).copy())
    kv = torch.as_tensor(rng.standard_normal((L, B, H, DK, DK)) * 0.2, dtype=torch.float32)
    ring = torch.as_tensor(rng.standard_normal((L, B, kc - 1, D)) * 0.5, dtype=torch.float32)
    return h0, torch.as_tensor(_flush(rng, K)), kv, s, ring


def block_retention(q, k, v, g, kv, s0, chunk):
    """The exact gamma = 1 recurrence of N independent sequences in chunks
    that carry the state.  q, k (N, K, dk) with k already scaled by dk^-1/2,
    v (N, K, dv), g (N, K) gates, kv (N, dv, dk) normalized state, s0 (N,)
    counts -> (out (N, K, dv) before the group norm, kv, s)."""
    KV = kv * torch.sqrt(s0)[:, None, None]
    s = s0.clone()
    outs = []
    for n0 in range(0, q.shape[1], chunk):
        qc, kc, vc, gc = (t[:, n0:n0 + chunk] for t in (q, k, v, g))
        T = qc.shape[1]
        below = torch.tril(torch.ones(T, T), diagonal=-1)
        w = (qc @ kc.transpose(-1, -2)) * (below * gc[:, None, :] + torch.eye(T))
        prefix = s[:, None] + torch.cumsum(gc, dim=1) - gc          # sum_{j<k} g_j
        out = (qc @ KV.transpose(-1, -2) + w @ vc) * torch.rsqrt(prefix + 1.0)[..., None]
        KV = KV + (vc * gc[..., None]).transpose(-1, -2) @ kc
        s = s + gc.sum(dim=1)
        outs.append(out)
    return torch.cat(outs, dim=1), KV * torch.rsqrt(s.clamp(min=1.0))[:, None, None], s


def conv_gather(glu, gate, win, dw):
    """The causal depthwise conv over a slice as a gather: glu (B, Kc, D)
    GLU outputs, gate (B, Kc) 0 where flushed, win (B, kc, D) the window at
    the start of the slice, dw (kc, D) -> (y (B, Kc, D), the window after)."""
    Bn, Kc, Dn = glu.shape
    kc = win.shape[1]
    kept = gate != 0
    n = torch.cumsum(kept.to(torch.int64), dim=1)                   # n_k, inclusive
    S = torch.cat([win, glu.new_zeros(Bn, Kc, Dn)], dim=1)          # (B, kc + Kc, D)
    lane, frame = kept.nonzero(as_tuple=True)
    S[lane, kc - 1 + n[lane, frame]] = glu[lane, frame]
    rows = torch.arange(Bn)[:, None, None]
    y = (S[rows, n[..., None] + torch.arange(kc)] * dw).sum(2)      # (B, Kc, D)
    return y, S[torch.arange(Bn)[:, None], n[:, -1:] + torch.arange(kc)]


@torch.no_grad()
def enc_block_mirror(h0, flush, w, kv, s, ring, *, ffac, chunk=CHUNK, slice_len=SLICE):
    """The layer-major encoder frame scan; the same in-place contract as
    `enc_frame_scan`.  Rows are (lane, frame) within a slice."""
    Bn, K, Dn = h0.shape
    Ln, _, Hn, dv, dk = kv.shape
    win = [torch.cat([ring.new_zeros(Bn, 1, Dn), ring[l]], dim=1) for l in range(Ln)]

    def ln(t, l, i):
        return tnn.layer_norm(t, w.lns[l, i], w.lnb[l, i])

    def half_ff(x, l, i, wa, ba, wb, bb):
        return x + ffac * (F.silu(ln(x, l, i) @ wa[l] + ba[l]) @ wb[l] + bb[l])

    outs = []
    for k0 in range(0, K, slice_len):
        Kc = min(slice_len, K - k0)
        x = h0[:, k0:k0 + Kc].reshape(Bn * Kc, Dn)
        gate = 1.0 - flush[:, k0:k0 + Kc]

        def heads(t, d):  # (B*Kc, H*d) -> (B*H, Kc, d)
            return t.reshape(Bn, Kc, Hn, d).permute(0, 2, 1, 3).reshape(Bn * Hn, Kc, d)

        for l in range(Ln):
            x = half_ff(x, l, 0, w.wf1a, w.bf1a, w.wf1b, w.bf1b)
            qkvg = ln(x, l, 1) @ w.wqkvg[l] + w.bqkvg[l]
            out, kv_l, s_l = block_retention(
                heads(qkvg[:, :Dn], dk), heads(qkvg[:, Dn:2 * Dn] * dk ** -0.5, dk),
                heads(qkvg[:, 2 * Dn:3 * Dn], dv), gate.repeat_interleave(Hn, dim=0),
                kv[l].reshape(Bn * Hn, dv, dk), s[l, :, 0].repeat_interleave(Hn), chunk)
            kv[l] = kv_l.reshape(Bn, Hn, dv, dk)
            s[l] = s_l.reshape(Bn, Hn)
            out = out.reshape(Bn, Hn, Kc, dv).permute(0, 2, 1, 3)
            out = tnn.layer_norm(out, eps=1e-6).reshape(Bn * Kc, Dn)
            x = x + (F.silu(qkvg[:, 3 * Dn:]) * out) @ w.wro[l] + w.bro[l]
            pw = ln(x, l, 2) @ w.wpw1[l] + w.bpw1[l]
            glu = (pw[:, :Dn] * torch.sigmoid(pw[:, Dn:])).reshape(Bn, Kc, Dn)
            y, win[l] = conv_gather(glu, gate, win[l], w.dw[l])
            y = y.reshape(Bn * Kc, Dn) * w.bna[l] + w.bnb[l]
            x = x + F.silu(y) @ w.wpw2[l] + w.bpw2[l]
            x = half_ff(x, l, 3, w.wf2a, w.bf2a, w.wf2b, w.bf2b)
            x = ln(x, l, 4)
        outs.append(x.reshape(Bn, Kc, Dn))
    for l in range(Ln):
        ring[l] = win[l][:, 1:]
    return torch.cat(outs, dim=1)


def _jax_call(h0, flush, w, kv, s, ring, dt=jnp.float32):
    """The Pallas kernel in interpret mode on the same operands, in its
    layouts and the data type `dt` (every operand but flush and s, which it
    takes in float32, as the JAX package's `pack_enc_state` hands it);
    returns (h (B, K, D), kv (L, B, H, dv, dk), s (L, B), ring (L, B, kc-1,
    D)) in float32."""
    npf = lambda t: t.float().numpy()                                  # noqa: E731
    T2 = lambda t: jnp.asarray(npf(t.transpose(1, 2)), dt)             # noqa: E731
    col = lambda t: jnp.asarray(npf(t)[..., None], dt)                 # noqa: E731
    jw = [col(t) if t.ndim < 3 or name in ("lns", "lnb", "dw") else T2(t)
          for name, t in w._asdict().items()]
    ring0 = torch.cat([torch.zeros_like(ring[:, :, :1]), ring], dim=2)
    with jax.default_matmul_precision("highest"):
        jh, jkv, js, jring = JEFS.enc_frame_scan(
            jnp.asarray(npf(h0.permute(1, 2, 0)), dt), jnp.asarray(npf(flush.T[:, None, :])),
            *jw, jnp.asarray(npf(kv.permute(0, 2, 3, 4, 1)), dt),
            jnp.asarray(npf(s[:, None, :, 0])), jnp.asarray(npf(ring0.permute(0, 2, 3, 1)), dt),
            ffac=FFAC, interpret=True)
    as32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))           # noqa: E731
    return (as32(jh).transpose(2, 0, 1), as32(jkv).transpose(0, 4, 1, 2, 3),
            as32(js)[:, 0], as32(jring)[:, 1:].transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def jax_cases():
    """Per (K, kc): the weights, the inputs and the Pallas kernel's result on
    them (each interpretation costs seconds, so each shape is interpreted
    once, with XLA's optimization passes off while it compiles: the same
    arithmetic in less time)."""
    out = {}
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for K, kc in JAX_CASES:
            w = _weights(np.random.default_rng(kc), kc)
            args = _case(K, kc, seed=K)
            out[K, kc] = (w, args, _jax_call(args[0], args[1], w, *args[2:]))
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    return out


def _f64(args, w):
    return [t.double() for t in args], EFS.EncWeights(*(t.double() for t in w))


def _run(fn, args, w, **kw):
    h0, flush, kv, s, ring = (t.clone() for t in args)
    h = fn(h0, flush, w, kv, s, ring, ffac=FFAC, **kw)
    return h, kv, s, ring


@pytest.mark.parametrize("kc", [4, 16])
@pytest.mark.parametrize("K", [1, 7, 33])
def test_conv_gather_matches_frame_by_frame_ring(K, kc):
    """The gather alone against the frame-by-frame ring: a flushed frame
    reads the ring as it stands, a kept one shifts its GLU output in."""
    rng = np.random.default_rng(K + kc)
    glu = torch.as_tensor(rng.standard_normal((B, K, D)), dtype=torch.float32)
    gate = 1.0 - torch.as_tensor(_flush(rng, K))
    win = torch.as_tensor(rng.standard_normal((B, kc, D)), dtype=torch.float32)
    dw = torch.as_tensor(rng.standard_normal((kc, D)), dtype=torch.float32)
    y, win_after = conv_gather(glu, gate, win, dw)
    rg = win.clone()
    for k in range(K):
        shifted = torch.cat([rg[:, 1:], glu[:, k, None]], dim=1)
        rg = torch.where((gate[:, k] != 0)[:, None, None], shifted, rg)
        torch.testing.assert_close(y[:, k], (rg * dw).sum(1), atol=ATOL_PLAIN, rtol=0)
    torch.testing.assert_close(win_after, rg, atol=0, rtol=0)


@pytest.mark.parametrize("kc", [4, 16])
@pytest.mark.parametrize("K", [1, 7, 33])
def test_layer_major_block_matches_plain_frame_scan(K, kc):
    args, w = _f64(_case(K, kc, seed=K), _weights(np.random.default_rng(kc), kc))
    got = _run(enc_block_mirror, args, w)
    want = _run(EFS.enc_frame_scan_plain, args, w)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=ATOL_PLAIN, rtol=0)


@pytest.mark.parametrize("K,kc", JAX_CASES)
def test_layer_major_block_matches_pallas_kernel(jax_cases, K, kc):
    w, args, (jh, jkv, js, jring) = jax_cases[K, kc]
    h, kv, s, ring = _run(enc_block_mirror, args, w)
    np.testing.assert_allclose(h.numpy(), jh, atol=ATOL_JAX)
    np.testing.assert_allclose(kv.numpy(), jkv, atol=ATOL_JAX)
    np.testing.assert_allclose(s[..., 0].numpy(), js, atol=0)
    np.testing.assert_allclose(ring.numpy(), jring, atol=ATOL_JAX)


def test_two_calls_carry_the_state():
    """Two calls in a row (7 frames, then 33 over two slices) on the mirror
    and on the plain version: the second call reads the kv, s and ring the
    first left, including lanes whose second call starts flushed (they read
    the ring's zero slot)."""
    first, w = _f64(_case(7, 16, seed=5), _weights(np.random.default_rng(2), 16))
    second, _ = _f64(_case(33, 16, seed=6), w)
    res = []
    for fn in (enc_block_mirror, EFS.enc_frame_scan_plain):
        h0, flush, kv, s, ring = (t.clone() for t in first)
        hs = [fn(h0, flush, w, kv, s, ring, ffac=FFAC)]
        hs.append(fn(second[0], second[1], w, kv, s, ring, ffac=FFAC))
        res.append((torch.cat(hs, dim=1), kv, s, ring))
    for g, x in zip(*res):
        torch.testing.assert_close(g, x, atol=ATOL_PLAIN, rtol=0)


# ---------------------------------------------------------------------------
# The bf16 form's layer (csrc/scan16.cuh, what the CUDA kernel runs over a
# block of many rows and at K = 1): the residual add rounded and its
# LayerNorm in the products' epilogues, the recurrence with the group norm
# and gate after it, pw1's GLU from interleaved columns, the FFN's hidden
# layer rounded to bf16 and multiplied in slices of its width
# ---------------------------------------------------------------------------

BF = torch.bfloat16
K16 = 5            # one bf16 shape: two chunks of 3 frames (the second partial)
CHUNK16 = 3
FFN_SLICE = 64     # four slices of the 256-wide hidden layer (the kernel's kFS)
BF16_CLOSE = 0.5   # chip_smoke.py's bf16_guard share for the one-frame calls


def _r(t):
    """A bf16 rounding point: rounded to bf16, read back in float32."""
    return t.to(BF).float()


def _ln16(v, scale, shift, eps=1e-5):
    """The epilogues' LayerNorm: the mean, then the squared deviations,
    rounded to bf16."""
    mu = v.mean(-1, keepdim=True)
    var = (v - mu).square().mean(-1, keepdim=True)
    return _r((v - mu) * torch.rsqrt(var + eps) * scale + shift)


def _glu_interleaved(t, w, b):
    """pw1 and the GLU as kGlu computes them: W's a and b columns
    interleaved in groups of 8 (transpose16<true>'s order), each 16-column
    group's product formed, then round(a sigmoid(b)) per channel."""
    Dn = w.shape[0]
    d = torch.arange(2 * Dn) % Dn
    half = torch.arange(2 * Dn) // Dn
    order = torch.argsort(16 * (d // 8) + 8 * half + d % 8)    # interleaved column -> pw1 column
    prod = t @ w[:, order] + b[order]                           # (R, 2D), groups of 8 a then 8 b
    g = prod.reshape(-1, Dn // 8, 2, 8)
    return _r(g[:, :, 0] * torch.sigmoid(g[:, :, 1])).reshape(-1, Dn)


def _in_runs(a, b, runs, width):
    """a @ b as kPart and its row kernel sum it: the inner dimension in
    `runs` equal runs, each run's sum over its `width`-wide slices in order,
    then the runs' sums added in order (runs 1: the whole product on one
    block)."""
    n = a.shape[1] // runs
    parts = []
    for z in range(runs):
        p = a[:, z * n:z * n + width] @ b[z * n:z * n + width]
        for f0 in range(z * n + width, (z + 1) * n, width):
            p = p + a[:, f0:f0 + width] @ b[f0:f0 + width]
        parts.append(p)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@torch.no_grad()
def enc_block_mirror16(h0, flush, w, kv, s, ring, *, ffac, chunk=CHUNK16, ffn_slice=FFN_SLICE,
                       ffn_runs=1, k_runs=1):
    """The layer-major encoder frame scan as its bf16 layer computes it, on
    bf16 operands, in float32 between the bf16 rounding points of
    `enc_frame_scan_plain` (each LayerNorm's output, the half FF's hidden
    layer, x after each residual add, q | k | v | g and k~ = k dk^-1/2 in
    bf16, the group norm's output and the gated value, the GLU output,
    silu of the conv); the state carried in float32 within the call and
    stored in bf16.  The FFN's second product is summed over
    `ffn_slice`-wide slices of the hidden layer in order, in `ffn_runs`
    runs of them, and the out projection's and pw2's over `k_runs` runs of
    their inner dimension (the kernel's split over few rows).  One slice of
    frames; the same in-place contract."""
    Bn, K, Dn = h0.shape
    Ln, _, Hn, dv, dk = kv.shape
    w = EFS.EncWeights(*(t.float() for t in w))
    kscale = float(torch.tensor(dk ** -0.5).to(BF))
    gate = 1.0 - flush.float()
    win = [torch.cat([ring.new_zeros(Bn, 1, Dn), ring[l]], dim=1).float() for l in range(Ln)]

    def heads(t, d):  # (B*K, H*d) -> (B*H, K, d)
        return t.reshape(Bn, K, Hn, d).permute(0, 2, 1, 3).reshape(Bn * Hn, K, d)

    def half_ff(x, t, l, wa, ba, wb, bb):  # round(x + ffac (...)) from t = LN(x)
        hid = _r(F.silu(t @ wa[l] + ba[l]))
        return _r(x + (_in_runs(hid, wb[l], ffn_runs, ffn_slice) + bb[l]) * ffac)

    def product(a, wl):  # the out projection's and pw2's product
        return a @ wl if k_runs == 1 else _in_runs(a, wl, k_runs, a.shape[1] // k_runs)

    x = h0.float().reshape(Bn * K, Dn)
    t = _ln16(x, w.lns[0, 0], w.lnb[0, 0])
    for l in range(Ln):
        x = half_ff(x, t, l, w.wf1a, w.bf1a, w.wf1b, w.bf1b)
        t = _ln16(x, w.lns[l, 1], w.lnb[l, 1])
        qkvg = _r(t @ w.wqkvg[l] + w.bqkvg[l])
        out, kv_l, s_l = block_retention(
            heads(qkvg[:, :Dn], dk), heads(_r(qkvg[:, Dn:2 * Dn] * kscale), dk),
            heads(qkvg[:, 2 * Dn:3 * Dn], dv), gate.repeat_interleave(Hn, dim=0),
            kv[l].float().reshape(Bn * Hn, dv, dk), s[l, :, 0].float().repeat_interleave(Hn),
            chunk)
        kv[l] = kv_l.reshape(Bn, Hn, dv, dk).to(kv.dtype)
        s[l] = s_l.reshape(Bn, Hn).to(s.dtype)
        out = out.reshape(Bn, Hn, K, dv).permute(0, 2, 1, 3)
        norm = _r(tnn.layer_norm(out, eps=1e-6)).reshape(Bn * K, Dn)
        gated = _r(F.silu(qkvg[:, 3 * Dn:]) * norm)
        x = _r(x + (product(gated, w.wro[l]) + w.bro[l]))
        t = _ln16(x, w.lns[l, 2], w.lnb[l, 2])
        glu = _glu_interleaved(t, w.wpw1[l], w.bpw1[l]).reshape(Bn, K, Dn)
        y, win[l] = conv_gather(glu, gate, win[l], w.dw[l])
        c = _r(F.silu(y.reshape(Bn * K, Dn) * w.bna[l] + w.bnb[l]))
        x = _r(x + (product(c, w.wpw2[l]) + w.bpw2[l]))
        t = _ln16(x, w.lns[l, 3], w.lnb[l, 3])
        x = _ln16(half_ff(x, t, l, w.wf2a, w.bf2a, w.wf2b, w.bf2b), w.lns[l, 4], w.lnb[l, 4])
        if l + 1 < Ln:
            t = _ln16(x, w.lns[l + 1, 0], w.lnb[l + 1, 0])
    for l in range(Ln):
        ring[l] = win[l][:, 1:].to(ring.dtype)
    return x.reshape(Bn, K, Dn).to(h0.dtype)


@pytest.fixture(scope="module")
def case16():
    """One bf16 call (K16 frames, the weights and state in bf16), and the
    Pallas kernel on it in interpret mode in bf16, once (XLA's optimization
    passes off while it compiles: the same arithmetic, half the time)."""
    w = EFS.EncWeights(*(t.to(BF) for t in _weights(np.random.default_rng(4), 4)))
    h0, flush, kv, s, ring = _case(K16, 4, seed=16)
    args = [h0.to(BF), flush, kv.to(BF), s.to(BF), ring.to(BF)]
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return w, args, _jax_call(args[0], flush, w, *args[2:], dt=jnp.bfloat16)
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


def _bf16_guard(got, want16, want32, what, close=BF16_CLOSE):
    """chip_smoke.py's bf16_guard: the drift rule from float32 (max abs), not
    a float32 computation (mean), closer to the bf16 yardstick than `close`
    of its distance from float32 (mean; None: not asked)."""
    g, w16, w32 = (torch.as_tensor(np.array(t, np.float32)) if not torch.is_tensor(t)
                   else t.float() for t in (got, want16, want32))
    d16, d32 = (w16 - w32).abs(), (g - w32).abs()
    assert float(d32.max()) <= 3 * float(d16.max()) + 1e-3, (what, float(d32.max()))
    assert float(d32.mean()) >= 0.5 * float(d16.mean()), (what, "a float32 computation")
    if close is not None:
        near = float((g - w16).abs().mean())
        assert near <= close * float(d16.mean()), (what, near, float(d16.mean()))


def _f32(args, w):
    return [t.float() for t in args], EFS.EncWeights(*(t.float() for t in w))


def test_bf16_layer_major_block_matches_plain_frame_scan(case16):
    """The bf16 mirror against the bf16 plain version (frame by frame, one
    product over the whole hidden layer, pw1 in its own column order,
    LayerNorm in torch) on the same bf16 operands: the same rounding
    points, so within the bf16 guard's closeness; the state stays bf16 and
    the counts are the same."""
    w, args, _ = case16
    got = _run(enc_block_mirror16, args, w)
    want16 = _run(EFS.enc_frame_scan_plain, args, w)
    want32 = _run(EFS.enc_frame_scan_plain, *_f32(args, w))
    assert all(t.dtype == BF for t in got)
    for what, i in (("h", 0), ("kv", 1), ("ring", 3)):
        _bf16_guard(got[i], want16[i], want32[i], what)
    torch.testing.assert_close(got[2], want16[2], atol=0, rtol=0)


def test_bf16_layer_major_block_in_runs_matches_plain_frame_scan(case16):
    """The bf16 mirror as the kernel runs a slice of few rows (a step()'s):
    the FFN's hidden slices in four runs and the out projection's and
    pw2's inner dimension in four, each run's float32 sum added in order,
    against the bf16 plain version by the same guard; the counts the
    same."""
    w, args, _ = case16
    got = _run(enc_block_mirror16, args, w, ffn_runs=4, k_runs=4)
    want16 = _run(EFS.enc_frame_scan_plain, args, w)
    want32 = _run(EFS.enc_frame_scan_plain, *_f32(args, w))
    for what, i in (("h", 0), ("kv", 1), ("ring", 3)):
        _bf16_guard(got[i], want16[i], want32[i], what)
    torch.testing.assert_close(got[2], want16[2], atol=0, rtol=0)


def test_bf16_layer_major_block_matches_pallas_kernel(case16):
    """The bf16 mirror against the Pallas kernel on bf16 operands in
    interpret mode, by the JAX package's drift rule from the float32 plain
    version on the same values (the Pallas kernel carries its state in bf16
    from frame to frame, this form in float32 within the call)."""
    w, args, (jh, jkv, js, jring) = case16
    got = _run(enc_block_mirror16, args, w)
    want32 = _run(EFS.enc_frame_scan_plain, *_f32(args, w))
    for what, i, j in (("h", 0, jh), ("kv", 1, jkv), ("ring", 3, jring)):
        _bf16_guard(got[i], j, want32[i], what, close=None)
    np.testing.assert_allclose(got[2][..., 0].float().numpy(),
                               torch.as_tensor(np.array(js)).to(BF).float().numpy(), atol=0)
