"""PyTorch port, the decoder frame scan computed layer by layer over the
block (the algorithm of `fseend_tpu_torch/kernels/csrc/dec_frame_scan.cu`):
a plain PyTorch mirror of it, kept in this file, against the frame-by-frame
plain version `dec_frame_scan_plain` and against the JAX package's Pallas
kernel `dec_frame_scan` in interpret mode, on the same weights, inputs and
state.

The mirror runs each fusion layer over all (lane, slot, frame) rows at once;
its time retention is the exact recurrent form in chunks that carry the
state: per (lane, slot, head), with gates g_j = valid[b, j] and the state
read as KV0 = kv sqrt(s0),
  out_k = (q_k KV + sum_{j<k in chunk} g_j (q_k . k~_j) v_j + (q_k . k~_k) v_k)
          * rsqrt(s0 + sum_{j<k} g_j + 1),
then KV += sum_j g_j v_j k~_j^T per chunk and kv = KV rsqrt(max(s, 1)) at
the end.  Cases: K 1, 7 and 33 at chunk 16 (one chunk, one partial chunk,
three chunks), frames invalid in the middle of the block, lanes at
different incoming counts s0 (0 included).

Tolerance: 1e-5 against the plain version (the same float32 arithmetic in
another order), 2e-4 against the Pallas kernel (the port's tolerance
against the JAX package; float32, another summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import dec_frame_scan_pallas as JDFS
from fseend_tpu_torch.kernels import dec_frame_scan as DFS
from fseend_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)
B, C, D, H, F, L = 4, 3, 64, 4, 48, 2
DK = D // H
CHUNK = 16
KS = (1, 7, 33)
ATOL_PLAIN, ATOL_JAX = 1e-5, 2e-4


def _weights(rng) -> DFS.DecWeights:
    """Random fusion-layer weights in the port's (in, out) layouts."""
    def r(*shape, scale):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32)

    return DFS.DecWeights(
        w_qkvg=r(L, D, 4 * D, scale=D ** -0.5), b_qkvg=r(L, 4 * D, scale=0.1),
        w_ro=r(L, D, D, scale=D ** -0.5), b_ro=r(L, D, scale=0.1),
        w_mi=r(L, D, 3 * D, scale=D ** -0.5), b_mi=r(L, 3 * D, scale=0.1),
        w_mo=r(L, D, D, scale=D ** -0.5), b_mo=r(L, D, scale=0.1),
        w_f1=r(L, D, F, scale=D ** -0.5), b_f1=r(L, F, scale=0.1),
        w_f2=r(L, F, D, scale=F ** -0.5), b_f2=r(L, D, scale=0.1),
        ln_s=1.0 + r(L, 3, D, scale=0.1), ln_b=r(L, 3, D, scale=0.1))


def _case(K: int, seed: int):
    """Inputs of one call: lane 0 valid throughout, lane 1 invalid in the
    middle of the block, lane 2 before warm-up for its first frames, lane 3
    never valid; incoming counts 0, 3, 40, 7 per lane (every slot and head
    of a lane shares its count, as a running model's state does)."""
    rng = np.random.default_rng(seed)
    embp = torch.as_tensor(rng.standard_normal((B, K, D)), dtype=torch.float32)
    embn = torch.as_tensor(rng.standard_normal((B, K, D)), dtype=torch.float32)
    embn = embn / embn.norm(dim=-1, keepdim=True)
    valid = np.ones((B, K), np.float32)
    valid[1, K // 3:2 * K // 3 + 1] = 0.0
    valid[2, :min(3, K - 1)] = 0.0
    valid[3] = 0.0
    pe = torch.as_tensor(rng.standard_normal((C, D)) * 0.5, dtype=torch.float32)
    s0 = np.repeat(np.array([0.0, 3.0, 40.0, 7.0], np.float32), C)
    s = torch.as_tensor(np.broadcast_to(s0[None, :, None], (L, B * C, H)).copy())
    kv = torch.as_tensor(rng.standard_normal((L, B * C, H, DK, DK)) * 0.2,
                         dtype=torch.float32)
    return embp, embn, torch.as_tensor(valid), pe, kv, s


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


@torch.no_grad()
def dec_block_mirror(embp, embn, valid, pe, w, kv, s, chunk=CHUNK):
    """The layer-major decoder frame scan; the same in-place contract as
    `dec_frame_scan`.  Rows are (lane, slot, frame), slot-major."""
    Bn, K, Dn = embp.shape
    Cn = pe.shape[0]
    Ln, BC, Hn, dv, dk = kv.shape
    x = (embp[:, None] + pe[None, :, None]).reshape(BC * K, Dn)
    gates = valid.repeat_interleave(Cn, dim=0)[:, None].expand(BC, Hn, K).reshape(BC * Hn, K)

    def heads(t, d):  # (BC*K, H*d) -> (BC*H, K, d)
        return t.reshape(BC, K, Hn, d).permute(0, 2, 1, 3).reshape(BC * Hn, K, d)

    def ln(t, l, i):
        return tnn.layer_norm(t, w.ln_s[l, i], w.ln_b[l, i])

    for l in range(Ln):
        qkvg = x @ w.w_qkvg[l] + w.b_qkvg[l]
        out, kv_l, s_l = block_retention(
            heads(qkvg[:, :Dn], dk), heads(qkvg[:, Dn:2 * Dn] * dk ** -0.5, dk),
            heads(qkvg[:, 2 * Dn:3 * Dn], dv), gates, kv[l].reshape(BC * Hn, dv, dk),
            s[l, :, 0].repeat_interleave(Hn), chunk)
        kv[l] = kv_l.reshape(BC, Hn, dv, dk)
        s[l] = s_l.reshape(BC, Hn)
        out = out.reshape(BC, Hn, K, dv).permute(0, 2, 1, 3)
        out = tnn.layer_norm(out, eps=1e-6).reshape(BC * K, Dn)
        x = ln(x + (torch.nn.functional.silu(qkvg[:, 3 * Dn:]) * out) @ w.w_ro[l] + w.b_ro[l],
               l, 0)
        # attention across the C slots of each (lane, frame)
        qkv = (x @ w.w_mi[l] + w.b_mi[l]).reshape(Bn, Cn, K, 3, Hn, dk)
        qh, kh, vh = (qkv[:, :, :, i].permute(0, 2, 3, 1, 4) for i in range(3))  # (B, K, H, C, dk)
        p = torch.softmax(qh @ kh.transpose(-1, -2) / dk ** 0.5, dim=-1)
        att = (p @ vh).permute(0, 3, 1, 2, 4).reshape(BC * K, Dn)
        x = ln(x + att @ w.w_mo[l] + w.b_mo[l], l, 1)
        x = ln(x + torch.relu(x @ w.w_f1[l] + w.b_f1[l]) @ w.w_f2[l] + w.b_f2[l], l, 2)
    attr = x * torch.rsqrt(x.square().sum(-1, keepdim=True))
    return (attr.reshape(Bn, Cn, K, Dn) * embn[:, None]).sum(-1).transpose(1, 2).contiguous()


def _jax_call(embp, embn, valid, pe, w, kv, s):
    """The Pallas kernel in interpret mode on the same operands, in its
    layouts; returns (logits (B, K, C), kv (L, B*C, H, dv, dk), s (L, B*C))."""
    K = embp.shape[1]
    f = lambda t: jnp.asarray(t.numpy())                               # noqa: E731
    T2 = lambda t: jnp.asarray(t.transpose(1, 2).numpy())              # noqa: E731
    col = lambda t: jnp.asarray(t.numpy()[..., None])                  # noqa: E731
    jw = (T2(w.w_qkvg), col(w.b_qkvg), T2(w.w_ro), col(w.b_ro), T2(w.w_mi), col(w.b_mi),
          T2(w.w_mo), col(w.b_mo), T2(w.w_f1), col(w.b_f1), T2(w.w_f2), col(w.b_f2),
          col(w.ln_s), col(w.ln_b))
    jkv, js = JDFS.pack_dec_state([{"kv": f(kv[l]), "scale": f(s[l])} for l in range(L)], B, C)
    pe_t = jnp.asarray(np.repeat(pe.numpy().T, B, axis=1))             # (D, C*B) slot-major
    with jax.default_matmul_precision("highest"):
        lg, kv_f, s_f = JDFS.dec_frame_scan(
            f(embp.permute(1, 2, 0)), f(embn.permute(1, 2, 0)), f(valid.T[:, None, :]), pe_t,
            *jw, jkv, js, C=C, interpret=True)
    st = JDFS.unpack_dec_state(kv_f, s_f, B, C, H, like=[{"kv": kv[0].numpy(),
                                                           "scale": s[0].numpy()}] * L)
    logits = np.asarray(lg).reshape(K, C, B).transpose(2, 0, 1)
    return (logits, np.stack([np.asarray(x["kv"]) for x in st]),
            np.stack([np.asarray(x["scale"])[:, 0] for x in st]))


@pytest.fixture(scope="module")
def cases():
    """Per K: the inputs, and the Pallas kernel's result on them (each
    interpretation costs seconds, so each shape is interpreted once)."""
    w = _weights(np.random.default_rng(0))
    out = {}
    for K in KS:
        args = _case(K, seed=K)
        out[K] = (args, _jax_call(*args[:4], w, *args[4:]))
    return w, out


def _run(fn, args, w, **kw):
    embp, embn, valid, pe, kv, s = (t.clone() for t in args)
    logits = fn(embp, embn, valid, pe, w, kv, s, **kw)
    return logits, kv, s


@pytest.mark.parametrize("K", KS)
def test_block_retention_matches_frame_by_frame_recurrence(K):
    """The retention alone: chunks of 16 against one frame at a time."""
    rng = np.random.default_rng(K)
    N = 6
    q, k, v = (torch.as_tensor(rng.standard_normal((N, K, DK)), dtype=torch.float32)
               for _ in range(3))
    g = torch.as_tensor(rng.integers(0, 2, (N, K)), dtype=torch.float32)
    kv = torch.as_tensor(rng.standard_normal((N, DK, DK)) * 0.2, dtype=torch.float32)
    s0 = torch.as_tensor([0.0, 1.0, 2.0, 5.0, 30.0, 300.0])
    got, kv_f, s_f = block_retention(q, k, v, g, kv, s0, CHUNK)
    KV, s = kv * torch.sqrt(s0)[:, None, None], s0.clone()
    for t in range(K):
        r0 = torch.einsum("nk,nvk->nv", q[:, t], KV)
        qk = (q[:, t] * k[:, t]).sum(-1, keepdim=True)
        want = (r0 + qk * v[:, t]) * torch.rsqrt(s + 1.0)[:, None]
        torch.testing.assert_close(got[:, t], want, atol=ATOL_PLAIN, rtol=0)
        KV = KV + v[:, t, :, None] * (k[:, t] * g[:, t, None])[:, None, :]
        s = s + g[:, t]
    torch.testing.assert_close(s_f, s, atol=0, rtol=0)
    torch.testing.assert_close(kv_f, KV * torch.rsqrt(s.clamp(min=1.0))[:, None, None],
                               atol=ATOL_PLAIN, rtol=0)


@pytest.mark.parametrize("K", KS)
def test_layer_major_block_matches_plain_frame_scan(cases, K):
    w, out = cases
    args, _ = out[K]
    got = _run(dec_block_mirror, args, w)
    want = _run(DFS.dec_frame_scan_plain, args, w)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=ATOL_PLAIN, rtol=0)


@pytest.mark.parametrize("K", KS)
def test_layer_major_block_matches_pallas_kernel(cases, K):
    w, out = cases
    args, (jlog, jkv, js) = out[K]
    logits, kv, s = _run(dec_block_mirror, args, w)
    np.testing.assert_allclose(logits.numpy(), jlog, atol=ATOL_JAX)
    np.testing.assert_allclose(kv.numpy(), jkv, atol=ATOL_JAX)
    np.testing.assert_allclose(s[..., 0].numpy(), js, atol=0)


def test_two_calls_carry_the_state():
    """Two consecutive 7-frame blocks against one 14-frame block: the state
    written back normalized is read again as it was left."""
    w = _weights(np.random.default_rng(1))
    args = _case(14, seed=3)
    whole = _run(dec_block_mirror, args, w)
    embp, embn, valid, pe, kv, s = (t.clone() for t in args)
    first = dec_block_mirror(embp[:, :7].contiguous(), embn[:, :7].contiguous(),
                             valid[:, :7].contiguous(), pe, w, kv, s)
    second = dec_block_mirror(embp[:, 7:].contiguous(), embn[:, 7:].contiguous(),
                              valid[:, 7:].contiguous(), pe, w, kv, s)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole[0],
                               atol=ATOL_PLAIN, rtol=0)
    torch.testing.assert_close(kv, whole[1], atol=ATOL_PLAIN, rtol=0)
    torch.testing.assert_close(s, whole[2], atol=0, rtol=0)
