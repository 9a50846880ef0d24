"""PyTorch port, the bf16 chunkwise retention core at head dims 64 as
`fseend_tpu_torch/kernels/csrc/ret16.cuh` computes it (B5 `chunk_retention`
and the core of B4 `retention_layer`, built with FS_BF16): a torch mirror
of its order of work, on the CPU, against `chunk_retention_plain` in bf16
and against the JAX package's Pallas kernel
`retention_pallas._forward_stateful` in interpret mode on the same bf16
values.

The mirror, per chunk in 128-query blocks over 64-frame k/v tiles taken 16
frames at a time: the masked scores q k^T from the bf16 values; S V with
S as three bf16 terms hi + mid + lo (small first); the cross read q KV_n
with KV_n as three terms (one at chunk 0, where it is the bf16 state); the
new state at T = L from U = (last_row K)^T V with last_row K as three
terms, summed over the tiles the chunk's last query block reads; at T > L
each chunk's summary U_m on the same terms and the state scanned over
them in chunk order.

Tolerance, the rounding rule of chip_smoke.py's `bf16_guard` (close 0.5):
mean |mirror - bf16 reference| <= 0.5 mean |bf16 reference - float32|,
where the float32 reference is `chunk_retention_plain` in float32 on the
same bf16 values and the bf16 reference is the plain version in bf16 or
the Pallas kernel in bf16; with the drift rule (max |mirror - float32| <=
3 max |bf16 - float32| + 1e-3) and not a float32 path (mean |mirror -
float32| >= 0.5 mean |bf16 - float32|).  The mirror reads about 0.001 of
that distance from the plain version; the same order of work with S, KV_n
and last_row K each in one bf16 term reads 0.2 to 0.5.

Cases: 4 rows (gamma 1, 1, 0.97, 0.9), dk = dv = 64, chunks of 75 (a
partial second tile) and 128 frames, two chunks a call from a carried
state, and one chunk (the state from the last query block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import retention_pallas as JKP
from fseend_tpu_torch.kernels import chunk_retention as CR

torch.set_num_threads(1)
BF = torch.bfloat16
KT, QB = 64, 128             # ret16.cuh: kT (frames of a k/v tile), kQB (queries of a block)
SHARE = 0.5
NO_EXCESS = {"xla_allow_excess_precision": False}
GAMMAS = (1.0, 1.0, 0.97, 0.9)


def _rnd(x):
    return x.to(BF).float()


def _split3(x):
    """x as three bf16 terms, hi + mid + lo (d16::split3), small first."""
    hi = _rnd(x)
    mid = _rnd(x - hi)
    return _rnd(x - hi - mid), mid, hi


def _mirror16(gammas, q, k, v, kv0, s0, L):
    """ret16.cuh's order of work in float32 on bf16 values; returns (out,
    kv, scale) rounded to bf16."""
    q, k, v, kv0, s0 = (t.float() for t in (q, k, v, kv0, s0))
    BH, T, dk = q.shape
    N, nt, nqb = T // L, -(-L // KT), -(-L // QB)
    P = max(nt * KT, nqb * QB)
    lg = torch.log(gammas).reshape(BH, 1)
    i = torch.arange(P, dtype=torch.float32)
    sv = torch.sqrt(torch.cumsum(torch.exp(lg * i), dim=1))                # (BH, P)
    svl = torch.sqrt(torch.exp(lg * i[:L]).sum(1, keepdim=True))
    idec = torch.where(i < L, torch.exp(lg * (i + 1)) * svl / sv, 0.0)
    lr = torch.where(i < L, torch.exp(lg * (L - 1 - i)) / svl, 0.0)
    cd = torch.exp(lg * float(L))[:, :, None]

    def chunk(t, n):                                 # (BH, P, d), zero past L
        return torch.nn.functional.pad(t[:, n * L:(n + 1) * L], (0, 0, 0, P - L))

    def summary(kc, vc):                             # U over the chunk, 16 frames a step
        u = kc.new_zeros(BH, dk, vc.shape[-1])
        for f0 in range(0, nt * KT, 16):
            if f0 >= L:
                break
            for term in _split3(kc[:, f0:f0 + 16] * lr[:, f0:f0 + 16, None]):
                u = u + term.transpose(1, 2) @ vc[:, f0:f0 + 16]
        return u

    def new_state(kv, u):
        kv = kv * cd + u
        return kv, kv.abs().sum(1).amax(1, keepdim=True).clamp(min=1.0)

    states, kv, c = [], kv0, s0.reshape(BH, 1)
    if N > 1:                                        # sum16, then the scan
        for m in range(N):
            states.append((kv, c))
            kv, c = new_state(kv, summary(chunk(k, m), chunk(v, m)))
    else:
        states.append((kv, c))
    outs = []
    for n, (kvn, cn) in enumerate(states):
        qc, kc, vc = chunk(q, n), chunk(k, n), chunk(v, n)
        out = qc.new_zeros(BH, P, v.shape[-1])
        for qb in range(nqb):
            rows = slice(qb * QB, (qb + 1) * QB)
            ii = i[rows]
            terms = (kvn,) if n == 0 else _split3(kvn)
            o = sum(qc[:, rows] @ t for t in terms) * idec[:, rows, None]
            rowabs = qc.new_zeros(BH, QB)
            jlast = min(nt - 1, (qb * QB + QB - 1) // KT)
            for f0 in range(0, (jlast + 1) * KT, 16):
                j = i[f0:f0 + 16]
                delta = ii[:, None] - j[None, :]
                mask = torch.where(delta >= 0, torch.exp(lg[:, :, None] * delta.clamp(min=0)),
                                   0.0) / sv[:, rows, None]
                s = (qc[:, rows] @ kc[:, f0:f0 + 16].transpose(1, 2)) * mask
                rowabs = rowabs + s.abs().sum(-1)
                for term in _split3(s):
                    o = o + term @ vc[:, f0:f0 + 16]
            out[:, rows] = o / torch.maximum(rowabs.clamp(min=1.0), cn)[..., None]
        outs.append(out[:, :L])
        if N == 1:                                   # the last query block's tiles: every tile
            kv, c = new_state(kvn, summary(kc, vc))
    return (torch.cat(outs, 1).to(BF), kv.to(BF), c.reshape(BH, 1, 1).to(BF))


def _inputs(L, N, seed):
    rng = np.random.default_rng(seed)
    BH, d = len(GAMMAS), 64

    def randn(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).to(BF)

    kv0 = randn(BH, d, d, scale=0.5)
    s0 = torch.as_tensor(rng.uniform(1.0, 4.0, (BH, 1, 1)), dtype=torch.float32).to(BF)
    return (torch.tensor(GAMMAS), randn(BH, N * L, d), randn(BH, N * L, d, scale=d ** -0.5),
            randn(BH, N * L, d), kv0, s0)


def _rule(got, want16, want32, what):
    g, w16, w32 = (t.float() for t in (got, want16, want32))
    mean = lambda a, b: float((a - b).abs().mean())          # noqa: E731
    assert float((g - w32).abs().max()) <= 3 * float((w16 - w32).abs().max()) + 1e-3, what
    assert mean(g, w32) >= 0.5 * mean(w16, w32), what
    assert mean(g, w16) <= SHARE * mean(w16, w32), (what, mean(g, w16), mean(w16, w32))


@pytest.fixture(scope="module")
def pallas16():
    """The Pallas kernel in bf16, interpret mode, two chunks of 75 and 128."""
    out = {}
    for L in (75, 128):
        ins = _inputs(L, 2, L)
        fn = jax.jit(lambda *a, L=L: JKP._forward_stateful(*a, L, interpret=True),
                     compiler_options=NO_EXCESS)
        got = fn(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == BF
                                                          else jnp.float32) for t in ins))
        out[L] = ins, [torch.tensor(np.asarray(a.astype(jnp.float32))) for a in got]
    return out


@pytest.mark.parametrize("L", [75, 128])
def test_ret16_order_of_work_matches_plain_and_the_jax_kernel(pallas16, L):
    """Two chunks from a carried state: the summaries, the scan and the
    cross read of KV_1 as three terms; out and the new state against the
    bf16 plain version and the Pallas kernel in bf16."""
    ins, jax16 = pallas16[L]
    got = _mirror16(*ins, L)
    want16 = CR.chunk_retention_plain(*ins, L)
    want32 = CR.chunk_retention_plain(*(t.float() for t in ins), L)
    assert float(want32[2].max()) > 1.0              # the carried scale is in play
    for what, g, p16, j16, w32 in zip(("out", "kv", "scale"), got, want16, jax16, want32):
        assert g.dtype == BF and g.shape == p16.shape, what
        _rule(g, p16, w32, f"{what} vs plain")
        if what != "scale":                          # both round the same float32 scale
            _rule(g, j16, w32, f"{what} vs Pallas")


@pytest.mark.parametrize("L", [75, 128])
def test_ret16_one_chunk_state_from_the_last_query_block(L):
    """T = L: the output and the new state from one pass (the last query
    block sums U over every tile of the chunk) against the plain version."""
    ins = _inputs(L, 1, L + 1)
    got = _mirror16(*ins, L)
    want16 = CR.chunk_retention_plain(*ins, L)
    want32 = CR.chunk_retention_plain(*(t.float() for t in ins), L)
    for what, g, p16, w32 in zip(("out", "kv", "scale"), got, want16, want32):
        _rule(g, p16, w32, what)
