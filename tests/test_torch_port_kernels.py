"""PyTorch port, frame-scan kernels: the plain PyTorch versions of the
port's CUDA kernels (what the wrappers run on CPU tensors) against the JAX
package's Pallas kernels in interpret mode, on the same weights, inputs and
state: a non-zero incoming state (entry scale > 0), per-lane flush for the
encoder, per-lane `valid` flipping mid-block for the decoder; and the
port's whole kernel-path block against JAX's (`ls_stream_block_fused`,
which calls the same Pallas kernels at the same shapes, so this file
compiles them once).

Tolerance: atol 2e-4, the JAX package's own fused-vs-scan tolerance
(tests/test_dec_frame_scan.py): float32, another summation order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import dec_frame_scan_pallas as JDFS
from fseend_tpu.kernels import enc_frame_scan_pallas as JEFS
from fseend_tpu.models import ls_eend as J
from fseend_tpu_torch.kernels import dec_frame_scan as DFS
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.models import ls_eend as T
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.LSEENDConfig(
    in_size=20, n_units=64, n_heads=4, enc_n_layers=2, dec_n_layers=2,
    conv_kernel_size=4, dec_dim_feedforward=48, conv_delay=2, max_nspks=3,
    dropout=0.0)
TCFG = T.LSEENDConfig(**{f.name: getattr(JCFG, f.name)
                         for f in dataclasses.fields(T.LSEENDConfig)
                         if hasattr(JCFG, f.name)})
B, K, C = 4, 12, 3
D, H, L = 64, 4, 2
ATOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    params, _ = J.init_ls_eend(jax.random.PRNGKey(3), JCFG)
    rng = np.random.default_rng(3)
    mstate = {"conv_bn": [{"mean": jnp.asarray(rng.normal(0, 0.2, D), jnp.float32),
                           "var": jnp.asarray(rng.uniform(0.5, 2.0, D), jnp.float32)}
                          for _ in range(L)]}
    model = CV.ls_params_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, mstate), TCFG, "cpu")
    return params, mstate, model, rng


def _state(rng, lanes):
    """A normalized retention state as a running model holds it: kv of unit
    scale, the same valid-step count on every head of a lane."""
    s = rng.integers(0, 9, lanes).astype(np.float32)
    kv = (rng.standard_normal((L, lanes, H, 16, 16)) * 0.2).astype(np.float32)
    return kv, np.broadcast_to(s[None, :, None], (L, lanes, H)).copy()


def test_enc_frame_scan_plain_matches_pallas(setup):
    params, mstate, model, rng = setup
    h0 = rng.standard_normal((B, K, D)).astype(np.float32)
    flush = np.zeros((B, K), np.float32)
    flush[0, 7:] = 1.0
    flush[2, 3:5] = 1.0
    kv, s = _state(rng, B)
    ring = (rng.standard_normal((L, B, 3, D)) * 0.5).astype(np.float32)
    enc_states = [{"ret": {"kv": jnp.asarray(kv[l]), "scale": jnp.asarray(s[l])},
                   "conv": jnp.asarray(ring[l])} for l in range(L)]

    with jax.default_matmul_precision("highest"):
        jw = JEFS.pack_enc_weights(params["enc"]["blocks"], mstate["conv_bn"], JCFG,
                                   jnp.float32)
        jkv, js, jring = JEFS.pack_enc_state(enc_states)
        jh, jkv_f, js_f, jring_f = JEFS.enc_frame_scan(
            jnp.asarray(h0.transpose(1, 2, 0)), jnp.asarray(flush.T[:, None, :]), *jw,
            jkv, js, jring, ffac=JCFG.ff_factor, interpret=True)
    want_state = JEFS.unpack_enc_state(jkv_f, js_f, jring_f, like=enc_states)

    tkv, ts, tring = torch.as_tensor(kv), torch.as_tensor(s), torch.as_tensor(ring)
    h = EFS.enc_frame_scan(torch.as_tensor(h0), torch.as_tensor(flush),
                           EFS.pack_enc_weights(model.enc.blocks), tkv, ts, tring,
                           ffac=TCFG.ff_factor)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh).transpose(2, 0, 1), atol=ATOL)
    for l in range(L):
        np.testing.assert_allclose(tkv[l].numpy(), np.asarray(want_state[l]["ret"]["kv"]),
                                   atol=ATOL)
        np.testing.assert_allclose(ts[l].numpy(), np.asarray(want_state[l]["ret"]["scale"]),
                                   atol=0)
        np.testing.assert_allclose(tring[l].numpy(), np.asarray(want_state[l]["conv"]),
                                   atol=ATOL)


def test_dec_frame_scan_plain_matches_pallas(setup):
    params, _, model, rng = setup
    emb = rng.standard_normal((B, K, D)).astype(np.float32)
    embn = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    embp = rng.standard_normal((B, K, D)).astype(np.float32)
    pe = rng.standard_normal((C, D)).astype(np.float32)
    # per-lane clocks straddling conv_delay: valid flips mid-block
    t0 = np.array([0, 1, JCFG.conv_delay, 9])
    valid = ((t0[:, None] + np.arange(K)[None]) >= JCFG.conv_delay).astype(np.float32)
    kv, s = _state(rng, B * C)
    s = np.repeat(s[:, ::C], C, axis=1)             # one clock per lane
    dec_states = [{"kv": jnp.asarray(kv[l]), "scale": jnp.asarray(s[l])} for l in range(L)]

    with jax.default_matmul_precision("highest"):
        jw = JDFS.pack_dec_weights(params["dec"], JCFG, jnp.float32)
        jkv, js = JDFS.pack_dec_state(dec_states, B, C)
        pe_t = jnp.repeat(jnp.asarray(pe.T), B, axis=1)       # (D, C*B) slot-major
        jlog, jkv_f, js_f = JDFS.dec_frame_scan(
            jnp.asarray(embp.transpose(1, 2, 0)), jnp.asarray(embn.transpose(1, 2, 0)),
            jnp.asarray(valid.T[:, None, :]), pe_t, *jw, jkv, js, C=C, interpret=True)
    want_state = JDFS.unpack_dec_state(jkv_f, js_f, B, C, H, like=dec_states)
    want_logits = np.asarray(jlog).reshape(K, C, B).transpose(2, 0, 1)

    tkv, ts = torch.as_tensor(kv), torch.as_tensor(s)
    logits = DFS.dec_frame_scan(torch.as_tensor(embp), torch.as_tensor(embn),
                                torch.as_tensor(valid), torch.as_tensor(pe),
                                DFS.pack_dec_weights(model.dec.layers), tkv, ts)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=ATOL)
    for l in range(L):
        np.testing.assert_allclose(tkv[l].numpy(), np.asarray(want_state[l]["kv"]),
                                   atol=ATOL)
        np.testing.assert_allclose(ts[l].numpy(), np.asarray(want_state[l]["scale"]),
                                   atol=0)


def test_bn_fold_matches_eval_batch_norm(setup):
    _, _, model, rng = setup
    w = EFS.pack_enc_weights(model.enc.blocks)
    bn = model.enc.blocks[1].conv.bn
    x = torch.as_tensor(rng.standard_normal((5, D)).astype(np.float32))
    want = (x - bn.running_mean) / torch.sqrt(bn.running_var + bn.eps) * bn.weight + bn.bias
    torch.testing.assert_close(x * w.bna[1] + w.bnb[1], want.detach(), atol=1e-6, rtol=0)


def test_wrappers_check_dtype_shape_and_layout(setup):
    _, _, model, rng = setup
    w = EFS.pack_enc_weights(model.enc.blocks)
    kv, s = (torch.as_tensor(a) for a in _state(rng, B))
    ring = torch.zeros(L, B, 3, D)
    h0, flush = torch.zeros(B, K, D), torch.zeros(B, K)
    with pytest.raises(ValueError, match="float32"):
        EFS.enc_frame_scan(h0.double(), flush, w, kv, s, ring, ffac=0.5)
    with pytest.raises(ValueError, match="shape"):
        EFS.enc_frame_scan(h0, flush[:, :3], w, kv, s, ring, ffac=0.5)
    with pytest.raises(ValueError, match="contiguous"):
        EFS.enc_frame_scan(h0.transpose(0, 1).contiguous().transpose(0, 1), flush, w,
                           kv, s, ring, ffac=0.5)
    dw = DFS.pack_dec_weights(model.dec.layers)
    dkv = torch.zeros(L, B * C, H, 16, 16)
    with pytest.raises(ValueError, match="float32"):
        DFS.dec_frame_scan(h0, h0, flush, torch.zeros(C, D), dw, dkv.double(),
                           torch.zeros(L, B * C, H))


def test_block_fused_matches_jax_fused_block(setup):
    """One K-frame block of the kernel path, per-lane flush and clocks
    straddling conv_delay: logits, valid and every state leaf."""
    params, mstate, model, rng = setup
    xs = rng.standard_normal((B, K, JCFG.in_size)).astype(np.float32)
    fl = np.zeros((K, B), bool)
    fl[8:, 0] = True
    fl[10:, 1] = True
    state0 = dict(J.ls_stream_init(JCFG, B, C),
                  t=jnp.asarray([0, 1, JCFG.conv_delay, 5], jnp.int32))
    with jax.default_matmul_precision("highest"):
        jst, (jlg, jv) = J.ls_stream_block_fused(params, state0, JCFG, mstate,
                                                 jnp.asarray(xs), jnp.asarray(fl), C,
                                                 interpret=True)
    st = CV.ls_state_from_jax(jax.tree.map(np.asarray, state0), "cpu")
    st, (lg, v) = T.ls_stream_block_fused(model, st, torch.as_tensor(xs),
                                          torch.as_tensor(fl), C)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
    got = jax.tree.leaves(CV.ls_state_to_numpy(st))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jst))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=ATOL)
