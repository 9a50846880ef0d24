"""PyTorch port, frame-scan kernels: the plain PyTorch versions of the
port's CUDA kernels (what the wrappers run on CPU tensors) against the JAX
package's Pallas kernels in interpret mode, on the same weights, inputs and
state: a non-zero incoming state (entry scale > 0), per-lane flush for the
encoder, per-lane `valid` flipping mid-block for the decoder; and the
port's whole kernel-path block against JAX's (`ls_stream_block_fused`,
whose two Pallas kernel calls, recorded, are the references of the
kernel tests, so this file interprets each kernel once).

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


def _jax_params(seed: int):
    """A JAX parameter pytree of JCFG's structure (static metadata included,
    from `jax.eval_shape` of the JAX init) holding the port initializer's
    weights for `seed`: random weights on both sides without the JAX
    init's eager random ops, which cost seconds per config."""
    model = T.init_ls_eend(TCFG, torch.Generator().manual_seed(seed), device="cpu")
    tree, _ = CV.ls_params_to_jax(model)
    shapes, _ = jax.eval_shape(lambda k: J.init_ls_eend(k, JCFG), jax.random.PRNGKey(0))

    def leaf(path, _):
        node = tree
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        return jnp.asarray(node)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def setup():
    params = _jax_params(3)
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


@pytest.fixture(scope="module")
def jax_block(setup):
    """One K-frame block of JAX's kernel path (`ls_stream_block_fused`, both
    Pallas frame scans in interpret mode) from a non-zero incoming state,
    lanes flushing part-way (one with a gap) and clocks straddling
    conv_delay, so that `valid` flips mid-block.  The arguments and results
    of its two kernel calls are recorded: each Pallas kernel is interpreted
    once for this file (the interpretation costs seconds per call shape)."""
    params, mstate, _, rng = setup
    xs = rng.standard_normal((B, K, JCFG.in_size)).astype(np.float32)
    fl = np.zeros((K, B), bool)
    fl[7:, 0] = True
    fl[10:, 1] = True
    fl[3:5, 2] = True
    kv, s = _state(rng, B)
    dkv, ds = _state(rng, B * C)
    ds = np.repeat(ds[:, ::C], C, axis=1)             # one clock per lane
    ring = (rng.standard_normal((L, B, 3, D)) * 0.5).astype(np.float32)
    state0 = {
        "t": np.array([0, 1, JCFG.conv_delay, 9], np.int32),
        "enc": [{"ret": {"kv": kv[l], "scale": s[l]}, "conv": ring[l]} for l in range(L)],
        "cnn_buf": (rng.standard_normal((B, JCFG.lookahead_kernel, D)) * 0.5).astype(np.float32),
        "dec": [{"kv": dkv[l], "scale": ds[l]} for l in range(L)],
    }
    calls = {}

    def record(mod, name):
        orig = getattr(mod, name)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            calls[name] = (args, kw, out)
            return out
        return orig, wrapped

    saved = [(mod, name, *record(mod, name)) for mod, name in
             ((JEFS, "enc_frame_scan"), (JDFS, "dec_frame_scan"))]
    try:
        for mod, name, _, wrapped in saved:
            setattr(mod, name, wrapped)
        with jax.default_matmul_precision("highest"):
            jst, (jlg, jv) = J.ls_stream_block_fused(
                params, jax.tree.map(jnp.asarray, state0), JCFG, mstate, jnp.asarray(xs),
                jnp.asarray(fl), C, interpret=True)
    finally:
        for mod, name, orig, _ in saved:
            setattr(mod, name, orig)
    return xs, fl, state0, (jst, jlg, jv), calls


def test_enc_frame_scan_plain_matches_pallas(setup, jax_block):
    _, _, model, _ = setup
    _, _, state0, _, calls = jax_block
    args, kw, (jh, jkv_f, js_f, jring_f) = calls["enc_frame_scan"]
    h0 = np.ascontiguousarray(np.asarray(args[0]).transpose(2, 0, 1))   # (B, K, D)
    flush = np.ascontiguousarray(np.asarray(args[1])[:, 0, :].T)        # (B, K)
    assert flush.any() and not flush.all()
    want_state = JEFS.unpack_enc_state(jkv_f, js_f, jring_f, like=state0["enc"])

    st = CV.ls_state_from_jax(state0, "cpu")
    tkv, ts, tring = st["enc_kv"], st["enc_scale"], st["enc_conv"]
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


def test_dec_frame_scan_plain_matches_pallas(setup, jax_block):
    _, _, model, _ = setup
    _, _, state0, _, calls = jax_block
    args, kw, (jlog, jkv_f, js_f) = calls["dec_frame_scan"]
    assert kw["groups"] == 1
    embp, embn = (np.ascontiguousarray(np.asarray(a).transpose(2, 0, 1))
                  for a in args[:2])                                      # (B, K, D)
    valid = np.ascontiguousarray(np.asarray(args[2])[:, 0, :].T)         # (B, K)
    assert valid.any() and not valid.all()
    pe = np.asarray(args[3])[:, ::B].T                   # (D, C*B) slot-major -> (C, D)
    want_state = JDFS.unpack_dec_state(jkv_f, js_f, B, C, H, like=state0["dec"])
    want_logits = np.asarray(jlog).reshape(K, C, B).transpose(2, 0, 1)

    st = CV.ls_state_from_jax(state0, "cpu")
    tkv, ts = st["dec_kv"], st["dec_scale"]
    logits = DFS.dec_frame_scan(torch.as_tensor(embp), torch.as_tensor(embn),
                                torch.as_tensor(valid), torch.as_tensor(np.ascontiguousarray(pe)),
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


def test_block_fused_matches_jax_fused_block(setup, jax_block):
    """The port's whole kernel-path block against JAX's: logits, valid and
    every state leaf."""
    _, _, model, _ = setup
    xs, fl, state0, (jst, jlg, jv), _ = jax_block
    st = CV.ls_state_from_jax(state0, "cpu")
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
