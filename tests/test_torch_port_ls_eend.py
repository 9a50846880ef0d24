"""PyTorch port, LS-EEND streaming model: `fseend_tpu_torch.models.ls_eend`
against the JAX package's `models.ls_eend` on the same weights (JAX init ->
`ls_params_from_jax`, non-trivial BatchNorm statistics), inputs and state.

Covers the plain per-frame path (`ls_stream_step` scanned over a block) and
the kernel path (`ls_stream_block_fused`, whose frame scans run their plain
versions on the CPU) against JAX's per-frame scan (against JAX's fused block
in test_torch_port_kernels.py), with per-lane flush, per-lane clocks
straddling conv_delay, a second block carrying the state, and every state
leaf compared.  Tolerance: atol 2e-4, as the JAX package's fused-vs-scan
tests (float32, another summation order, the unnormalized-KV form against
the normalized recurrence); 5e-4 after two blocks, as there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.models import ls_eend as J
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
T0 = np.array([0, 1, JCFG.conv_delay, 5], np.int32)   # per-lane clocks
ATOL, ATOL2 = 2e-4, 5e-4


def _leaves(state_np):
    return jax.tree.leaves(state_np)


def _assert_state(port_state, jax_state, atol):
    got, want = _leaves(CV.ls_state_to_numpy(port_state)), _leaves(
        jax.tree.map(np.asarray, jax_state))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=atol)


@pytest.fixture(scope="module")
def setup():
    params, _ = J.init_ls_eend(jax.random.PRNGKey(3), JCFG)
    rng = np.random.default_rng(7)
    mstate = {"conv_bn": [{"mean": jnp.asarray(rng.normal(0, 0.2, 64), jnp.float32),
                           "var": jnp.asarray(rng.uniform(0.5, 2.0, 64), jnp.float32)}
                          for _ in range(2)]}
    model = CV.ls_params_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, mstate), TCFG, "cpu")
    xs = [rng.standard_normal((B, K, JCFG.in_size)).astype(np.float32) for _ in range(2)]
    fl = np.zeros((K, B), bool)
    fl[8:, 0] = True                   # lane 0 drains early, lane 1 late, 2-3 never
    fl[10:, 1] = True

    def body(carry, inp):
        x_t, f = inp
        ns, out = J.ls_stream_step(params, carry, JCFG, mstate, x_t, C, flush=f)
        return ns, (out["logits"], out["valid"])

    scan = jax.jit(lambda st, x, f: jax.lax.scan(body, st, (x.swapaxes(0, 1), f)))
    state0 = dict(J.ls_stream_init(JCFG, B, C), t=jnp.asarray(T0))
    with jax.default_matmul_precision("highest"):
        st1, (lg1, v1) = scan(state0, jnp.asarray(xs[0]), jnp.asarray(fl))
        st2, (lg2, _) = scan(st1, jnp.asarray(xs[1]), jnp.zeros((K, B), bool))
    ref = {"state0": jax.tree.map(np.asarray, state0), "st1": st1, "lg1": lg1, "v1": v1,
           "st2": st2, "lg2": lg2}
    return params, mstate, model, xs, fl, ref


def test_stream_step_scan_matches_jax(setup):
    _, _, model, xs, fl, ref = setup
    st = CV.ls_state_from_jax(ref["state0"], "cpu")
    logits, valid = [], []
    for k in range(K):
        st, out = T.ls_stream_step(model, st, torch.as_tensor(xs[0][:, k]), C,
                                   torch.as_tensor(fl[k]))
        logits.append(out["logits"])
        valid.append(out["valid"])
    np.testing.assert_array_equal(torch.stack(valid).numpy(), np.asarray(ref["v1"]))
    np.testing.assert_allclose(torch.stack(logits).numpy(), np.asarray(ref["lg1"]), atol=ATOL)
    _assert_state(st, ref["st1"], ATOL)


def test_block_fused_matches_jax_scan(setup):
    """The kernel path over one block against JAX's per-frame scan (the
    oracle); against JAX's own fused block in test_torch_port_kernels.py."""
    _, _, model, xs, fl, ref = setup
    st = CV.ls_state_from_jax(ref["state0"], "cpu")
    st, (lg, v) = T.ls_stream_block_fused(model, st, torch.as_tensor(xs[0]),
                                          torch.as_tensor(fl), C)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref["v1"]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref["lg1"]), atol=ATOL)
    _assert_state(st, ref["st1"], ATOL)


def test_block_fused_second_block_carries_state(setup):
    """Entry scale > 0 on the second block: the kernels' normalize /
    unnormalize boundary."""
    _, _, model, xs, fl, ref = setup
    st = CV.ls_state_from_jax(ref["state0"], "cpu")
    packed = T.pack_weights(model)
    st, _ = T.ls_stream_block_fused(model, st, torch.as_tensor(xs[0]),
                                    torch.as_tensor(fl), C, packed)
    assert (st["dec_scale"] > 0).any() and (st["enc_scale"] > 0).any()
    st, (lg, _) = T.ls_stream_block_fused(model, st, torch.as_tensor(xs[1]),
                                          torch.zeros(K, B, dtype=torch.bool), C, packed)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref["lg2"]), atol=ATOL2)
    _assert_state(st, ref["st2"], ATOL2)


def test_whole_clip_scans_match_jax(setup):
    params, mstate, model, xs, _, _ = setup
    with jax.default_matmul_precision("highest"):
        jlg, jemb = J.ls_stream_scan(params, J.ls_stream_init(JCFG, B, C), JCFG, mstate,
                                     jnp.asarray(xs[1]), C)
    lg, emb = T.ls_stream_scan(model, T.ls_stream_init(TCFG, B, C, device="cpu"),
                               torch.as_tensor(xs[1]), C)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=ATOL)
    fused = T.ls_stream_scan_fused(model, T.ls_stream_init(TCFG, B, C, device="cpu"),
                                   torch.as_tensor(xs[1]), C)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jlg), atol=ATOL)


def test_state_layout_roundtrip(setup):
    *_, ref = setup
    jstate = jax.tree.map(np.asarray, ref["st1"])
    port = CV.ls_state_from_jax(jstate, "cpu")
    for g, w in zip(_leaves(CV.ls_state_to_numpy(port)), _leaves(jstate)):
        np.testing.assert_array_equal(g, w)
    fresh = T.ls_stream_init(TCFG, B, C, device="cpu")
    for g, w in zip(_leaves(CV.ls_state_to_numpy(fresh)),
                    _leaves(jax.tree.map(np.asarray, J.ls_stream_init(JCFG, B, C)))):
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any()


def test_module_names_follow_the_jax_tree(setup):
    params, mstate, model, *_ = setup
    sd = model.state_dict()
    for name in ("enc.proj.weight", "enc.blocks.1.ff1.linear1.weight",
                 "enc.blocks.0.conv.bn.running_var", "cnn.bias",
                 "dec.layers.1.time_ret.q_proj.weight", "dec.layers.0.spk_attn.in_proj.bias"):
        assert name in sd, name
    np.testing.assert_array_equal(sd["enc.blocks.1.ff1.linear1.weight"].numpy(),
                                  np.asarray(params["enc"]["blocks"][1]["ff1"]["linear1"]["kernel"]).T)
    np.testing.assert_array_equal(sd["enc.blocks.0.conv.bn.running_var"].numpy(),
                                  np.asarray(mstate["conv_bn"][0]["var"]))
    with pytest.raises(ValueError, match="does not fit"):
        bad = jax.tree.map(np.asarray, params)
        bad["cnn"]["bias"] = np.zeros(3, np.float32)
        CV.ls_params_from_jax(bad, jax.tree.map(np.asarray, mstate), TCFG, "cpu")


def test_init_is_seeded_and_entry_points_need_a_device():
    a = T.init_ls_eend(TCFG, torch.Generator().manual_seed(1), device="cpu")
    b = T.init_ls_eend(TCFG, torch.Generator().manual_seed(1), device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    assert torch.isfinite(a.enc.proj.weight).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.init_ls_eend(TCFG, torch.Generator().manual_seed(1))
