"""PyTorch port, LS-EEND blockwise streaming: `ls_blockstream_step/run` and
`BlockStreamingServer` of the port against the JAX package's, block by block
on the same weights, inputs and carried state (converted both ways by
`utils/convert.py`), through each chunkwise route; on the CPU the "core" and
"fused" routes run their kernels' plain versions.

Tolerance: atol 2e-4 (float32, another summation order; the state is
carried over four blocks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.models import ls_eend as J
from fseend_tpu.serving import runtime as JRT
from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.models import ls_eend as T
from fseend_tpu_torch.serving import runtime as RT
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.LSEENDConfig(
    in_size=20, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=2, chunk_size=8,
    conv_kernel_size=4, dec_dim_feedforward=48, conv_delay=2, max_nspks=3, dropout=0.0)
TCFG = T.LSEENDConfig(**{f.name: getattr(JCFG, f.name)
                         for f in dataclasses.fields(T.LSEENDConfig)
                         if hasattr(JCFG, f.name)})
B, K, C = 3, 8, 3
ATOL = 2e-4
ROUTES = ("plain", "core", "fused")


def _leaves(state_np):
    return jax.tree.leaves(state_np)


def _assert_state(port_state, jax_state):
    got = _leaves(CV.ls_blockstate_to_numpy(port_state))
    want = _leaves(jax.tree.map(np.asarray, jax_state))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=ATOL)


def _model_with(model, kernel):
    return T.with_cfg(model, dataclasses.replace(model.cfg, kernel=kernel))


@pytest.fixture(scope="module")
def setup():
    params, _ = J.init_ls_eend(jax.random.PRNGKey(3), JCFG)
    rng = np.random.default_rng(17)
    mstate = {"conv_bn": [{"mean": jnp.asarray(rng.normal(0, 0.2, 32), jnp.float32),
                           "var": jnp.asarray(rng.uniform(0.5, 2.0, 32), jnp.float32)}
                          for _ in range(2)]}
    model = CV.ls_params_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, mstate), TCFG, "cpu")
    xs = (rng.standard_normal((5, B, K, JCFG.in_size)) * 2).astype(np.float32)
    return params, mstate, model, xs


def _jax_reset_lane(state, fresh, lane):
    """Lane `lane` of a JAX blockwise state back to fresh (numpy leaves)."""
    def leaf(cur, z):
        cur = np.array(cur)
        per = cur.shape[0] // B                   # 1, or C for the decoder rows
        cur[lane * per:(lane + 1) * per] = np.asarray(z)[lane * per:(lane + 1) * per]
        return cur
    return jax.tree.map(leaf, state, fresh)


@pytest.mark.parametrize("kernel", ROUTES)
def test_blockstream_step_matches_jax_block_by_block(setup, kernel):
    """Five steps: two plain blocks, a reset of lane 1 (its next block is
    gated as a warm-up block again), a block with an h_mask tail, and an
    enc_bypass flush.  After every step the logits and every state leaf; the
    port continues from JAX's state converted across, so a drift cannot
    hide."""
    params, mstate, model, xs = setup
    model = _model_with(model, kernel)
    packed = T.pack_block_weights(model)
    jstate = J.ls_blockstream_init(JCFG, B, C, K)
    fresh = jax.tree.map(np.asarray, jstate)
    state = T.ls_blockstream_init(TCFG, B, C, K, device="cpu")
    _assert_state(state, jstate)
    h_mask = np.arange(K) < 5
    steps = [dict(), dict(), dict(reset=1), dict(h_mask=h_mask), dict(enc_bypass=True)]
    for i, step in enumerate(steps):
        if "reset" in step:
            jstate = _jax_reset_lane(jax.tree.map(np.asarray, jstate), fresh, step["reset"])
        given = CV.ls_blockstate_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
        before = {k: v.clone() for k, v in given.items()}
        jkw = {"enc_bypass": step.get("enc_bypass", False),
               "h_mask": jnp.asarray(step["h_mask"]) if "h_mask" in step else None}
        with jax.default_matmul_precision("highest"):
            jstate, want = J.ls_blockstream_step(params, jstate, JCFG, mstate,
                                                 jnp.asarray(xs[i]), C, **jkw)
        tkw = {"enc_bypass": step.get("enc_bypass", False),
               "h_mask": torch.as_tensor(step["h_mask"]) if "h_mask" in step else None}
        state, got = T.ls_blockstream_step(model, given, torch.as_tensor(xs[i]), C,
                                           packed=packed, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"step {i}")
        _assert_state(state, jstate)
        for key, t in before.items():              # the incoming state is not touched
            assert torch.equal(given[key], t), key
    assert state["m"].tolist() == [5, 3, 5]


def test_blockstate_roundtrip_and_layout(setup):
    jstate = jax.tree.map(np.asarray, J.ls_blockstream_init(JCFG, B, C, K))
    port = CV.ls_blockstate_from_jax(jstate, "cpu")
    assert port["enc_kv"].shape == (2, B, 4, 8, 8) and port["dec_scale"].shape == (2, B * C, 4, 1, 1)
    for g, w in zip(_leaves(CV.ls_blockstate_to_numpy(port)), _leaves(jstate)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="conv_delay"):
        T.ls_blockstream_init(TCFG, B, C, block=1, device="cpu")


@pytest.mark.parametrize("kernel", ROUTES)
def test_blockstream_run_equals_chunkwise_batch_pass(setup, kernel):
    """ls_blockstream_run == the port's own ls_forward(time_mode="chunkwise")
    at chunk_size = block, with ragged lengths and T not a block multiple;
    and JAX's ls_blockstream_run on the full-length input."""
    params, mstate, model, xs = setup
    model = _model_with(model, kernel)
    x = torch.as_tensor(xs.transpose(1, 0, 2, 3).reshape(B, 5 * K, -1)[:, :29])
    lens = torch.tensor([29, 11, 20])
    batch = T.ls_forward(model, x, lens, C)
    run = T.ls_blockstream_run(model, x, C, K, lens)
    for b in range(B):
        np.testing.assert_allclose(run[b, :lens[b]].numpy(),
                                   batch["logits"][b, :lens[b]].numpy(), atol=ATOL)
    with jax.default_matmul_precision("highest"):
        want = J.ls_blockstream_run(params, JCFG, mstate, jnp.asarray(x.numpy()), C, K)
    np.testing.assert_allclose(T.ls_blockstream_run(model, x, C, K).numpy(),
                               np.asarray(want), atol=ATOL)


def test_fused_route_takes_the_packed_weights(setup, monkeypatch):
    """The "fused" route reaches `retention_layer` once per retention layer
    and block (2 encoder + 2 decoder here; the decoder alone on a flush),
    with the weights the server packed."""
    _, _, model, xs = setup
    srv = RT.BlockStreamingServer(kind="ls", cfg=TCFG, model=model, n_lanes=B, n_slots=C,
                                  block=K, device="cpu")
    calls = []
    orig = RL.retention_layer

    def spy(gammas, x, w, *rest):
        calls.append(w)
        return orig(gammas, x, w, *rest)

    monkeypatch.setattr(RL, "retention_layer", spy)
    srv.process_block(xs[0])
    assert len(calls) == 4
    packed = srv._packed[0] + srv._packed[1]
    assert all(any(w is p for p in packed) for w in calls)
    srv.process_block(xs[1], flush=True)
    assert len(calls) == 6
    # the server's config picks the route, whatever config the model came with
    assert model.cfg.kernel == "fused"
    for kernel, n_core in (("plain", 0), ("core", 4)):
        core_calls = []
        monkeypatch.setattr(CR, "chunk_retention",
                            lambda *a, _orig=CR.chunk_retention: core_calls.append(1) or _orig(*a))
        other = RT.BlockStreamingServer(kind="ls", cfg=dataclasses.replace(TCFG, kernel=kernel),
                                        model=model, n_lanes=B, n_slots=C, block=K,
                                        device="cpu")
        other.process_block(xs[0])
        assert len(calls) == 6 and len(core_calls) == n_core, kernel
        monkeypatch.undo()
        monkeypatch.setattr(RL, "retention_layer", spy)


@pytest.mark.parametrize("kernel", ROUTES)
def test_block_server_matches_jax_server_frame_for_frame(setup, kernel):
    params, mstate, model, xs = setup
    jsrv = JRT.BlockStreamingServer(cfg=JCFG, params=params, model_state=mstate,
                                    n_lanes=B, n_slots=C, block=K)
    srv = RT.BlockStreamingServer(kind="ls", cfg=dataclasses.replace(TCFG, kernel=kernel),
                                  model=model, n_lanes=B, n_slots=C, block=K, device="cpu")
    h_mask = np.arange(K) < 3
    calls = [dict(), dict(), dict(h_mask=h_mask), dict(flush=True)]
    for i, kw in enumerate(calls):
        with jax.default_matmul_precision("highest"):
            want = jsrv.process_block(xs[i], **kw)
        got = srv.process_block(xs[i], **kw)
        assert got.shape == (B, K, C - 1)
        if i:                                      # the first emission is warm-up garbage
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                       err_msg=f"block {i}")
    assert srv.blocks_consumed() == jsrv.blocks_consumed() == 4
    _assert_state(srv.state, jsrv.state)


def test_block_server_reset_lanes_reproduces_a_fresh_server_bit_for_bit(setup):
    _, _, model, xs = setup
    srv = RT.BlockStreamingServer(kind="ls", cfg=TCFG, model=model, n_lanes=B, n_slots=C,
                                  block=K, device="cpu")
    first = [srv.process_block(xs[i]) for i in range(3)]
    first.append(srv.process_block(xs[3], flush=True))
    neighbour = {k: v.clone() for k, v in srv.state.items()}
    srv.reset_lanes([0, 2])
    fresh = srv.fresh_state()
    for key, t in srv.state.items():
        lane_ax = 0 if key in ("m", "h_prev", "h_tail2") else 1
        per = C if key.startswith("dec_") else 1
        assert torch.equal(t.narrow(lane_ax, per, per), neighbour[key].narrow(lane_ax, per, per)), key
        for lane in (0, 2):
            assert torch.equal(t.narrow(lane_ax, lane * per, per),
                               fresh[key].narrow(lane_ax, lane * per, per)), key
    assert srv.state["m"].tolist() == [0, 4, 0]
    again = [srv.process_block(xs[i]) for i in range(3)]
    again.append(srv.process_block(xs[3], flush=True))
    for a, f in zip(again[1:], first[1:]):
        for lane in (0, 2):
            assert torch.equal(a[lane], f[lane])
    srv.reset_all()
    assert srv.blocks_consumed() == 0
    with pytest.raises(ValueError, match="expected"):
        srv.process_block(xs[0][:, :4])


def test_per_lane_h_mask_serves_streams_of_different_lengths(setup):
    """h_mask (n_lanes, block): each lane's own tail, so recordings of
    different lengths share the blocks and one flush, and each equals the
    batch pass on its own length."""
    _, _, model, xs = setup
    lens = [20, 9, 16]
    x = xs.transpose(1, 0, 2, 3).reshape(B, 5 * K, -1)[:, :24]
    srv = RT.BlockStreamingServer(kind="ls", cfg=TCFG, model=model, n_lanes=B, n_slots=C,
                                  block=K, device="cpu")
    outs = []
    for st in range(0, 24, K):
        mask = np.arange(st, st + K)[None, :] < np.array(lens)[:, None]
        outs.append(srv.process_block(x[:, st:st + K], h_mask=mask))
    outs.append(srv.process_block(np.zeros_like(x[:, :K]), flush=True))
    probs = torch.cat(outs[1:], dim=1)
    batch = T.ls_forward(model, x, lens, C)          # chunk_size 8 = the block
    want = torch.sigmoid(batch["logits"][..., 1:])
    for b, n in enumerate(lens):
        np.testing.assert_allclose(probs[b, :n].numpy(), want[b, :n].numpy(), atol=ATOL)
