"""PyTorch port, FS-EEND serving: the port's StreamingServer(kind="fs")
driven by the port's ContinuousBatcher against the JAX package's
StreamingServer(kind="fs") driven by JAX's ContinuousBatcher, stream for
stream (arrivals mid-flight, lane reuse, per-lane flush), on the fast block
and on the frame scan, with JAX's flash route on and off; the port's
BlockStreamingServer(kind="fs") against the JAX one; then lane reset,
single-frame steps, whole-file streaming and the servers' refusals.

Tolerance: atol 2e-4 on probabilities (float32 on both sides, another
summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.models import fs_eend as J
from fseend_tpu.serving import runtime as JRT
from fseend_tpu.serving import scheduler as JSCH
from fseend_tpu_torch.models import fs_eend as T
from fseend_tpu_torch.serving import runtime as RT
from fseend_tpu_torch.serving.scheduler import ContinuousBatcher
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=2,
                      enc_dim_feedforward=64, dec_dim_feedforward=64, conv_delay=3,
                      max_nspks=4)
TCFG = T.FSEENDConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
C = 4
CAP = 40
ATOL = 2e-4
LENS = [7, 15, 1, 4, 11]          # the 1-frame stream is shorter than conv_delay
BLOCK = 6


def _jax_params(model):
    """The JAX parameter pytree of the port's model (static metadata from
    `jax.eval_shape` of the JAX init) and its model_state."""
    tree, mstate = CV.fs_params_to_jax(model)
    shapes, _ = jax.eval_shape(lambda k: J.init_fs_eend(k, JCFG), jax.random.PRNGKey(0))

    def leaf(path, _):
        node = tree
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        return jnp.asarray(node)

    return jax.tree_util.tree_map_with_path(leaf, shapes), jax.tree.map(jnp.asarray, mstate)


@pytest.fixture(scope="module")
def setup():
    model = T.init_fs_eend(TCFG, torch.Generator().manual_seed(8), device="cpu")
    rng = np.random.default_rng(21)
    with torch.no_grad():
        model.enc.bn.running_mean.copy_(torch.as_tensor(rng.normal(0, 0.2, JCFG.in_size)))
        model.enc.bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, JCFG.in_size)))
    params, mstate = _jax_params(model)
    streams = {f"s{i}": rng.standard_normal((t, JCFG.in_size)).astype(np.float32)
               for i, t in enumerate(LENS)}
    return model, params, mstate, streams


def _jax_serve(setup, flash, fs_fast):
    _, params, mstate, streams = setup
    cfg = dataclasses.replace(JCFG, use_flash_attn=flash)
    srv = JRT.StreamingServer(kind="fs", cfg=cfg, params=params, model_state=mstate,
                              n_lanes=2, n_slots=C, capacity=CAP, fs_fast=fs_fast,
                              fs_fast_chunk=3)
    cb = JSCH.ContinuousBatcher(srv, block=BLOCK)
    for sid, feats in streams.items():
        cb.submit(sid, feats)
    with jax.default_matmul_precision("highest"):
        return cb.run()


@pytest.fixture(scope="module")
def jax_fast(setup):
    return {flash: _jax_serve(setup, flash, True) for flash in (False, True)}


def _server(model, **kw):
    kw.setdefault("capacity", CAP)
    return RT.StreamingServer(kind="fs", cfg=kw.pop("cfg", TCFG), model=model, n_lanes=2,
                              n_slots=C, device="cpu", **kw)


def _serve(srv, streams):
    cb = ContinuousBatcher(srv, block=BLOCK)
    for sid, feats in streams.items():
        cb.submit(sid, feats)
    return cb.run()


@pytest.mark.parametrize("jax_flash", [False, True])
@pytest.mark.parametrize("port_flash", [False, True])
def test_batcher_over_fast_server_matches_jax(setup, jax_fast, jax_flash, port_flash):
    """Sub-blocks of 3 frames (fs_fast_chunk) on both sides; on the CPU the
    port's kernel route runs the kernel's plain version."""
    model, _, _, streams = setup
    cfg = dataclasses.replace(TCFG, use_flash_attn=port_flash)
    got = _serve(_server(model, cfg=cfg, fs_fast_chunk=3), streams)
    ref = jax_fast[jax_flash]
    assert set(got) == set(ref)
    for sid, feats in streams.items():
        assert got[sid].shape == (len(feats), C - 1)
        np.testing.assert_allclose(got[sid], np.asarray(ref[sid]), atol=ATOL)


def test_batcher_over_frame_scan_server_matches_jax(setup, jax_fast):
    model, _, _, streams = setup
    ref = _jax_serve(setup, False, False)
    got = _serve(_server(model, fs_fast=False), streams)
    for sid in streams:
        np.testing.assert_allclose(got[sid], np.asarray(ref[sid]), atol=ATOL)
        # the fast block and the frame scan serve the same probabilities
        np.testing.assert_allclose(got[sid], np.asarray(jax_fast[False][sid]), atol=ATOL)


@pytest.mark.parametrize("fs_fast", [True, False])
def test_process_block_probs_and_valid_match_jax(setup, fs_fast):
    """One block straight through both servers, lane 1 flushing from frame
    5 on: `valid` equal frame for frame, probabilities on valid frames."""
    model, params, mstate, streams = setup
    feats = np.stack([streams["s1"][:8], streams["s4"][:8]])
    flush = np.zeros((2, 8), bool)
    flush[1, 5:] = True
    jsrv = JRT.StreamingServer(kind="fs", cfg=JCFG, params=params, model_state=mstate,
                               n_lanes=2, n_slots=C, capacity=CAP, fs_fast=fs_fast)
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            want, want_vd = jsrv.process_block(feats, flush)
    srv = _server(model, fs_fast=fs_fast)
    for _ in range(2):
        got, vd = srv.process_block(feats, flush)
    np.testing.assert_array_equal(vd.numpy(), np.asarray(want_vd))
    v = vd.numpy().T
    np.testing.assert_allclose(got.numpy()[v], np.asarray(want)[v], atol=ATOL)


def test_lane_reset_reproduces_a_fresh_server_bit_for_bit(setup):
    model, _, _, streams = setup
    srv = _server(model)
    first = _serve(srv, streams)                  # s0 ran on lane 0 from a fresh state
    neighbour = {k: v.clone() for k, v in srv.state.items()}
    srv.reset_lanes([0])
    for key, t in srv.state.items():              # lane 1 untouched, lane 0 zeroed
        ax = 0 if key in ("t", "emitted", "conv_buf") else 1
        assert torch.equal(t.narrow(ax, 1, 1), neighbour[key].narrow(ax, 1, 1)), key
        assert not t.narrow(ax, 0, 1).any(), key
    again = _serve(srv, {"s0": streams["s0"]})
    np.testing.assert_array_equal(again["s0"], first["s0"])


def test_step_is_a_one_frame_block_and_stream_file_is_aligned(setup):
    model, _, _, streams = setup
    feats = np.stack([streams["s1"][:6], streams["s4"][:6]])      # (2 lanes, 6, F)
    blk, stp = _server(model), _server(model)
    p_blk, v_blk = blk.process_block(feats)
    for k in range(6):
        p, v = stp.step(feats[:, k])
        np.testing.assert_allclose(p.numpy(), p_blk[:, k].numpy(), atol=ATOL)
        np.testing.assert_array_equal(v.numpy(), v_blk[k].numpy())
    scan = _server(model, fs_fast=False)
    for k in range(6):
        p, v = scan.step(feats[:, k])
        np.testing.assert_allclose(p.numpy(), p_blk[:, k].numpy(), atol=ATOL)
    x = streams["s1"]
    probs = RT.stream_file(_server(model), x, block=4)
    batch = T.fs_forward(model, torch.as_tensor(x[None]), torch.tensor([len(x)]), C)
    np.testing.assert_allclose(probs, torch.sigmoid(batch["logits"][0, :, 1:]).numpy(),
                               atol=ATOL)


def _jax_block_run(setup, flash, xs, lens, K):
    _, params, mstate, _ = setup
    cfg = dataclasses.replace(JCFG, use_flash_attn=flash)
    srv = JRT.BlockStreamingServer(cfg=cfg, params=params, model_state=mstate, n_lanes=2,
                                   n_slots=C, block=K, kind="fs", capacity=xs.shape[1])
    outs = []
    with jax.default_matmul_precision("highest"):
        for st in range(0, xs.shape[1], K):
            mask = np.arange(st, st + K) < lens
            outs.append(np.asarray(srv.process_block(xs[:, st:st + K], h_mask=mask)))
        outs.append(np.asarray(srv.process_block(np.zeros_like(xs[:, :K]), flush=True)))
    return np.concatenate(outs[1:], axis=1)


@pytest.mark.parametrize("jax_flash", [False, True])
def test_block_server_matches_jax(setup, jax_flash):
    """Three blocks, the last zero-padded with h_mask, and the flush; the
    port on its kernel route (the plain version on the CPU) and plain."""
    model, *_ = setup
    rng = np.random.default_rng(5)
    K, n = 5, 13
    xs = rng.standard_normal((2, 15, JCFG.in_size)).astype(np.float32)
    xs[:, n:] = 0.0
    ref = _jax_block_run(setup, jax_flash, xs, n, K)
    for flash in (False, True):
        cfg = dataclasses.replace(TCFG, use_flash_attn=flash)
        srv = RT.BlockStreamingServer(kind="fs", cfg=cfg, model=model, n_lanes=2, n_slots=C,
                                      block=K, capacity=15, device="cpu")
        outs = [srv.process_block(xs[:, s:s + K], h_mask=np.arange(s, s + K) < n)
                for s in range(0, 15, K)]
        outs.append(srv.process_block(np.zeros_like(xs[:, :K]), flush=True))
        got = torch.cat(outs[1:], dim=1).numpy()
        np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=ATOL)
        assert srv.blocks_consumed() == 4
        # the capacity guard: a fourth real block would run past the caches
        with pytest.raises(ValueError, match="capacity"):
            srv.process_block(xs[:, :K])
        srv.reset_all()
        again = srv.process_block(xs[:, :K], h_mask=np.arange(K) < n)
        assert again.shape == (2, K, C - 1) and srv.blocks_consumed() == 1


def test_servers_refuse_what_they_do_not_serve(setup):
    model, *_ = setup
    with pytest.raises(ValueError, match="LS-only"):
        _server(model, frame_kernel=True)
    with pytest.raises(NotImplementedError, match="bf16"):
        _server(model, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="FSEEND"):
        RT.StreamingServer(kind="fs", cfg=TCFG, model=object(), n_lanes=2, n_slots=C,
                           device="cpu")
    blk = RT.BlockStreamingServer(kind="fs", cfg=TCFG, model=model, n_lanes=2, n_slots=C,
                                  block=5, capacity=15, device="cpu")
    with pytest.raises(ValueError, match="reset_all"):
        blk.reset_lanes([0])
    cb = ContinuousBatcher(_server(model, capacity=10), block=BLOCK)
    with pytest.raises(ValueError, match="capacity"):
        cb.submit("long", np.zeros((8, JCFG.in_size), np.float32))
