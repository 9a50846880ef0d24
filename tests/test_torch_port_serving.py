"""PyTorch port, the whole slice: the port's StreamingServer(kind="ls")
driven by the port's ContinuousBatcher against the JAX package's
StreamingServer(frame_kernel=True) driven by JAX's ContinuousBatcher,
stream for stream (arrivals mid-flight, lane reuse, per-lane flush), on the
same weights; then lane reset, single-frame steps and whole-file streaming.

Tolerance: atol 2e-4 on probabilities, the JAX package's own tolerance for
its frame-kernel server against its per-frame server."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.models import ls_eend as J
from fseend_tpu.serving import runtime as JRT
from fseend_tpu.serving import scheduler as JSCH
from fseend_tpu_torch.models import ls_eend as T
from fseend_tpu_torch.parallel import mesh as PM
from fseend_tpu_torch.serving import runtime as RT
from fseend_tpu_torch.serving.scheduler import ContinuousBatcher
from fseend_tpu_torch.train import trainer as TRN
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.LSEENDConfig(
    in_size=20, n_units=64, n_heads=4, enc_n_layers=2, dec_n_layers=2,
    conv_kernel_size=4, dec_dim_feedforward=48, conv_delay=2, max_nspks=3,
    dropout=0.0)
TCFG = T.LSEENDConfig(**{f.name: getattr(JCFG, f.name)
                         for f in dataclasses.fields(T.LSEENDConfig)
                         if hasattr(JCFG, f.name)})
C = 3
ATOL = 2e-4
LENS = [7, 15, 1, 4, 11]          # the 1-frame stream is shorter than conv_delay


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
    rng = np.random.default_rng(11)
    mstate = {"conv_bn": [{"mean": jnp.asarray(rng.normal(0, 0.2, 64), jnp.float32),
                           "var": jnp.asarray(rng.uniform(0.5, 2.0, 64), jnp.float32)}
                          for _ in range(2)]}
    model = CV.ls_params_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, mstate), TCFG, "cpu")
    streams = {f"s{i}": rng.standard_normal((t, JCFG.in_size)).astype(np.float32)
               for i, t in enumerate(LENS)}
    jsrv = JRT.StreamingServer(kind="ls", cfg=JCFG, params=params, model_state=mstate,
                               n_lanes=2, n_slots=C, frame_kernel=True)
    cb = JSCH.ContinuousBatcher(jsrv, block=6)
    for sid, feats in streams.items():
        cb.submit(sid, feats)
    with jax.default_matmul_precision("highest"):
        ref = cb.run()
    return model, streams, ref


def _server(model, **kw):
    return RT.StreamingServer(kind="ls", cfg=TCFG, model=model, n_lanes=2, n_slots=C,
                              device="cpu", **kw)


def _serve(srv, streams):
    cb = ContinuousBatcher(srv, block=6)
    for sid, feats in streams.items():
        cb.submit(sid, feats)
    return cb.run()


@pytest.mark.parametrize("frame_kernel", [True, False])
def test_batcher_over_server_matches_jax_frame_kernel_server(setup, frame_kernel):
    model, streams, ref = setup
    got = _serve(_server(model, frame_kernel=frame_kernel), streams)
    assert set(got) == set(ref)
    for sid, feats in streams.items():
        assert got[sid].shape == (len(feats), C - 1)
        np.testing.assert_allclose(got[sid], ref[sid], atol=ATOL)


def test_lane_reset_reproduces_a_fresh_server_bit_for_bit(setup):
    model, streams, _ = setup
    srv = _server(model)
    first = _serve(srv, streams)                  # s0 ran on lane 0 from a fresh state
    neighbour = {k: v.clone() for k, v in srv.state.items()}
    srv.reset_lanes([0])
    for key, t in srv.state.items():              # lane 1 untouched, lane 0 zeroed
        lane_ax = 0 if key in ("t", "cnn_buf") else 1
        per = C if key.startswith("dec_") else 1
        keep = t.narrow(lane_ax, per, per)
        assert torch.equal(keep, neighbour[key].narrow(lane_ax, per, per)), key
        assert not t.narrow(lane_ax, 0, per).any(), key
    again = _serve(srv, {"s0": streams["s0"]})
    np.testing.assert_array_equal(again["s0"], first["s0"])


def test_step_is_a_one_frame_block(setup):
    model, streams, _ = setup
    feats = np.stack([streams["s1"][:6], streams["s4"][:6]])      # (2 lanes, 6, F)
    blk, stp = _server(model), _server(model)
    p_blk, v_blk = blk.process_block(feats)
    for k in range(6):
        p, v = stp.step(feats[:, k])
        np.testing.assert_allclose(p.numpy(), p_blk[:, k].numpy(), atol=ATOL)
        np.testing.assert_array_equal(v.numpy(), v_blk[k].numpy())
    plain = _server(model, frame_kernel=False)
    p, _ = plain.step(feats[:, 0])
    np.testing.assert_allclose(p.numpy(), p_blk[:, 0].numpy(), atol=ATOL)


def test_stream_file_is_time_aligned(setup):
    model, streams, _ = setup
    feats = streams["s1"]
    probs = RT.stream_file(_server(model), feats, block=4)
    lg, _ = T.ls_stream_scan(model, T.ls_stream_init(TCFG, 1, C, device="cpu"),
                             torch.as_tensor(feats[None]), C)
    np.testing.assert_allclose(probs, torch.sigmoid(lg[0, :, 1:]).numpy(), atol=ATOL)


def test_unported_modes_say_where_they_are_queued(setup):
    model, *_ = setup
    # FS-EEND serving is ported (ROADMAP A9; tests/test_torch_port_fs_serving.py):
    # an FS server refuses an LS model rather than serving it
    with pytest.raises(TypeError, match="FSEEND"):
        RT.StreamingServer(kind="fs", cfg=TCFG, model=model, n_lanes=2, n_slots=C,
                           device="cpu")
    with pytest.raises(TypeError, match="FSEEND"):
        RT.BlockStreamingServer(kind="fs", cfg=TCFG, model=model, n_lanes=2, n_slots=C,
                                device="cpu")
    # training is ported for LS-EEND, FS-EEND (tests/test_torch_port_fs_train.py)
    # and EEND-EDA (tests/test_torch_port_eda.py); data-parallel training and
    # lane-sharded serving too (tests/test_torch_port_parallel.py), and the
    # tensor-parallel "model" axis (tests/test_torch_port_tp.py)
    assert TRN.TaskConfig(model="fs").model == "fs"
    assert TRN.TaskConfig(model="eda", label_mode="pit").model == "eda"
    with pytest.raises(TypeError, match="mesh of processes"):
        TRN.make_train_step(TRN.TaskConfig(), dataclasses.replace(TCFG, use_fused_dec=True),
                            None, mesh=object(), device="cpu")
    # a server on a mesh with a model axis shards its lanes over "data" and
    # replicates the model over "model": the same outputs as without the axis
    frames = np.random.default_rng(4).standard_normal((2, 6, TCFG.in_size)).astype(np.float32)
    outs = []
    for mesh in (PM.make_mesh(n_model=2, devices=["cpu"] * 4), PM.make_mesh(devices=["cpu"] * 2)):
        assert mesh.n_data == 2 and len(mesh.devices) == 2
        srv = RT.StreamingServer(kind="ls", cfg=TCFG, model=model, n_lanes=2, n_slots=C,
                                 device="cpu", mesh=mesh)
        outs.append(srv.process_block(frames)[0])
    assert torch.equal(outs[0], outs[1])
    # LS serving in bf16 is ported (ROADMAP B9 part 1; tests/test_torch_port_bf16.py):
    # the server builds, with a bf16 state and a bf16 copy of the model
    srv = _server(model, dtype=torch.bfloat16)
    assert {t.dtype for t in srv.state.values() if t.is_floating_point()} == {torch.bfloat16}
    assert next(srv.model.parameters()).dtype == torch.bfloat16
