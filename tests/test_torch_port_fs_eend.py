"""PyTorch port, FS-EEND model: `fseend_tpu_torch.models.fs_eend` against
the JAX package's `fseend_tpu.models.fs_eend` on the same weights and numpy
inputs: the batch pass, the per-frame scan, the per-frame-exact fast block
(JAX on its XLA route and on its Pallas route in interpret mode), blockwise
streaming, the write clamp at the capacity edge, state carried from JAX into
the port mid-stream, the converters, the reference golden through the
port's own state-dict reader, and the port's own invariants (streaming
equals batch, the fast block equals the frame scan).

Tolerance: atol 2e-4 (float32 on both sides, another summation order; the
JAX package's golden bound); 3e-5 for the fast block against JAX's flash
route, the JAX package's own bound (tests/test_fs_eend.py:233-236)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.models import fs_eend as J
from fseend_tpu.utils import torch_convert as JTC
from fseend_tpu_torch.models import fs_eend as T
from fseend_tpu_torch.models.ls_eend import with_cfg
from fseend_tpu_torch.utils import checkpoint as CK
from fseend_tpu_torch.utils import convert as CV
from fseend_tpu_torch.utils import torch_convert as TC

torch.set_num_threads(1)
JCFG = J.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=2,
                      enc_dim_feedforward=64, dec_dim_feedforward=64, dropout=0.1,
                      conv_delay=3, max_nspks=4)
TCFG = T.FSEENDConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
C = 4
ATOL = 2e-4
ATOL_FLASH = 3e-5
GOLDENS = pathlib.Path(__file__).parent / "goldens"

# the JAX functions jitted (static config and slot count): one compile per
# shape costs less than running them op by op
J_FORWARD = jax.jit(J.fs_forward, static_argnums=(2, 5))
J_SCAN = jax.jit(J.fs_stream_scan, static_argnums=(2, 5))
J_BLOCK = jax.jit(J.fs_framestream_block, static_argnums=(2, 5))
J_BSTEP = jax.jit(J.fs_blockstream_step, static_argnums=(2, 5))


def _np(x):
    return np.array(x, dtype=np.float32)


def jax_pair(seed: int, jcfg=JCFG, tcfg=TCFG):
    """(JAX params, JAX model_state, the port's FSEEND) holding the same
    weights: the port's initializer for `seed` with random attention biases
    and BatchNorm statistics, carried into a JAX pytree whose static
    metadata comes from `jax.eval_shape` of the JAX init (no eager random
    ops)."""
    model = T.init_fs_eend(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, T.tnn.MultiheadAttention):
                m.in_proj.bias.copy_(torch.as_tensor(rng.normal(0, 0.1, m.in_proj.bias.shape)))
        bn = model.enc.bn
        bn.running_mean.copy_(torch.as_tensor(rng.normal(0, 0.2, tcfg.in_size)))
        bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, tcfg.in_size)))
        bn.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, tcfg.in_size)))
    tree, mstate = CV.fs_params_to_jax(model)
    shapes, _ = jax.eval_shape(lambda k: J.init_fs_eend(k, jcfg), jax.random.PRNGKey(0))

    def leaf(path, _):
        node = tree
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        return jnp.asarray(node)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    return params, jax.tree.map(jnp.asarray, mstate), model


def _feeds(rng, B, T_, cfg=JCFG):
    """A clip of T_ frames, conv_delay zero flush frames after it, and the
    per-lane flush mask (B, T_ + delay)."""
    xs = rng.standard_normal((B, T_, cfg.in_size)).astype(np.float32)
    seq = np.concatenate([xs, np.zeros((B, cfg.conv_delay, cfg.in_size), np.float32)], 1)
    flush = np.broadcast_to(np.arange(T_ + cfg.conv_delay) >= T_, (B, T_ + cfg.conv_delay))
    return xs, seq, np.ascontiguousarray(flush)


@pytest.fixture(scope="module")
def pair():
    return jax_pair(3)


def _allclose_tree(got, want, atol):
    flat_g, _ = jax.tree_util.tree_flatten(got)
    flat_w, _ = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, want))
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   atol=atol)


def test_fs_forward_and_fs_test_match_jax(pair):
    params, mstate, model = pair
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((2, 16, JCFG.in_size)).astype(np.float32)
    lens = np.array([16, 11])
    with jax.default_matmul_precision("highest"):
        want = J_FORWARD(params, mstate, JCFG, jnp.asarray(xs), jnp.asarray(lens), C)
    got = T.fs_forward(model, torch.as_tensor(xs), torch.as_tensor(lens), C)
    for key in ("logits", "emb", "attractors"):
        np.testing.assert_allclose(got[key].numpy(), _np(want[key]), atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(got["state"]["bn"]["mean"].numpy(), _np(mstate["bn"]["mean"]))
    test = T.fs_test(model, torch.as_tensor(xs), torch.as_tensor(lens))
    assert test["logits"].shape == (2, 16, JCFG.max_nspks)
    # the training pass is ported (tests/test_torch_port_fs_train.py): it
    # carries autograd, the evaluation pass does not
    assert not got["logits"].requires_grad
    assert T.fs_forward(model, torch.as_tensor(xs), torch.as_tensor(lens), C,
                        train=True)["logits"].requires_grad
    with pytest.raises(ValueError, match="float32"):
        T.fs_forward(model, torch.as_tensor(xs).double(), torch.as_tensor(lens), C)


def test_stream_scan_matches_jax_and_the_batch_pass(pair):
    params, mstate, model = pair
    rng = np.random.default_rng(2)
    B, T_ = 2, 12
    cap = T_ + JCFG.conv_delay
    xs, _, _ = _feeds(rng, B, T_)
    with jax.default_matmul_precision("highest"):
        want, want_emb = J_SCAN(params, J.fs_stream_init(JCFG, B, cap, C), JCFG,
                                mstate["bn"], jnp.asarray(xs), C)
    st = T.fs_stream_init(TCFG, B, cap, C, device="cpu")
    got, emb = T.fs_stream_scan(model, st, torch.as_tensor(xs), C)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    np.testing.assert_allclose(emb.numpy(), _np(want_emb), atol=ATOL)
    batch = T.fs_forward(model, torch.as_tensor(xs), torch.full((B,), T_), C)
    np.testing.assert_allclose(got.numpy(), batch["logits"].numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def framestream_jax(pair):
    """The JAX fast block over odd splits (5, 1, rest) with per-lane clock
    skew (lane 1 three frames behind) and the flush tail, on both JAX
    routes; plus the JAX frame scan on the same feeds."""
    params, mstate, _ = pair
    rng = np.random.default_rng(4)
    B, T_, cap = 2, 17, 32
    xs, seq, flush = _feeds(rng, B, T_)
    n = seq.shape[1]
    splits = ((0, 5), (5, 6), (6, n))
    t0 = np.array([0, 3], np.int32)
    out = {"seq": seq, "flush": flush, "splits": splits, "cap": cap, "t0": t0}
    for flash in (False, True):
        cfg = dataclasses.replace(JCFG, use_flash_attn=flash)
        st = J.fs_stream_init(cfg, B, cap, C)
        st["t"] = jnp.asarray(t0)
        lg, vd = [], []
        with jax.default_matmul_precision("highest"):
            for lo, hi in splits:
                st, (l, v) = J_BLOCK(params, st, cfg, mstate["bn"],
                                     jnp.asarray(seq[:, lo:hi]), C,
                                     jnp.asarray(flush[:, lo:hi]))
                lg.append(l)
                vd.append(v)
        out[flash] = (_np(jnp.concatenate(lg, 1)), np.asarray(jnp.concatenate(vd, 1)),
                      jax.tree.map(np.asarray, st))
    return out


@pytest.mark.parametrize("jax_flash", [False, True])
@pytest.mark.parametrize("port_flash", [False, True])
def test_framestream_block_matches_jax(pair, framestream_jax, jax_flash, port_flash):
    """Valid frames and every carried cache; on the CPU the port's kernel
    route runs the kernel's plain version."""
    _, _, model = pair
    fj = framestream_jax
    want_lg, want_vd, want_st = fj[jax_flash]
    m = with_cfg(model, dataclasses.replace(TCFG, use_flash_attn=port_flash))
    st = T.fs_stream_init(TCFG, 2, fj["cap"], C, device="cpu")
    st["t"] = torch.as_tensor(fj["t0"])
    lg, vd = [], []
    for lo, hi in fj["splits"]:
        st, (l, v) = T.fs_framestream_block(m, st, torch.as_tensor(fj["seq"][:, lo:hi]), C,
                                            torch.as_tensor(fj["flush"][:, lo:hi]))
        lg.append(l)
        vd.append(v)
    lg, vd = torch.cat(lg, 1).numpy(), torch.cat(vd, 1).numpy()
    np.testing.assert_array_equal(vd, want_vd)
    atol = ATOL_FLASH if jax_flash else ATOL
    np.testing.assert_allclose(lg[vd], want_lg[want_vd], atol=atol)
    _allclose_tree(CV.fs_state_to_numpy(st), want_st, atol)


def test_fast_block_equals_the_frame_scan_and_batch(pair):
    """The port's own invariant: the fast block over odd splits gives the
    frame scan's outputs, which give the batch pass's."""
    _, _, model = pair
    rng = np.random.default_rng(5)
    B, T_ = 2, 13
    cap = T_ + JCFG.conv_delay
    xs, seq, flush = _feeds(rng, B, T_)
    scan, _ = T.fs_stream_scan(model, T.fs_stream_init(TCFG, B, cap, C, device="cpu"),
                               torch.as_tensor(xs), C)
    st = T.fs_stream_init(TCFG, B, cap, C, device="cpu")
    lg = []
    for lo, hi in ((0, 2), (2, 9), (9, seq.shape[1])):
        st, (l, _) = T.fs_framestream_block(model, st, torch.as_tensor(seq[:, lo:hi]), C,
                                            torch.as_tensor(flush[:, lo:hi]))
        lg.append(l)
    fast = torch.cat(lg, 1)[:, JCFG.conv_delay:]
    np.testing.assert_allclose(fast.numpy(), scan.numpy(), atol=1e-4)
    assert st["t"].tolist() == [T_ + JCFG.conv_delay] * B
    assert st["emitted"].tolist() == [T_] * B


def test_write_clamp_at_the_capacity_edge_equals_jax(pair):
    """A fast block whose write would run past the capacity lands at the
    tail (JAX's dynamic_update_slice clamp): the port computes what the JAX
    package computes, outputs and caches."""
    params, mstate, model = pair
    rng = np.random.default_rng(6)
    B, K, cap = 2, 6, 16
    xs = rng.standard_normal((B, K, JCFG.in_size)).astype(np.float32)
    prev = rng.standard_normal((B, 12, JCFG.in_size)).astype(np.float32)
    nofl = np.zeros((B, 12), bool)
    jst = J.fs_stream_init(JCFG, B, cap, C)
    tst = T.fs_stream_init(TCFG, B, cap, C, device="cpu")
    with jax.default_matmul_precision("highest"):
        jst, _ = J_BLOCK(params, jst, JCFG, mstate["bn"], jnp.asarray(prev), C,
                         jnp.asarray(nofl))
        jst, (want, _) = J_BLOCK(params, jst, JCFG, mstate["bn"], jnp.asarray(xs), C,
                                 jnp.asarray(nofl[:, :K]))
    tst, _ = T.fs_framestream_block(model, tst, torch.as_tensor(prev), C,
                                    torch.as_tensor(nofl))
    tst, (got, _) = T.fs_framestream_block(model, tst, torch.as_tensor(xs), C,
                                           torch.as_tensor(nofl[:, :K]))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    _allclose_tree(CV.fs_state_to_numpy(tst), jst, ATOL)
    # the sharp edge both packages share (ROADMAP C): the clamped block's
    # outputs are no longer those of the batch pass over the same frames
    batch = T.fs_forward(model, torch.as_tensor(np.concatenate([prev, xs], 1)),
                         torch.full((B,), 12 + K), C)["logits"]
    d = JCFG.conv_delay
    assert float((got - batch[:, 12 - d:12 + K - d]).abs().max()) > 1e-2


def test_state_carried_from_jax_mid_stream(pair):
    """JAX serves the first block; its state crosses into the port
    (`fs_state_from_jax`), which serves the second; the JAX package serves
    the second block from the same state.  Also the round trip back."""
    params, mstate, model = pair
    rng = np.random.default_rng(7)
    B, cap = 2, 24
    x1, x2 = (rng.standard_normal((B, k, JCFG.in_size)).astype(np.float32) for k in (7, 5))
    fl1, fl2 = np.zeros((B, 7), bool), np.zeros((B, 5), bool)
    fl2[1, 3:] = True
    st = J.fs_stream_init(JCFG, B, cap, C)
    st["t"] = jnp.asarray([0, 2], jnp.int32)
    with jax.default_matmul_precision("highest"):
        st, _ = J_BLOCK(params, st, JCFG, mstate["bn"], jnp.asarray(x1), C, jnp.asarray(fl1))
        st_np = jax.tree.map(np.asarray, st)
        st2, (want, want_vd) = J_BLOCK(params, st, JCFG, mstate["bn"], jnp.asarray(x2), C,
                                       jnp.asarray(fl2))
    tst = CV.fs_state_from_jax(st_np, device="cpu")
    _allclose_tree(CV.fs_state_to_numpy(tst), st_np, 0)
    tst, (got, vd) = T.fs_framestream_block(model, tst, torch.as_tensor(x2), C,
                                            torch.as_tensor(fl2))
    np.testing.assert_array_equal(vd.numpy(), np.asarray(want_vd))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    _allclose_tree(CV.fs_state_to_numpy(tst), st2, ATOL)


@pytest.fixture(scope="module")
def blockstream_jax(pair):
    """JAX blockwise steps over a zero-padded ragged tail (h_mask) and the
    enc-bypass flush, on both JAX routes (Pallas in interpret mode), and
    `fs_blockstream_run` on a ragged clip."""
    params, mstate, _ = pair
    rng = np.random.default_rng(8)
    B, K, T_ = 2, 5, 13
    xs = rng.standard_normal((B, 15, JCFG.in_size)).astype(np.float32)
    xs[:, T_:] = 0.0
    out = {"xs": xs, "K": K, "T": T_}
    for flash in (False, True):
        cfg = dataclasses.replace(JCFG, use_flash_attn=flash)
        st = J.fs_blockstream_init(cfg, B, 15, C, K)
        lg, states = [], []
        with jax.default_matmul_precision("highest"):
            for i in range(0, 15, K):
                h_mask = jnp.arange(i, i + K) < T_
                st, y = J_BSTEP(params, st, cfg, mstate["bn"], jnp.asarray(xs[:, i:i + K]), C,
                                h_mask=h_mask)
                lg.append(_np(y))
                states.append(jax.tree.map(np.asarray, st))
            st, y = J_BSTEP(params, st, cfg, mstate["bn"], jnp.zeros((B, K, JCFG.in_size)), C,
                            enc_bypass=True)
        lg.append(_np(y))
        states.append(jax.tree.map(np.asarray, st))
        out[flash] = (lg, states)
    with jax.default_matmul_precision("highest"):
        out["run"] = _np(J.fs_blockstream_run(params, JCFG, mstate["bn"],
                                              jnp.asarray(xs[:, :T_]), C, K))
    return out


@pytest.mark.parametrize("jax_flash", [False, True])
def test_blockstream_step_matches_jax(pair, blockstream_jax, jax_flash):
    _, _, model = pair
    bj = blockstream_jax
    want_lg, want_states = bj[jax_flash]
    xs, K, T_ = bj["xs"], bj["K"], bj["T"]
    st = T.fs_blockstream_init(TCFG, 2, 15, C, K, device="cpu")
    for n, i in enumerate(range(0, 15, K)):
        st, y = T.fs_blockstream_step(model, st, torch.as_tensor(xs[:, i:i + K]), C,
                                      h_mask=torch.arange(i, i + K) < T_)
        if n:                                    # block 0's emission is warm-up garbage
            np.testing.assert_allclose(y.numpy(), want_lg[n], atol=ATOL)
        _allclose_tree(CV.fs_blockstate_to_numpy(st), want_states[n], ATOL)
    st, y = T.fs_blockstream_step(model, st, torch.zeros(2, K, JCFG.in_size), C,
                                  enc_bypass=True)
    np.testing.assert_allclose(y.numpy(), want_lg[-1], atol=ATOL)
    _allclose_tree(CV.fs_blockstate_to_numpy(st), want_states[-1], ATOL)
    # the blockwise state crosses from JAX into the port and back unchanged
    mid = want_states[1]
    _allclose_tree(CV.fs_blockstate_to_numpy(CV.fs_blockstate_from_jax(mid, "cpu")), mid, 0)


def test_blockstream_run_matches_jax_and_the_batch_pass(pair, blockstream_jax):
    _, _, model = pair
    bj = blockstream_jax
    xs = torch.as_tensor(bj["xs"][:, :bj["T"]])
    got = T.fs_blockstream_run(model, xs, C, bj["K"])
    np.testing.assert_allclose(got.numpy(), bj["run"], atol=ATOL)
    batch = T.fs_forward(model, xs, torch.full((2,), bj["T"]), C)
    np.testing.assert_allclose(got.numpy(), batch["logits"].numpy(), atol=1e-4)


def test_golden_through_the_ports_own_reader():
    """The reference's own outputs (tests/goldens/fs_model_ref.npz) through
    `fs_from_state_dict`, which builds the same tree as the JAX package's
    reader; bound as tests/test_torch_convert.py."""
    g = np.load(GOLDENS / "fs_model_ref.npz")
    sd = {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}
    cfg = T.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=2,
                         enc_dim_feedforward=2048, dec_dim_feedforward=64, conv_delay=9,
                         max_nspks=4)
    model = TC.fs_from_state_dict(sd, cfg, device="cpu")
    out = T.fs_test(model, torch.as_tensor(g["x"]), torch.tensor([16, 16]), max_nspks=4)
    np.testing.assert_allclose(out["logits"].numpy(), g["logits"], atol=2e-4)
    np.testing.assert_allclose(out["emb"].numpy(), g["emb"], atol=2e-4)
    jcfg = J.FSEENDConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    want = JTC.fs_from_state_dict(dict(sd), jcfg)
    _allclose_tree(TC.fs_tree_from_state_dict(dict(sd), cfg), want, 0)


def test_checkpoint_round_trip(pair, tmp_path):
    """An FS checkpoint in the JAX package's npz layout loads into the port
    bit for bit (and params alone get fresh BatchNorm statistics)."""
    _, _, model = pair
    params, mstate = CV.fs_params_to_jax(model)
    CK.save_pytree(tmp_path / "fs.npz", {"params": params, "model_state": mstate})
    back = CK.load_fs_eend(tmp_path / "fs.npz", TCFG, device="cpu")
    for (name, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), name
    CK.save_pytree(tmp_path / "p.npz", {"params": params})
    fresh = CK.load_fs_eend(tmp_path / "p.npz", TCFG, device="cpu")
    assert torch.equal(fresh.enc.bn.running_var, torch.ones(TCFG.in_size))


def test_state_constructors_default_to_the_card():
    """Like every entry point of the port, the stream-state constructors of
    both families put their tensors on the card unless the caller names a
    device, and raise where there is none (the LS ones used to build CPU
    tensors: ROADMAP C)."""
    from fseend_tpu_torch.models import ls_eend as L

    lcfg = L.LSEENDConfig(in_size=20, n_units=64, n_heads=4, enc_n_layers=2,
                          dec_n_layers=2, conv_kernel_size=4, dec_dim_feedforward=48,
                          conv_delay=2, max_nspks=3)
    makers = (lambda: L.ls_stream_init(lcfg, 2, 3), lambda: L.ls_blockstream_init(lcfg, 2, 3, 4),
              lambda: T.fs_stream_init(TCFG, 2, 8, C),
              lambda: T.fs_blockstream_init(TCFG, 2, 8, C, 4))
    for make in makers:
        if torch.cuda.is_available():
            assert all(t.device.type == "cuda" for t in make().values())
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    assert all(t.device.type == "cpu"
               for t in T.fs_blockstream_init(TCFG, 2, 8, C, 4, device="cpu").values())
