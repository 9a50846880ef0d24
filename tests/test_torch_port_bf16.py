"""PyTorch port, LS-EEND serving in bf16: both bf16 LS servers, per-frame
(its frame-kernel route runs the bf16 plain versions of B1
`dec_frame_scan` and B2 `enc_frame_scan` on the CPU) and blockwise (its
"fused" route runs B4 `retention_layer`'s bf16 plain version through the
custom op), against the JAX package's servers on the same bf16 weights
over blocks with the state carried and a lane reset, probabilities and
every state leaf.  B1's and B2's bf16 plain versions against the JAX
package's Pallas kernels in interpret mode on the inputs those kernels
saw inside JAX's bf16 frame-kernel server; B4's against
`fused_retention_layer(..., interpret=True)`.  Then the frame count `s`
held in bf16 as the JAX package holds it, the bf16 model cast, the
packing dtypes and the wrappers' dtype checks.

Inputs and weights come from a numpy seed (the port's initializer, carried
into the JAX tree) and are cast to bf16 in both packages.  Tolerances:

* the drift rule of the JAX package's own bf16 test
  (tests/test_dec_frame_scan.py:96-122): max |port bf16 - JAX float32| <=
  3 * max |JAX bf16 yardstick - JAX float32| + 1e-3.  The float32 oracle is
  the JAX package's float32 server (its float32 XLA retention for B4); the
  yardstick is its per-frame XLA scan in bf16 (its bf16 blockwise server,
  its bf16 retention-layer kernel);
* rounding points, where the two packages see the same bf16 values:
  mean |port bf16 - JAX bf16 kernel| <= ROUND_SHARE * mean |JAX bf16 kernel
  - float32|.  For B1 and B2 that is each kernel's first frames from a zero
  state (there the port's float32 carry within a call and the Pallas
  kernels' bf16 carry coincide); for B4 the whole call (both carry float32
  within a call).  The JAX programs of this check are compiled with
  `xla_allow_excess_precision` off: with it on, XLA on the CPU drops the
  bf16 roundings of products that are read back in float32 (`(a *
  b).astype(f32)`), which the Pallas source and the TPU keep;
* served probabilities within 0.1 of JAX's float32 server
  (tests/test_serving.py:165-183); states bf16 and finite after every
  block.

The config is the widths of tests/test_dec_frame_scan.py with one layer
each and two slots: the JAX programs' compiles are most of this file's
time."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import dec_frame_scan_pallas as JDFS
from fseend_tpu.kernels import enc_frame_scan_pallas as JEFS
from fseend_tpu.kernels.retention_layer_pallas import fused_retention_layer
from fseend_tpu.models import ls_eend as J
from fseend_tpu.ops import retention as JR
from fseend_tpu.serving import runtime as JRT
from fseend_tpu_torch.kernels import dec_frame_scan as DFS
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.models import ls_eend as T
from fseend_tpu_torch.ops import retention as TR
from fseend_tpu_torch.serving import runtime as RT
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.LSEENDConfig(
    in_size=20, n_units=64, n_heads=4, enc_n_layers=1, dec_n_layers=1,
    conv_kernel_size=4, dec_dim_feedforward=48, conv_delay=2, max_nspks=2,
    dropout=0.0)
TCFG = T.LSEENDConfig(**{f.name: getattr(JCFG, f.name)
                         for f in dataclasses.fields(T.LSEENDConfig)
                         if hasattr(JCFG, f.name)})
B, K, C = 4, 12, 2
D, H, L = 64, 4, 1
BF = torch.bfloat16
PROB_ATOL = 0.1
ROUND_SHARE = 0.05
NO_EXCESS = {"xla_allow_excess_precision": False}


def _cast(tree):
    """The JAX package's bf16 cast (bench.py:508-511)."""
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if hasattr(x, "dtype") and x.dtype == jnp.float32 else x, tree)


def _np(x) -> np.ndarray:
    return np.array(jnp.asarray(x, jnp.float32))


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _drift_ok(port, ref, yard, what):
    err = float(np.abs(_f32(port) - _f32(ref)).max())
    err_y = float(np.abs(_f32(yard) - _f32(ref)).max())
    assert err <= 3.0 * err_y + 1e-3, (what, err, err_y)


def _rounds_like_jax(port, jax_bf16, f32, what):
    """The rounding-point rule: the port's bf16 result sits within
    ROUND_SHARE of the JAX bf16 kernel's own distance from float32."""
    near = float(np.abs(_f32(port) - _f32(jax_bf16)).mean())
    drift = float(np.abs(_f32(jax_bf16) - _f32(f32)).mean())
    assert drift > 0 and near <= ROUND_SHARE * drift, (what, near, drift)


def _bf16(a) -> torch.Tensor:
    """A JAX bf16 (or float32) array as a port bf16 tensor, the same values."""
    return torch.as_tensor(_f32(a)).to(BF).contiguous()


def _bf16_state_ok(state: dict):
    for key, t in state.items():
        if t.is_floating_point():
            assert t.dtype == BF and torch.isfinite(t.float()).all(), key


def _leaves(state: dict, to_numpy) -> list:
    """A copy of the port's state as the JAX tree's leaves (float32 numpy;
    the servers update their state in place)."""
    return jax.tree.leaves(to_numpy({k: (v.float() if v.is_floating_point() else v).clone()
                                     for k, v in state.items()}))


@pytest.fixture(scope="module", autouse=True)
def _quick_compiles():
    """XLA's optimization passes off while this file compiles its JAX
    programs (about half their compile time; the same arithmetic)."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def setup():
    seed_model = T.init_ls_eend(TCFG, torch.Generator().manual_seed(5), device="cpu")
    tree, _ = CV.ls_params_to_jax(seed_model)
    shapes, _ = jax.eval_shape(lambda k: J.init_ls_eend(k, JCFG), jax.random.PRNGKey(0))

    def leaf(path, _):
        node = tree
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        return jnp.asarray(node)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    rng = np.random.default_rng(5)
    mstate = {"conv_bn": [{"mean": jnp.asarray(rng.normal(0, 0.2, D), jnp.float32),
                           "var": jnp.asarray(rng.uniform(0.5, 2.0, D), jnp.float32)}
                          for _ in range(L)]}
    model = CV.ls_params_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, mstate), TCFG, "cpu")
    xs = rng.standard_normal((2, B, K, JCFG.in_size)).astype(np.float32)
    return params, mstate, model, xs


def _serve(srv, blocks, jax_side):
    """Blocks through a server, lane 1 reset after the first: the
    probabilities and the state's leaves (as the JAX tree's) of each."""
    outs = []
    for i, xs in enumerate(blocks):
        if i == 1:
            srv.reset_lanes([1])
        if jax_side:
            out = srv.process_block(jnp.asarray(xs, srv.dtype))
            probs = _np(out[0] if isinstance(out, tuple) else out)
            leaves = [_np(a) for a in jax.tree.leaves(srv.state)]
        else:
            out = srv.process_block(xs)
            probs = out[0] if isinstance(out, tuple) else out
            assert probs.dtype == torch.float32
            if srv.dtype == BF:
                _bf16_state_ok(srv.state)
            to_np = (CV.ls_state_to_numpy if isinstance(srv, RT.StreamingServer)
                     else CV.ls_blockstate_to_numpy)
            probs, leaves = probs.numpy(), _leaves(srv.state, to_np)
        outs.append((probs, leaves))
    return outs


@pytest.fixture(scope="module")
def jax_per_frame(setup):
    """JAX's per-frame servers over the two blocks: float32 (the oracle),
    the bf16 XLA scan (the yardstick; kept, to run on past 256 frames) and
    the bf16 frame-kernel route (both Pallas frame scans in interpret mode,
    compiled with excess precision off), whose kernel calls are recorded:
    [(inputs, outputs)] per kernel and block, with the server state before
    each block."""
    params, mstate, _, xs = setup

    def jsrv(fk, dt):
        cast = _cast if dt == jnp.bfloat16 else (lambda t: t)
        return JRT.StreamingServer(kind="ls", cfg=JCFG, params=cast(params),
                                   model_state=cast(mstate), n_lanes=B, n_slots=C,
                                   dtype=dt, frame_kernel=fk)

    oracle = _serve(jsrv(False, jnp.float32), list(xs), True)
    xla = jsrv(False, jnp.bfloat16)
    yard = _serve(xla, list(xs), True)
    calls = {"enc_frame_scan": [], "dec_frame_scan": []}

    def record(mod, name):
        orig = getattr(mod, name)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            jax.debug.callback(lambda *a: calls[name].append((a[:len(args)], a[len(args):])),
                               *args, *out)
            return out
        return orig, wrapped

    saved = [(mod, name, *record(mod, name)) for mod, name in
             ((JEFS, "enc_frame_scan"), (JDFS, "dec_frame_scan"))]
    try:
        for mod, name, _, wrapped in saved:
            setattr(mod, name, wrapped)
        fk = jsrv(True, jnp.bfloat16)
        fk._block = jax.jit(fk._block_impl, donate_argnums=(0,), compiler_options=NO_EXCESS)
        before = jax.tree.map(np.asarray, fk.state)
        fused = _serve(fk, list(xs), True)
    finally:
        for mod, name, orig, _ in saved:
            setattr(mod, name, orig)
    return xla, oracle, yard, fused, calls, before


def test_bf16_per_frame_server_against_jax(setup, jax_per_frame):
    """StreamingServer(kind="ls", dtype=bf16) on the frame-kernel route (B1's
    and B2's bf16 plain versions) and on the plain per-frame route, two
    blocks with lane 1 reset between them: probabilities and every state
    leaf by the drift rule against JAX's float32 server, JAX's bf16 XLA
    scan as yardstick, and the same rule for JAX's bf16 frame-kernel server
    (the Pallas kernels); probabilities within 0.1 of JAX's float32 server;
    the caller's model left in float32."""
    _, _, model, xs = setup
    _, oracle, yard, jfused, _, _ = jax_per_frame
    for fk in (True, False):
        got = _serve(RT.StreamingServer(kind="ls", cfg=TCFG, model=model, n_lanes=B, n_slots=C,
                                        dtype=BF, device="cpu", frame_kernel=fk),
                     list(xs), False)
        for (g, gl), (r, rl), (y, yl), (j, jl) in zip(got, oracle, yard, jfused):
            np.testing.assert_allclose(g, r, atol=PROB_ATOL)
            for what, a, b, c, d in [("probs", g, r, y, j)] + list(zip(
                    range(len(gl)), gl, rl, yl, jl)):
                _drift_ok(a, b, c, f"port bf16, frame_kernel={fk}: {what}")
                _drift_ok(d, b, c, f"JAX frame-kernel bf16: {what}")
    assert next(model.parameters()).dtype == torch.float32


def test_bf16_frame_scan_plain_rounds_where_the_pallas_kernels_round(setup, jax_per_frame):
    """B2's and B1's bf16 plain versions on the inputs, weights and state
    that JAX's Pallas kernels saw in the first block of JAX's bf16
    frame-kernel server: the first frames, whose incoming retention state
    and conv ring are zero (frame 0 for the encoder; frames 0 to
    conv_delay for the decoder, whose state only moves on valid frames),
    by the rounding-point rule, float32 being the port's float32 plain
    version on the same bf16 values (held to the Pallas kernels at 2e-4 by
    tests/test_torch_port_kernels.py); the whole block, states included,
    by the drift rule against that float32 result."""
    _, _, model, _ = setup
    _, _, _, _, calls, before = jax_per_frame
    (ea, (jh, *_)), (da, (jlog, *_)) = calls["enc_frame_scan"][0], calls["dec_frame_scan"][0]
    st = {k: _bf16(np.stack([_f32(x) for x in v])) for k, v in (
        ("kv", [e["ret"]["kv"] for e in before["enc"]]),
        ("s", [e["ret"]["scale"] for e in before["enc"]]),
        ("ring", [e["conv"] for e in before["enc"]]),
        ("dkv", [d["kv"] for d in before["dec"]]),
        ("ds", [d["scale"] for d in before["dec"]]))}
    assert not any(t.float().any() for t in st.values())
    h0 = _bf16(_f32(ea[0]).transpose(2, 0, 1))                          # (B, K, D)
    flush = torch.as_tensor(np.ascontiguousarray(_f32(ea[1])[:, 0, :].T))
    embp, embn = (_bf16(_f32(a).transpose(2, 0, 1)) for a in da[:2])
    valid = torch.as_tensor(np.ascontiguousarray(_f32(da[2])[:, 0, :].T))
    pe = _bf16(_f32(da[3])[:, ::B].T)                    # (D, C*B) slot-major -> (C, D)
    want_h = _f32(jh).transpose(2, 0, 1)
    want_logits = _f32(jlog).reshape(K, C, B).transpose(2, 0, 1)
    ew, dw = T.pack_weights(CV.cast_model(copy.deepcopy(model)))
    outs = {}
    for dt in (BF, torch.float32):
        sd = {k: v.to(dt).clone() for k, v in st.items()}
        h = EFS.enc_frame_scan_plain(h0.to(dt), flush, type(ew)(*(t.to(dt) for t in ew)),
                                     sd["kv"], sd["s"], sd["ring"], ffac=TCFG.ff_factor)
        logits = DFS.dec_frame_scan_plain(embp.to(dt), embn.to(dt), valid, pe.to(dt),
                                          type(dw)(*(t.to(dt) for t in dw)), sd["dkv"], sd["ds"])
        outs[dt] = (h, logits, sd)
    (h, logits, sd), (h32, logits32, sd32) = outs[BF], outs[torch.float32]
    assert h.dtype == BF and logits.dtype == torch.float32
    n = JCFG.conv_delay + 1
    _rounds_like_jax(h[:, :1], want_h[:, :1], h32[:, :1], "enc_frame_scan, frame 0")
    _rounds_like_jax(logits[:, :n], want_logits[:, :n], logits32[:, :n],
                     f"dec_frame_scan, frames 0-{n - 1}")
    _drift_ok(h, h32, want_h, "enc_frame_scan block")
    _drift_ok(logits, logits32, want_logits, "dec_frame_scan block")
    for k in sd:
        assert sd[k].dtype == BF and torch.isfinite(sd[k].float()).all(), k


def test_bf16_step_count_stops_at_256_like_jax(setup, jax_per_frame):
    """The retention count `s` is stored in the state dtype, as the JAX
    package stores it (fseend_tpu/ops/retention.py:312-313; its kernels
    count in float32 within a call): bf16 holds integers exactly only to
    256, so a step() stream's count stops there in both packages (JAX's
    per-frame XLA server run on to 264 frames against the port's step(),
    K = 1, on the frame-kernel route), while 100-frame blocks add 100 a
    call and keep counting (to 300)."""
    _, _, model, xs = setup
    xla = jax_per_frame[0]
    srv = RT.StreamingServer(kind="ls", cfg=TCFG, model=model, n_lanes=B, n_slots=C,
                             dtype=BF, device="cpu")
    srv.reset_lanes(range(B))
    xla.reset_lanes(range(B))
    frames = np.concatenate([xs[i % 2] for i in range(22)], axis=1)      # (B, 264, in)
    for i in range(22):
        xla.process_block(jnp.asarray(frames[:, i * K:(i + 1) * K], jnp.bfloat16))
    for k in range(frames.shape[1]):
        srv.step(frames[:, k])
    for key, want in (("enc_scale", xla.state["enc"][0]["ret"]["scale"]),
                      ("dec_scale", xla.state["dec"][0]["scale"])):
        want = _np(want)
        assert want.max() == 256.0, (key, want.max())
        np.testing.assert_array_equal(srv.state[key][0].float().numpy(), want)
    srv.reset_lanes(range(B))
    for _ in range(3):
        srv.process_block(frames[:, :100])
    assert float(srv.state["enc_scale"].float().max()) == 300.0
    assert float(srv.state["dec_scale"].float().max()) == 300.0 - JCFG.conv_delay


def test_retention_layer_plain_bf16_against_jax_kernel(setup):
    """B4's bf16 plain version (through its custom op's CPU implementation)
    against `fused_retention_layer(..., interpret=True)` on the same bf16
    weights, input and carried state, two chunks a call: y and the new
    state by the rounding-point rule against the JAX bf16 kernel (both
    carry the state in float32 within the call), and by the drift rule
    against JAX's float32 XLA retention (`retention_chunkwise_stateful`) on
    the same values, the JAX bf16 kernel as yardstick; all that the port
    returns is bf16."""
    params, _, model, _ = setup
    rng = np.random.default_rng(9)
    Bl, Tl, chunk = 3, 16, 8
    rc = JR.RetentionConfig(D, H, 1, chunk)
    p = _cast(params["dec"]["layers"][0]["time_ret"])
    x = jnp.asarray(rng.standard_normal((Bl, Tl, D)), jnp.bfloat16)
    state = {"kv": jnp.asarray(rng.standard_normal((Bl, H, 16, 16)) * 0.3, jnp.bfloat16),
             "scale": jnp.asarray(rng.uniform(1.0, 3.0, (Bl, H, 1, 1)), jnp.bfloat16)}
    jy, jst = jax.jit(lambda p, x, st: fused_retention_layer(p, x, st, rc, True),
                      compiler_options=NO_EXCESS)(p, x, state)
    up = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)
    oy, ost = jax.jit(lambda p, x, st: JR.retention_chunkwise_stateful(p, x, st, rc))(
        up(p), up(x), up(state))
    w = RL.pack_retention(CV.cast_model(copy.deepcopy(model)).dec.layers[0].time_ret)
    gam = TR.decay_gammas(TCFG.ret_cfg)
    with torch.no_grad():
        got = RL.retention_layer(gam, _bf16(x), w, _bf16(state["kv"]), _bf16(state["scale"]),
                                 chunk)
    assert all(t.dtype == BF for t in tuple(got) + tuple(w))
    for what, g, o, j in zip(("y", "kv", "scale"), got, (oy, ost["kv"], ost["scale"]),
                             (jy, jst["kv"], jst["scale"])):
        _drift_ok(g, o, j, f"retention layer {what}")
        if what != "scale":                   # the count is exact in both
            _rounds_like_jax(g, j, o, f"retention layer {what}")


def test_bf16_blockwise_server_against_jax(setup):
    """BlockStreamingServer(kind="ls", dtype=bf16) on the "fused" route (B4's
    bf16 plain version through its op) and the "plain" route, three blocks
    with lane 1 reset after the first: probabilities (from the second block
    on: the first is the warm-up emission) and every state leaf by the
    drift rule against JAX's float32 blockwise server, its bf16 one as
    yardstick; within 0.1 of float32; on the "core" route too (B5's bf16
    plain version)."""
    params, mstate, model, xs = setup
    Kb = 6
    blocks = [xs[i // 2][:, (i % 2) * Kb:(i % 2 + 1) * Kb] for i in range(3)]
    jsrv = JRT.BlockStreamingServer(cfg=JCFG, params=_cast(params), model_state=_cast(mstate),
                                    n_lanes=B, n_slots=C, block=Kb, dtype=jnp.bfloat16)
    yard = _serve(jsrv, blocks, True)
    ref = _serve(JRT.BlockStreamingServer(cfg=JCFG, params=params, model_state=mstate,
                                          n_lanes=B, n_slots=C, block=Kb), blocks, True)
    for route in ("fused", "plain", "core"):
        srv = RT.BlockStreamingServer(kind="ls", cfg=dataclasses.replace(TCFG, kernel=route),
                                      model=model, n_lanes=B, n_slots=C, block=Kb, dtype=BF,
                                      device="cpu")
        got = _serve(srv, blocks, False)
        for i, ((g, gl), (r, rl), (y, yl)) in enumerate(zip(got, ref, yard)):
            if i:
                np.testing.assert_allclose(g, r, atol=PROB_ATOL)
                _drift_ok(g, r, y, f"blockwise {route}: probs")
            for n, (a, b, c) in enumerate(zip(gl, rl, yl)):
                _drift_ok(a, b, c, f"blockwise {route}: state leaf {n}")


def test_bf16_weights_casts_and_mixed_dtypes(setup):
    """cast_model casts every float32 parameter and buffer (the BatchNorm
    statistics too) and leaves integer buffers; the kernels' weights pack
    in the state dtype; a wrapper raises on mixed dtypes; a bf16 gradient
    goes through the retention layer's recompute (held to JAX in
    tests/test_torch_port_bf16_train.py)."""
    _, _, model, _ = setup
    mb = CV.cast_model(copy.deepcopy(model))
    assert {t.dtype for t in mb.parameters()} == {BF}
    bn = mb.enc.blocks[0].conv.bn
    assert bn.running_var.dtype == BF and bn.num_batches_tracked.dtype == torch.int64
    ew, dw = T.pack_weights(mb)
    assert {t.dtype for t in ew + dw} == {BF}
    kv = torch.zeros(L, B * C, H, 16, 16, dtype=BF)
    h0 = torch.zeros(B, K, D, dtype=BF)
    with pytest.raises(ValueError, match="mixed dtypes"):
        DFS.dec_frame_scan(h0, h0, torch.zeros(B, K), torch.zeros(C, D, dtype=BF),
                           dw, kv.float(), torch.zeros(L, B * C, H, dtype=BF))
    with pytest.raises(ValueError, match="float32"):
        DFS.dec_frame_scan(h0, h0, torch.zeros(B, K, dtype=BF), torch.zeros(C, D, dtype=BF),
                           dw, kv, torch.zeros(L, B * C, H, dtype=BF))
    with pytest.raises(ValueError, match="mixed dtypes"):
        EFS.enc_frame_scan(h0, torch.zeros(B, K), EFS.pack_enc_weights(model.enc.blocks),
                           torch.zeros(L, B, H, 16, 16, dtype=BF),
                           torch.zeros(L, B, H, dtype=BF), torch.zeros(L, B, 3, D, dtype=BF),
                           ffac=0.5)
    ret = mb.dec.layers[0].time_ret
    st = TR.chunk_state_init(TCFG.ret_cfg, 2, BF)
    x = torch.ones(2, 8, D, dtype=BF, requires_grad=True)
    y, _, _ = RL.retention_layer(TR.decay_gammas(TCFG.ret_cfg), x, RL.pack_retention(ret),
                                 st["kv"], st["scale"], 8)
    y.float().sum().backward()
    assert y.dtype == x.grad.dtype == BF and torch.isfinite(x.grad.float()).all()
