"""PyTorch port, FS-EEND serving and the chunkwise core in bf16: the bf16
plain versions of B6 `cached_attention_perlane`, B7 `cached_attention` and
B5 `chunk_retention` against the JAX package's Pallas kernels in interpret
mode; `mha_core` in bf16 against the JAX function; both FS-EEND bf16
servers (per-frame fast block with a lane reset and `step()` interleaved,
and blockwise) and `ls_forward` in bf16 on the "core" route against the
JAX package's bf16 and float32 passes; the dtype checks and the wrappers'
float32 scratch.

Inputs and weights come from a numpy seed (the port's initializer, carried
into the JAX tree) and are cast to bf16 in both packages.  Tolerances:

* the one-block rule, where both sides compute the same function on the
  same bf16 values: mean |port bf16 - JAX bf16| <= 0.05 * mean |JAX bf16 -
  JAX float32 on the same values|, and for the cached attention, over the
  same kv blocks (one block over the whole cache, `block_kv` = cap, or
  blocks of 16 on both sides), every output within 2 bf16 ulps of its
  row's magnitude.  Controls that round the normalized weights (the
  `mha_core` form) instead of the unnormalized probabilities, or sum the
  row's `l` from the rounded ones, fail it;
* the drift rule of the JAX package's own bf16 test
  (tests/test_dec_frame_scan.py:96-122): max |port bf16 - JAX float32| <=
  3 * max |JAX bf16 yardstick - JAX float32| + 1e-3, for the one-block
  plain version against the kernels at a `block_kv` smaller than the cache
  (another running max) and for the servers and the batch pass (the
  yardstick: JAX's bf16 server or pass);
* served probabilities within 0.1 of JAX's float32 server
  (tests/test_serving.py:165-183); states bf16 and finite.

The JAX programs of the one-block rule are compiled with
`xla_allow_excess_precision` off (tests/test_torch_port_bf16.py says why).
Tiny widths: FS in_size 20, 32 units, 2 heads (head dim 16), one encoder
and one decoder layer, 3 slots, capacity 64; B5 at 8 rows, 64 frames,
chunks of 16."""

import contextlib
import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels.cached_attention_pallas import (flash_cached_attention,
                                                        flash_cached_attention_perlane)
from fseend_tpu.kernels.retention_pallas import chunkwise_retention_stateful
from fseend_tpu.models import fs_eend as J
from fseend_tpu.models import ls_eend as JL
from fseend_tpu.ops import nn as JNN
from fseend_tpu.serving import runtime as JRT
from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.kernels import cached_attention as CA
from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.models import fs_eend as T
from fseend_tpu_torch.models import ls_eend as TL
from fseend_tpu_torch.ops import nn as TNN
from fseend_tpu_torch.serving import runtime as RT
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.FSEENDConfig(in_size=20, n_units=32, n_heads=2, enc_n_layers=1, dec_n_layers=1,
                      enc_dim_feedforward=48, dec_dim_feedforward=48, conv_delay=3,
                      max_nspks=3, dropout=0.0)
TCFG = T.FSEENDConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
LCFG = JL.LSEENDConfig(in_size=20, n_units=64, n_heads=4, enc_n_layers=1, dec_n_layers=1,
                       conv_kernel_size=4, dec_dim_feedforward=48, conv_delay=2, max_nspks=2,
                       chunk_size=16, dropout=0.0, use_pallas=True)
B, C, CAP, K, SUB = 2, 3, 64, 8, 4
BF = torch.bfloat16
PROB_ATOL = 0.1
ROUND_SHARE = 0.05
NO_EXCESS = {"xla_allow_excess_precision": False}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(a) -> torch.Tensor:
    return torch.as_tensor(_f32(a)).to(BF).contiguous()


def _cast(tree):
    """The JAX package's bf16 cast (bench.py:508-511)."""
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if hasattr(x, "dtype") and x.dtype == jnp.float32 else x, tree)


def _drift_ok(port, ref, yard, what):
    err = float(np.abs(_f32(port) - _f32(ref)).max())
    err_y = float(np.abs(_f32(yard) - _f32(ref)).max())
    assert err <= 3.0 * err_y + 1e-3, (what, err, err_y)


def _one_block_ok(port, jax_bf16, f32, what):
    near = float(np.abs(_f32(port) - _f32(jax_bf16)).mean())
    drift = float(np.abs(_f32(jax_bf16) - _f32(f32)).mean())
    assert drift > 0 and near <= ROUND_SHARE * drift, (what, near, drift)


def _ulps_ok(port, jax_bf16, what, n=2):
    """Every output within n bf16 ulps of its row's largest magnitude."""
    want = _f32(jax_bf16)
    mag = np.abs(want).max(-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(_f32(port) - want) <= n * ulp).all(), (what, float(
        (np.abs(_f32(port) - want) / ulp).max()))


@pytest.fixture(scope="module", autouse=True)
def _quick_compiles():
    """XLA's optimization passes off while this file compiles its JAX
    programs (the same arithmetic)."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


# ---------------------------------------------------------------------------
# B6, B7: the cached attention's bf16 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

HD, R, RPL = 16, 16, 4
# (form, K, starts, min_pos): lanes before warm-up (start < min_pos), starts
# whose queries run past the capacity, K = 1 (the step() call); the
# shared-head form has one start for its 16 rows
CA_CASES = [("perlane", 6, [0, 2, 30, 60], 3), ("perlane", 1, [1, 9, 40, 80], 9),
            ("shared", 8, [40], 0), ("shared", 8, [60], 0)]


@pytest.fixture(scope="module")
def ca_cases():
    """Per case: the bf16 inputs, the JAX bf16 kernel with one kv block and
    with blocks of 16, and the JAX kernel in float32 on the same values."""
    rng = np.random.default_rng(3)
    progs, out = {}, []

    def run(form, k_, min_pos, dt, bkv, *args):
        key = (form, k_, min_pos, dt, bkv)
        if key not in progs:
            if form == "perlane":
                fn = lambda *a: flash_cached_attention_perlane(  # noqa: E731
                    *a, rows_per_lane=RPL, min_pos=min_pos, interpret=True, block_kv=bkv)
            else:
                fn = lambda *a: flash_cached_attention(  # noqa: E731
                    *a[:3], a[3][0], interpret=True, block_kv=bkv)
            progs[key] = jax.jit(fn, compiler_options=NO_EXCESS)
        got = progs[key](*(a.astype(dt) for a in args[:3]), args[3])
        return np.asarray(got.astype(jnp.float32))

    for case in CA_CASES:
        form, k_, starts, min_pos = case
        q, k, v = (jnp.asarray(rng.standard_normal((R, n, HD)) * s, jnp.bfloat16)
                   for n, s in ((k_, 1.5), (CAP, 1.5), (CAP, 1.0)))
        st = jnp.asarray(starts, jnp.int32)
        out.append((case, (q, k, v), *(run(form, k_, min_pos, dt, bkv, q, k, v, st) for dt, bkv in
                                        ((jnp.bfloat16, CAP), (jnp.bfloat16, 16),
                                         (jnp.float32, CAP)))))
    return out


def _port_ca(case, q, k, v, **kw):
    form, _, starts, min_pos = case
    q, k, v = (_bf16(a) for a in (q, k, v))
    if form == "perlane":
        return CA.cached_attention_perlane_plain(q, k, v, torch.tensor(starts, dtype=torch.int32),
                                                 RPL, min_pos, **kw)
    return CA.cached_attention_plain(q, k, v, starts[0], **kw)


@pytest.mark.parametrize("form", ["perlane", "shared"])
def test_cached_attention_bf16_plain_rounds_like_the_pallas_kernel(ca_cases, form):
    """B6's and B7's bf16 plain versions (what the wrappers run on the CPU)
    against the Pallas kernels in bf16: the one-block rule with `block_kv`
    = cap, the drift rule with blocks of 16; over tiles of 16 (the form the
    CUDA kernels are held to, with their own tiles) the one-block rule
    against blocks of 16, and splits of 32 within the drift rule; a bf16
    result."""
    for case, (q, k, v), one, small, f32 in ca_cases:
        if case[0] != form:
            continue
        got = _port_ca(case, q, k, v)
        via = (CA.cached_attention_perlane(_bf16(q), _bf16(k), _bf16(v),
                                           torch.tensor(case[2], dtype=torch.int32), RPL,
                                           case[3]) if form == "perlane"
               else CA.cached_attention(_bf16(q), _bf16(k), _bf16(v), case[2][0]))
        assert got.dtype == BF and torch.equal(via, got)
        _one_block_ok(got, one, f32, case)
        _ulps_ok(got, one, case)
        _drift_ok(got, f32, small, case)
        tiled = _port_ca(case, q, k, v, tile=16)
        _one_block_ok(tiled, small, f32, (case, "tiles of 16"))
        _ulps_ok(tiled, small, (case, "tiles of 16"))
        _drift_ok(_port_ca(case, q, k, v, tile=16, split=32), f32, small, (case, "splits"))


def test_rounding_control_fails_the_one_block_rule(ca_cases):
    """Two variants built here, against the Pallas kernel's rounding of the
    unnormalized probabilities with the row sum taken unrounded: one rounds
    the normalized weights to bf16 (the `mha_core` form) before the value
    product, one sums the row from the rounded probabilities.  Each misses
    the one-block rule on the K > 1 cases, which the port's plain versions
    meet."""
    for case, (q, k, v), one, _, f32 in ca_cases:
        if case[1] == 1:
            continue
        form, k_, starts, min_pos = case
        qf, kf, vf = (torch.as_tensor(_f32(a)) for a in (q, k, v))
        cap = kf.shape[1]
        st = torch.tensor(starts).repeat_interleave(RPL if form == "perlane" else R)
        pos = torch.arange(cap)[None, None, :]
        qpos = st[:, None, None] + torch.arange(k_)[None, :, None]
        ok = ((pos <= qpos) & (pos >= min_pos)) | (pos == qpos)
        s = torch.where(ok, (qf @ kf.transpose(1, 2)) * HD ** -0.5, -1e30)
        w = torch.softmax(s, dim=-1).to(BF).float()
        pr = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0).to(BF).float()
        drift = float(np.abs(one - f32).mean())
        # the controls, and the plain versions' `mha_core` form (the servers'
        # plain route, which is the first control's arithmetic)
        for what, control in (("control", (w @ vf).to(BF)),
                              ("rounded row sum", ((pr @ vf) / pr.sum(-1, keepdim=True)).to(BF)),
                              ("mha form", _port_ca(case, q, k, v, mha=True))):
            near = float(np.abs(_f32(control) - one).mean())
            assert near > ROUND_SHARE * drift, (case, what, near, drift)


# ---------------------------------------------------------------------------
# B5: the chunkwise core's bf16 plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def test_chunk_retention_bf16_plain_against_pallas():
    """From a carried bf16 state, gamma = 1 and gamma < 1: out and kv by the
    one-block rule against `chunkwise_retention_stateful(..., interpret=True)`
    in bf16 (both carry the state in float32 within the call), the scale by
    the drift rule; a float32 state with bf16 data is refused."""
    rng = np.random.default_rng(11)
    BH, Tn, L, dk = 8, 64, 16, 16
    q, k, v = (jnp.asarray(rng.standard_normal((BH, Tn, dk)) * s, jnp.bfloat16)
               for s in (1.0, 0.25, 1.0))
    kv0 = jnp.asarray(rng.standard_normal((BH, dk, dk)) * 0.5, jnp.bfloat16)
    s0 = jnp.asarray(rng.uniform(1.0, 3.0, (BH, 1, 1)), jnp.bfloat16)
    run = jax.jit(lambda *a: chunkwise_retention_stateful(*a, L, interpret=True),
                  compiler_options=NO_EXCESS)
    for gam in (np.ones(BH, np.float32),
                (1.0 - np.exp2(-5.0 - np.arange(BH) % 4)).astype(np.float32)):
        g = jnp.asarray(gam, jnp.float32)
        jb = run(g, q, k, v, kv0, s0)
        jf = run(g, *(a.astype(jnp.float32) for a in (q, k, v, kv0, s0)))
        got = CR.chunk_retention(torch.as_tensor(gam), *(_bf16(a) for a in (q, k, v, kv0, s0)),
                                 L)
        assert all(t.dtype == BF for t in got)
        for what, a, b, c in zip(("out", "kv", "scale"), got, jb, jf):
            _drift_ok(a, c, b, f"gamma {gam[-1]}: {what}")
            if what != "scale":
                _one_block_ok(a, b, c, f"gamma {gam[-1]}: {what}")
    with pytest.raises(ValueError, match="mixed dtypes"):
        CR.chunk_retention(torch.as_tensor(gam), *(_bf16(a) for a in (q, k, v)),
                           torch.zeros(BH, dk, dk), torch.ones(BH, 1, 1), L)


def test_mha_core_bf16_against_jax():
    """The port's `mha_core` on bf16 q, k, v under a causal mask against the
    JAX function (float32 logits and softmax, the normalized weights rounded
    to bf16) by the one-block rule; the logits are not rounded to bf16 (a
    variant with bf16 logits misses it)."""
    rng = np.random.default_rng(4)
    q, k, v = (jnp.asarray(rng.standard_normal((3, 2, 12, 16)) * 1.5, jnp.bfloat16)
               for _ in range(3))
    mask = jnp.where(jnp.arange(12)[None, :] <= jnp.arange(12)[:, None], 0.0, -jnp.inf)
    run = jax.jit(JNN.mha_core, compiler_options=NO_EXCESS)
    jb = run(q, k, v, mask)
    jf = run(*(a.astype(jnp.float32) for a in (q, k, v)), mask)
    tm = torch.as_tensor(np.asarray(mask))
    got = TNN.mha_core(*(_bf16(a) for a in (q, k, v)), tm)
    assert got.dtype == BF
    _one_block_ok(got, jb, jf, "mha_core")
    qb, kb, vb = (_bf16(a) for a in (q, k, v))
    logits_bf16 = (qb @ kb.transpose(-1, -2)) / 4.0 + tm.to(BF)
    control = (torch.softmax(logits_bf16.float(), -1).to(BF).float() @ vb.float()).to(BF)
    assert float(np.abs(_f32(control) - _f32(jb)).mean()) > ROUND_SHARE * float(
        np.abs(_f32(jb) - _f32(jf)).mean())


# ---------------------------------------------------------------------------
# the FS-EEND bf16 servers against the JAX package's
# ---------------------------------------------------------------------------


def _jax_tree(model, init, cfg):
    """The JAX parameter pytree of a port model and its model_state."""
    to_jax = CV.fs_params_to_jax if isinstance(model, T.FSEEND) else CV.ls_params_to_jax
    tree, mstate = to_jax(model)
    shapes, _ = jax.eval_shape(lambda kk: init(kk, cfg), jax.random.PRNGKey(0))

    def leaf(path, _):
        node = tree
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        return jnp.asarray(node)

    return jax.tree_util.tree_map_with_path(leaf, shapes), jax.tree.map(jnp.asarray, mstate)


@pytest.fixture(scope="module")
def fs_setup():
    model = T.init_fs_eend(TCFG, torch.Generator().manual_seed(8), device="cpu")
    rng = np.random.default_rng(21)
    with torch.no_grad():
        model.enc.bn.running_mean.copy_(torch.as_tensor(rng.normal(0, 0.2, JCFG.in_size)))
        model.enc.bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, JCFG.in_size)))
    params, mstate = _jax_tree(model, J.init_fs_eend, JCFG)
    xs = rng.standard_normal((3, B, K, JCFG.in_size)).astype(np.float32)
    return model, params, mstate, xs


def _per_frame_calls(srv, xs, jax_side):
    """Block 0, lane 1 reset, two step() frames, block 1: each call's
    probabilities and valid flags (float32 numpy), and the final state's
    leaves in the JAX layout."""
    cast = (lambda a: jnp.asarray(a, srv.dtype)) if jax_side else (lambda a: a)
    outs = [srv.process_block(cast(xs[0]))]
    srv.reset_lanes([1])
    for i in range(2):
        p, vd = srv.step(cast(xs[2][:, i]))
        outs.append((p[:, None], vd[None]))
    outs.append(srv.process_block(cast(xs[1])))
    got = []
    for p, vd in outs:
        assert jax_side or p.dtype == torch.float32
        got.append((_f32(p), np.asarray(vd).T if jax_side else vd.numpy().T))
    state = (jax.tree.map(np.asarray, srv.state) if jax_side
             else CV.fs_state_to_numpy(srv.state))
    return got, [_f32(a) for a in jax.tree.leaves(state)]


def _bf16_state_ok(state):
    for key, t in state.items():
        if t.is_floating_point():
            assert t.dtype == BF and torch.isfinite(t.float()).all(), key


def test_fs_bf16_per_frame_server_against_jax(fs_setup):
    """StreamingServer(kind="fs", dtype=bf16), fast block in sub-blocks of 4
    on both routes (the kernels' bf16 plain versions; `mha_core` in bf16),
    a lane reset and `step()` between two blocks: probabilities on the valid
    frames and every state leaf by the drift rule against JAX's float32
    server, JAX's bf16 server as yardstick; within 0.1 of float32; the state
    bf16 and finite and its converter round trip bit for bit."""
    model, params, mstate, xs = fs_setup

    def jsrv(dt, p, m):
        return JRT.StreamingServer(kind="fs", cfg=JCFG, params=p, model_state=m, n_lanes=B,
                                   n_slots=C, capacity=CAP, fs_fast_chunk=SUB, dtype=dt)

    with jax.default_matmul_precision("highest"):
        ref, ref_leaves = _per_frame_calls(jsrv(jnp.float32, params, mstate), xs, True)
    jb = jsrv(jnp.bfloat16, _cast(params), _cast(mstate))
    yard, yard_leaves = _per_frame_calls(jb, xs, True)
    for flash in (True, False):
        srv = RT.StreamingServer(kind="fs", cfg=dataclasses.replace(TCFG, use_flash_attn=flash),
                                 model=model, n_lanes=B, n_slots=C, capacity=CAP,
                                 fs_fast_chunk=SUB, dtype=BF, device="cpu")
        got, leaves = _per_frame_calls(srv, xs, False)
        _bf16_state_ok(srv.state)
        for i, ((g, gv), (r, rv), (y, _)) in enumerate(zip(got, ref, yard)):
            np.testing.assert_array_equal(gv, rv)
            _drift_ok(g[rv], r[rv], y[rv], f"flash={flash}, call {i}: probs")
            np.testing.assert_allclose(g[rv], r[rv], atol=PROB_ATOL)
        for n, (a, b, c) in enumerate(zip(leaves, ref_leaves, yard_leaves)):
            _drift_ok(a, b, c, f"flash={flash}: state leaf {n}")
    back = CV.fs_state_from_jax(jax.tree.map(np.asarray, jb.state), "cpu")
    for key, t in back.items():
        assert t.dtype == (BF if t.is_floating_point() else torch.int32), key
    for a, b in zip(jax.tree.leaves(CV.fs_state_to_numpy(back)), yard_leaves):
        np.testing.assert_array_equal(a, b)
    assert next(model.parameters()).dtype == torch.float32


def test_fs_bf16_blockwise_server_against_jax(fs_setup):
    """BlockStreamingServer(kind="fs", dtype=bf16) on both routes (B7's bf16
    plain version through its op, and `mha_core`), three blocks and the
    flush: probabilities (from the second call on) and every state leaf by
    the drift rule against JAX's float32 blockwise server, its bf16 one as
    yardstick; within 0.1 of float32; the converters carry the bf16 state."""
    model, params, mstate, xs = fs_setup
    Kb = K

    def jrun(dt, p, m):
        srv = JRT.BlockStreamingServer(kind="fs", cfg=JCFG, params=p, model_state=m, n_lanes=B,
                                       n_slots=C, block=Kb, capacity=CAP, dtype=dt)
        outs = [_f32(srv.process_block(jnp.asarray(x, dt))) for x in xs]
        outs.append(_f32(srv.process_block(jnp.zeros_like(jnp.asarray(xs[0], dt)), flush=True)))
        return outs, srv.state

    with jax.default_matmul_precision("highest"):
        ref, ref_state = jrun(jnp.float32, params, mstate)
    yard, yard_state = jrun(jnp.bfloat16, _cast(params), _cast(mstate))
    rl, yl = ([_f32(a) for a in jax.tree.leaves(s)] for s in (ref_state, yard_state))
    for flash in (True, False):
        srv = RT.BlockStreamingServer(kind="fs",
                                      cfg=dataclasses.replace(TCFG, use_flash_attn=flash),
                                      model=model, n_lanes=B, n_slots=C, block=Kb, capacity=CAP,
                                      dtype=BF, device="cpu")
        got = [srv.process_block(x) for x in xs] + [
            srv.process_block(np.zeros_like(xs[0]), flush=True)]
        _bf16_state_ok(srv.state)
        for i, (g, r, y) in enumerate(zip(got, ref, yard)):
            assert g.dtype == torch.float32
            if i:
                _drift_ok(g, r, y, f"blockwise flash={flash}: block {i}")
                np.testing.assert_allclose(g.numpy(), r, atol=PROB_ATOL)
        leaves = [_f32(a) for a in jax.tree.leaves(CV.fs_blockstate_to_numpy(srv.state))]
        for n, (a, b, c) in enumerate(zip(leaves, rl, yl)):
            _drift_ok(a, b, c, f"blockwise flash={flash}: state leaf {n}")
    back = CV.fs_blockstate_from_jax(jax.tree.map(np.asarray, yard_state), "cpu")
    assert back["enc_k"].dtype == back["h_prev"].dtype == BF
    for a, b in zip(jax.tree.leaves(CV.fs_blockstate_to_numpy(back)), yl):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# LS-EEND's batch pass in bf16 on the "core" route
# ---------------------------------------------------------------------------


def test_ls_forward_bf16_core_route_against_jax():
    """`ls_forward` on a bf16 model (cast_model) on the "core" route (B5's
    bf16 plain version from a fresh bf16 state: zeros and ones, which bf16
    holds exactly, so the JAX package's float32 seed gives the same output)
    and on the "plain" route, against JAX's bf16 `use_pallas`
    batch pass (the Pallas core in interpret mode) as yardstick and JAX's
    float32 pass as oracle, by the drift rule; float32 logits, bf16
    embeddings; a mixed call raises."""
    tcfg = TL.LSEENDConfig(**{f.name: getattr(LCFG, f.name)
                              for f in dataclasses.fields(TL.LSEENDConfig)
                              if hasattr(LCFG, f.name)})
    model = TL.init_ls_eend(dataclasses.replace(tcfg, kernel="core"),
                            torch.Generator().manual_seed(6), device="cpu")
    params, mstate = _jax_tree(model, JL.init_ls_eend, LCFG)
    rng = np.random.default_rng(6)
    xs = rng.standard_normal((2, 40, LCFG.in_size)).astype(np.float32)
    lens = np.array([40, 29])
    ref = jax.jit(lambda p, m, x: JL.ls_forward(p, m, dataclasses.replace(LCFG, use_pallas=False),
                                                x, jnp.asarray(lens), 2))
    with jax.default_matmul_precision("highest"):
        want = ref(params, mstate, jnp.asarray(xs))
    yard = jax.jit(lambda p, m, x: JL.ls_forward(p, m, LCFG, x, jnp.asarray(lens), 2))(
        _cast(params), _cast(mstate), jnp.asarray(xs, jnp.bfloat16))
    mb = CV.cast_model(copy.deepcopy(model))
    xb = torch.as_tensor(xs).to(BF)
    for route in ("core", "plain"):
        got = TL.ls_forward(TL.with_cfg(mb, dataclasses.replace(tcfg, kernel=route)), xb,
                            torch.as_tensor(lens), 2)
        assert got["logits"].dtype == torch.float32 and got["emb"].dtype == BF
        for key in ("logits", "emb", "attractors"):
            _drift_ok(got[key], want[key], yard[key], f"ls_forward {route}: {key}")
    with pytest.raises(ValueError, match="both bf16"):
        TL.ls_forward(mb, torch.as_tensor(xs), torch.as_tensor(lens), 2)


# ---------------------------------------------------------------------------
# dtype checks and the float32 scratch
# ---------------------------------------------------------------------------


def test_bf16_dtype_checks_and_float32_scratch(fs_setup, monkeypatch):
    """Mixed dtypes raise in both wrappers and in the FS modes; the core's
    bf16 gradient and `fs_forward` in bf16 run (bf16 training, held to JAX
    in tests/test_torch_port_bf16_train.py); the wrappers hand their bf16
    kernels float32 scratch of the size the kernels ask for (a fake library
    stands in for the CUDA one)."""
    model, *_ = fs_setup
    q = torch.zeros(4, 3, 16, dtype=BF)
    kv = torch.zeros(4, 8, 16, dtype=BF)
    with pytest.raises(ValueError, match="mixed dtypes"):
        CA.cached_attention(q, kv.float(), kv.float(), 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        CA.cached_attention(q.half(), kv.half(), kv.half(), 0)
    g = torch.ones(4)
    st = (torch.zeros(4, 16, 16, dtype=BF), torch.ones(4, 1, 1, dtype=BF))
    with pytest.raises(ValueError, match="mixed dtypes"):
        CR.chunk_retention(g, kv, kv.float(), kv, *st, 8)
    with pytest.raises(ValueError, match="mixed dtypes"):
        CR.chunk_retention(g.to(BF), kv, kv, kv, *st, 8)
    qg = kv.clone().requires_grad_()
    CR.chunk_retention(g, qg, kv, kv, *st, 8)[0].float().sum().backward()
    assert qg.grad.dtype == BF
    mb = CV.cast_model(copy.deepcopy(model))
    x = torch.zeros(B, 5, JCFG.in_size)
    out = T.fs_forward(mb, x.to(BF), torch.tensor([5, 5]), C)
    assert out["logits"].dtype == torch.float32 and out["emb"].dtype == BF
    with pytest.raises(ValueError, match="the model"):
        T.fs_forward(mb, x, torch.tensor([5, 5]), C)
    state = T.fs_stream_init(TCFG, B, CAP, C, BF, "cpu")
    with pytest.raises(ValueError, match="the model"):
        T.fs_framestream_block(mb, state, x, C, torch.zeros(B, 5, dtype=torch.bool))

    allocated, seen = [], {}
    real_empty = torch.empty

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        allocated.append(t)
        return t

    class Fn:
        def __init__(self, name, ret=0):
            self.name, self.ret = name, ret

        def __call__(self, *args):
            seen[self.name] = args
            return self.ret

    class Lib:
        def __init__(self, n):
            self.cached_attention_perlane_scratch = Fn("ca_scratch", n)
            self.cached_attention_perlane_launch = Fn("ca")
            self.chunk_retention_launch = Fn("cr")

    monkeypatch.setattr(_build, "load", lambda name, defines: Lib(4 * 3 * 18))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", empty)
    CA._launch(q[:, :1].contiguous(), kv, kv, torch.zeros(2, dtype=torch.int32), 2, 0, True)
    part = [t for t in allocated if t.data_ptr() == seen["ca"][5]]
    assert part and part[0].dtype == torch.float32 and part[0].numel() == 4 * 3 * 18
    allocated.clear()
    q5, kv0, s0 = torch.zeros(4, 32, 16, dtype=BF), *st
    CR._launch(g, q5, q5, q5, kv0, s0, 8)
    scratch = [t for t in allocated if t.data_ptr() == seen["cr"][9]]
    assert scratch and scratch[0].dtype == torch.float32
    assert scratch[0].numel() == 4 * 4 * (16 * 16 + 1)
