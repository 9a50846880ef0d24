"""PyTorch port, retention beyond the recurrent mode: the parallel and
chunkwise modes of `fseend_tpu_torch.ops.retention` against the JAX
package's `ops.retention` and the reference goldens, and the plain versions
of the two chunkwise kernels (`kernels/chunk_retention.py`,
`kernels/retention_layer.py`) against the Pallas kernels in interpret mode.

Same numpy inputs and weights on both sides, float32.  Tolerance: atol 2e-4
where a state is carried across chunks or calls (another summation order,
and the port's core divides once by max(inner, cross) where JAX multiplies
by two ratios), 1e-5 against the stored goldens as the JAX package's own
test of them."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import retention_layer_pallas as JKL
from fseend_tpu.kernels import retention_pallas as JKP
from fseend_tpu.ops import retention as JR
from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.ops import retention as TR

torch.set_num_threads(1)
ATOL = 2e-4
D, H, L, T = 32, 4, 8, 24
ROUTES = ("plain", "core", "fused")


def _np(x):
    return np.array(x, dtype=np.float32)


def _pair(value_factor=1, seed=5):
    """The same retention weights (non-zero biases) as a JAX pytree and a
    port module."""
    jcfg = JR.RetentionConfig(D, H, value_factor, L)
    p = JR.init_retention(jax.random.PRNGKey(seed), jcfg)
    m = TR.Retention(TR.RetentionConfig(D, H, value_factor, L))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj"):
            lin = getattr(m, name)
            lin.weight.copy_(torch.as_tensor(_np(p[name]["kernel"]).T))
            lin.bias.copy_(torch.as_tensor(rng.normal(size=lin.bias.shape[0]).astype(np.float32) * 0.1))
            p[name]["bias"] = jnp.asarray(lin.bias.numpy())
    return p, m


def _cfgs(kernel="plain", **kw):
    return (JR.RetentionConfig(D, H, chunk_size=L, **kw),
            TR.RetentionConfig(D, H, chunk_size=L, kernel=kernel, **kw))


def _tstate(jstate):
    return {k: torch.as_tensor(_np(v)) for k, v in jstate.items()}


def _assert_state(tstate, jstate):
    for key in ("kv", "scale"):
        assert tuple(tstate[key].shape) == tuple(jstate[key].shape), key
        np.testing.assert_allclose(tstate[key].numpy(), _np(jstate[key]), atol=ATOL)


@pytest.fixture
def rng():
    return np.random.default_rng(4321)


@pytest.mark.parametrize("use_decay", [False, True])
def test_retention_parallel_matches_jax(rng, use_decay):
    p, m = _pair()
    jcfg, tcfg = _cfgs(use_decay=use_decay)
    x = rng.uniform(0, 1, (3, T, D)).astype(np.float32) * 4
    with jax.default_matmul_precision("highest"):
        want = JR.retention_parallel(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = TR.retention_parallel(m, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


@functools.cache
def _jax_chunkwise(use_decay):
    """JAX's side of test_retention_chunkwise_matches_jax, once per decay
    setting (it is the same for every route)."""
    p, _ = _pair()
    jcfg, _ = _cfgs(use_decay=use_decay)
    x = np.random.default_rng(4321).uniform(0, 1, (3, T, D)).astype(np.float32) * 4
    with jax.default_matmul_precision("highest"):
        want, jst = JR.retention_chunkwise_stateful(p, jnp.asarray(x), None, jcfg)
        want2 = JR.retention_chunkwise(p, jnp.asarray(x), jcfg)
    return x, want, want2, jst


@pytest.mark.parametrize("kernel", ROUTES)
@pytest.mark.parametrize("use_decay", [False, True])
def test_retention_chunkwise_matches_jax(use_decay, kernel):
    """Fresh state, three chunks, inputs large enough that the clamped
    renormalizers are above 1; output and both state leaves."""
    _, m = _pair()
    _, tcfg = _cfgs(kernel, use_decay=use_decay)
    x, want, want2, jst = _jax_chunkwise(use_decay)
    assert float(jnp.max(jst["scale"])) > 1.0
    with torch.no_grad():
        got, tst = TR.retention_chunkwise_stateful(m, torch.as_tensor(x), None, tcfg)
        got2 = TR.retention_chunkwise(m, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    np.testing.assert_allclose(got2.numpy(), _np(want2), atol=ATOL)
    _assert_state(tst, jst)


@functools.cache
def _jax_two_calls(use_decay):
    """JAX's side of test_chunkwise_carried_state_and_two_calls_equal_one,
    once per decay setting."""
    p, _ = _pair()
    jcfg, _ = _cfgs(use_decay=use_decay)
    x = np.random.default_rng(4321).uniform(0, 1, (2, 2 * T, D)).astype(np.float32) * 4
    with jax.default_matmul_precision("highest"):
        y1, st1 = JR.retention_chunkwise_stateful(p, jnp.asarray(x[:, :T]), None, jcfg)
        y2, st2 = JR.retention_chunkwise_stateful(p, jnp.asarray(x[:, T:]), st1, jcfg)
    return x, y1, st1, y2, st2


@pytest.mark.parametrize("kernel", ROUTES)
@pytest.mark.parametrize("use_decay", [False, True])
def test_chunkwise_carried_state_and_two_calls_equal_one(use_decay, kernel):
    """A call continuing from JAX's mid-stream state matches JAX; the input
    state is left as it was; two calls of half the length equal one call."""
    _, m = _pair()
    _, tcfg = _cfgs(kernel, use_decay=use_decay)
    x, y1, st1, y2, st2 = _jax_two_calls(use_decay)
    carried = _tstate(st1)
    before = {k: v.clone() for k, v in carried.items()}
    with torch.no_grad():
        got2, tst2 = TR.retention_chunkwise_stateful(m, torch.as_tensor(x[:, T:]), carried, tcfg)
        full, tstf = TR.retention_chunkwise_stateful(m, torch.as_tensor(x), None, tcfg)
    np.testing.assert_allclose(got2.numpy(), _np(y2), atol=ATOL)
    _assert_state(tst2, st2)
    for key in before:
        assert torch.equal(carried[key], before[key]), key
    np.testing.assert_allclose(full.numpy(), np.concatenate([_np(y1), _np(y2)], 1), atol=ATOL)
    _assert_state(tstf, st2)


@pytest.mark.parametrize("kernel", ROUTES)
def test_chunkwise_value_factor_two(rng, kernel):
    p, m = _pair(value_factor=2)
    jcfg = JR.RetentionConfig(D, H, 2, L)
    tcfg = TR.RetentionConfig(D, H, 2, L, kernel=kernel)
    x = rng.uniform(0, 1, (2, T, D)).astype(np.float32) * 4
    with jax.default_matmul_precision("highest"):
        want, jst = JR.retention_chunkwise_stateful(p, jnp.asarray(x), None, jcfg)
    with torch.no_grad():
        got, tst = TR.retention_chunkwise_stateful(m, torch.as_tensor(x), None, tcfg)
    assert tst["kv"].shape == (2, H, D // H, 2 * D // H)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    _assert_state(tst, jst)


def test_chunk_state_is_not_the_recurrent_state():
    cfg = TR.RetentionConfig(D, H, 2, L)
    chunk, rec = TR.chunk_state_init(cfg, 3), TR.retention_state_init(cfg, 3)
    jchunk = JR.chunk_state_init(JR.RetentionConfig(D, H, 2, L), 3)
    for key in ("kv", "scale"):
        np.testing.assert_array_equal(chunk[key].numpy(), _np(jchunk[key]))
    assert chunk["kv"].shape == (3, H, 8, 16) and rec["kv"].shape == (3, H, 16, 8)
    assert (chunk["scale"] == 1).all() and not rec["scale"].any()


@pytest.mark.parametrize("kernel", ROUTES)
def test_reference_goldens(kernel):
    """The reference MultiScaleRetention's stored outputs, read the way
    tests/test_retention.py reads them; chunkwise and parallel each have
    their own golden (the reference's two normalizations differ)."""
    g = np.load(pathlib.Path(__file__).parent / "goldens" / "retention_ref.npz")
    cfg = TR.RetentionConfig(int(g["D"]), int(g["H"]), 1, int(g["L"]), kernel=kernel)
    m = TR.Retention(cfg)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj"):
            getattr(m, name).weight.copy_(torch.as_tensor(g[f"{name}_w"]))
            getattr(m, name).bias.copy_(torch.as_tensor(g[f"{name}_b"]))
        x = torch.as_tensor(g["x"])
        np.testing.assert_allclose(TR.retention_parallel(m, x, cfg).numpy(),
                                   g["y_parallel"], atol=1e-5)
        np.testing.assert_allclose(TR.retention_chunkwise(m, x, cfg).numpy(),
                                   g["y_chunkwise"], atol=1e-5)
        np.testing.assert_allclose(TR.retention_recurrent(m, x, cfg).numpy(),
                                   g["y_parallel"], atol=1e-5)


def test_unported_and_unknown_settings_raise():
    # xpos is ported (tests/test_torch_port_a19.py): the "fused" route runs
    # the plain one under it, as the JAX package's fused layer skips itself
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((2, T, D)).astype(np.float32))
    _, m = _pair()
    fused, plain = (TR.retention_chunkwise(m, x, TR.RetentionConfig(D, H, 1, L, use_xpos=True,
                                                                   kernel=k))
                    for k in ("fused", "plain"))
    assert torch.equal(fused, plain)
    with pytest.raises(ValueError, match="kernel"):
        TR.RetentionConfig(D, H, kernel="pallas")
    _, m = _pair()
    with pytest.raises(ValueError, match="multiple"):
        TR.retention_chunkwise(m, torch.zeros(1, L + 1, D), TR.RetentionConfig(D, H, 1, L))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma", [1.0, 0.9])
def test_chunk_retention_plain_matches_pallas_kernel(rng, gamma):
    """Carried non-trivial state, three chunks, per-row gamma; out and both
    state leaves.  The wrapper on CPU tensors is the plain version."""
    BH, dk, dv = 6, 16, 8
    q = (rng.standard_normal((BH, T, dk)) * 0.8).astype(np.float32)
    k = (rng.standard_normal((BH, T, dk)) * 0.8).astype(np.float32)
    v = rng.standard_normal((BH, T, dv)).astype(np.float32)
    kv0 = (rng.standard_normal((BH, dk, dv)) * 2).astype(np.float32)
    s0 = np.abs(kv0).sum(1, keepdims=True).max(2, keepdims=True).clip(1, None)
    gam = np.full((BH,), gamma, np.float32)
    if gamma < 1:
        gam[::2] = 0.97                          # rows differ
    want = JKP.chunkwise_retention_stateful(*(jnp.asarray(a) for a in (gam, q, k, v, kv0, s0)),
                                            L, interpret=True)
    args = [torch.as_tensor(a) for a in (gam, q, k, v, kv0, s0)]
    with torch.no_grad():
        plain = CR.chunk_retention_plain(*args, L)
        n0 = CR.launches
        wrapped = CR.chunk_retention(*args, L)
    assert CR.launches == n0                     # no kernel launch on the CPU
    assert float(want[2].max()) > 1.0
    for got_leaf, wrap_leaf, want_leaf in zip(plain, wrapped, want):
        assert tuple(got_leaf.shape) == tuple(want_leaf.shape)
        np.testing.assert_allclose(got_leaf.numpy(), _np(want_leaf), atol=ATOL)
        assert torch.equal(got_leaf, wrap_leaf)


def test_chunk_retention_checks_its_arguments(rng):
    args = [torch.ones(2), torch.zeros(2, 8, 16), torch.zeros(2, 8, 16), torch.zeros(2, 8, 16),
            torch.zeros(2, 16, 16), torch.ones(2, 1, 1)]
    with pytest.raises(ValueError, match="multiple"):
        CR.chunk_retention(*args, 3)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(ValueError, match="float32"):
        CR.chunk_retention(*bad, 8)
    bad = list(args)
    bad[4] = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="kv0"):
        CR.chunk_retention(*bad, 8)


@pytest.mark.parametrize("case", ["fresh", "carried", "multi_chunk", "decay"])
def test_retention_layer_plain_matches_pallas_kernel(rng, case):
    """Fresh state, a carried mid-stream state, five chunks in one call, and
    the gamma < 1 schedule, as tests/test_retention_layer_pallas.py runs the
    Pallas kernel."""
    use_decay = case == "decay"
    Tn = 40 if case == "multi_chunk" else T
    p, m = _pair(seed=3)
    jcfg, tcfg = _cfgs(use_decay=use_decay)
    x = (rng.standard_normal((4, 2 * Tn, D)) * 2).astype(np.float32)
    jstate = None
    if case in ("carried", "decay"):
        with jax.default_matmul_precision("highest"):
            _, jstate = JR.retention_chunkwise_stateful(p, jnp.asarray(x[:, :Tn]), None, jcfg)
    with jax.default_matmul_precision("highest"):
        want, jst = JKL.fused_retention_layer(p, jnp.asarray(x[:, Tn:]), jstate, jcfg, True)
    tstate = _tstate(jstate) if jstate else TR.chunk_state_init(tcfg, 4)
    with torch.no_grad():
        got, kv_f, s_f = RL.retention_layer_plain(
            TR.decay_gammas(tcfg), torch.as_tensor(x[:, Tn:]), RL.pack_retention(m),
            tstate["kv"], tstate["scale"], L)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    _assert_state({"kv": kv_f, "scale": s_f}, jst)


def test_retention_layer_checks_its_arguments():
    _, m = _pair()
    w = RL.pack_retention(m)
    assert w.wqkvg.shape == (D, 4 * D) and w.wo.shape == (D, D)     # (in, out)
    cfg = TR.RetentionConfig(D, H, 1, L)
    st = TR.chunk_state_init(cfg, 2)
    gam = TR.decay_gammas(cfg)
    with pytest.raises(ValueError, match="multiple"):
        RL.retention_layer(gam, torch.zeros(2, L + 1, D), w, st["kv"], st["scale"], L)
    with pytest.raises(ValueError, match="mixed dtypes"):
        RL.retention_layer(gam, torch.zeros(2, L, D, dtype=torch.bfloat16), w, st["kv"],
                           st["scale"], L)
    with pytest.raises(ValueError, match="s0"):
        RL.retention_layer(gam, torch.zeros(2, L, D), w, st["kv"], st["scale"][:, :, 0], L)
