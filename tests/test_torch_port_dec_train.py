"""PyTorch port, the decoder fusion layer in training semantics
(`fseend_tpu_torch/kernels/dec_train_fusion.py`): the dropout hash bit for
bit against the JAX kernel's `_hash_keep`; the plain forward against the
JAX kernel in interpret mode and the plain backward against `jax.vjp` of
the JAX package's own chunk body `_chunk_fwd` looped over the chunks (the
oracle the JAX kernel's backward is held to), both with dropout off and on
(the same masks by construction); the plain backward against torch autograd
of the plain forward; the autograd Function; the end-padding of the fused
decoder.

Small shapes (D 16, 2 heads, F 24, C 3, T 16, L 8, B 2); the same weights
and inputs on both sides, float32.  Tolerance 2e-5 on forward outputs
(another summation order through one layer), 2e-4 on gradients (as the JAX
package's test of its backward)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import dec_train_fusion_pallas as JDT
from fseend_tpu.models import ls_eend as J
from fseend_tpu_torch.kernels import dec_train_fusion as DT
from fseend_tpu_torch.models import ls_eend as T
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
B, C, T0, D, H, F, L = 2, 3, 16, 16, 2, 24, 8
SEED = 1234
RATES = (0.0, 0.1)


def _weights(lp) -> DT.FusionWeights:
    """The JAX kernel's packed operands in the port's (out, in) layout."""
    ops = [np.asarray(o) for o in JDT._pack(lp, jnp.float32)]
    wq, bq, wro, bro, wmi, bmi, wmo, bmo, wf1, bf1, wf2, bf2, lns, lnb = ops
    return DT.FusionWeights(*(torch.as_tensor(np.array(a)) for a in (
        wq.T, bq[0], wro.T, bro[0], wmi.T, bmi[0], wmo.T, bmo[0], wf1.T, bf1[0], wf2.T,
        bf2[0], lns[:, 0], lnb[:, 0])))


TCFG = T.LSEENDConfig(in_size=8, n_units=D, n_heads=H, enc_n_layers=1, dec_n_layers=1,
                      dec_dim_feedforward=F, chunk_size=L, conv_kernel_size=4, conv_delay=2,
                      max_nspks=C)


@pytest.fixture(scope="module")
def case():
    """One fusion layer's weights as a JAX pytree (made by the port's
    initializer and `ls_params_to_jax`, which test_weights_map_to_the_jax_layout
    holds to the JAX layout) and as the kernel's FusionWeights."""
    model = T.init_ls_eend(TCFG, torch.Generator().manual_seed(0), device="cpu")
    lp = jax.tree.map(jnp.asarray, CV.ls_params_to_jax(model)[0]["dec"]["layers"][0])
    # larger q/k weights: the row sums and carried scales leave their clamp at 1
    for name in ("q_proj", "k_proj"):
        lp["time_ret"][name]["kernel"] = lp["time_ret"][name]["kernel"] * 6
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, C, T0, D)).astype(np.float32)
    dy = rng.standard_normal((B, C, T0, D)).astype(np.float32)
    return lp, _weights(lp), x, dy


@pytest.fixture(scope="module")
def jax_forward(case):
    """The JAX kernel in interpret mode, once per rate."""
    lp, _, x, _ = case
    return {r: np.asarray(JDT.fused_fusion_layer(lp, jnp.asarray(x), jnp.array([[SEED]], jnp.int32),
                                                 H, L, r, True)) for r in RATES}


@pytest.fixture(scope="module")
def jax_grads(case):
    """jax.vjp of the chunk loop over `_chunk_fwd` at each rate ->
    (dx, the weight gradients in the port's layout).  The batch rows are
    mapped (`jax.vmap`, b traced) rather than looped, which halves the ops
    dispatched; a jitted form costs more here than it saves."""
    lp, _, x, dy = case
    out = {}
    for rate in RATES:
        def loop(lp_, x_):
            ops = JDT._pack(lp_, x_.dtype)

            def row(xb, b):
                kv = jnp.zeros((H, C, D // H, D // H))
                s = jnp.ones((H, C, 1, 1))
                ys = []
                for n in range(T0 // L):
                    y, kv, s, _ = JDT._chunk_fwd(
                        xb[:, n * L:(n + 1) * L], kv, s, ops, jnp.int32(SEED), b, jnp.int32(n),
                        C=C, L=L, D=D, H=H, F=F, rate=rate, collect=False)
                    ys.append(y)
                return jnp.concatenate(ys, axis=1)

            return jax.vmap(row)(x_, jnp.arange(B, dtype=jnp.int32))

        _, vjp = jax.vjp(loop, lp, jnp.asarray(x))
        glp, gx = vjp(jnp.asarray(dy))
        out[rate] = (np.asarray(gx), _weights(glp))
    return out


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("seed,b,n,site,shape,rate", [
    (0, 0, 0, 0, (3, 8, 16), 0.1), (1234, 1, 3, 3, (3, 8, 24), 0.5),
    (-5, 7, 2, 1 + 16, (3, 8, 3), 0.9), (2 ** 31 - 1, 2, 1, 4, (2, 5, 7), 0.1),
    (99, 3, 5, 1 + 32, (3, 8, 3), 0.999)])
def test_hash_keep_is_bit_identical_to_jax(seed, b, n, site, shape, rate):
    want = np.asarray(JDT._hash_keep(jnp.int32(seed), jnp.int32(b), jnp.int32(n), site, shape,
                                     rate, jnp.float32))
    got = DT.hash_keep(seed, b, n, site, shape, rate).numpy()
    np.testing.assert_array_equal(got, want)
    # a tensor of batch rows gives each row's masks
    rows = DT.hash_keep(seed, torch.arange(b + 1), n, site, shape, rate)
    np.testing.assert_array_equal(rows[b].numpy(), want)


@pytest.mark.parametrize("rate", RATES)
def test_plain_forward_matches_jax_kernel(case, jax_forward, rate):
    _, w, x, _ = case
    y, kvs, ss = DT.fusion_layer_fwd(_t(x), w, SEED, H, L, rate)
    np.testing.assert_allclose(y.numpy(), jax_forward[rate], atol=2e-5)
    assert kvs.shape == (B, T0 // L, H, C, D // H, D // H) and ss.shape == (B, T0 // L, H, C, 1, 1)
    assert float(ss[:, 1:].max()) > 1.0                  # the carried scale is live
    assert torch.equal(kvs[:, 0], torch.zeros_like(kvs[:, 0]))


@pytest.mark.parametrize("rate", RATES)
def test_plain_backward_matches_jax_vjp(case, jax_grads, rate):
    _, w, x, dy = case
    _, kvs, ss = DT.fusion_layer_fwd_plain(_t(x), w, SEED, H, L, rate)
    dx, dw = DT.fusion_layer_bwd(_t(x), _t(dy), kvs, ss, w, SEED, H, L, rate)
    gx, gw = jax_grads[rate]
    np.testing.assert_allclose(dx.numpy(), gx, atol=2e-4)
    for name, got, want in zip(DT.FusionWeights._fields, dw, gw):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("rate", RATES)
def test_plain_backward_matches_torch_autograd(case, rate):
    _, w, x, dy = case
    xt = _t(x).requires_grad_(True)
    wt = DT.FusionWeights(*(t.clone().requires_grad_(True) for t in w))
    y, kvs, ss = DT.fusion_layer_fwd_plain(xt, wt, SEED, H, L, rate)
    (y * _t(dy)).sum().backward()
    dx, dw = DT.fusion_layer_bwd_plain(_t(x), _t(dy), kvs.detach(), ss.detach(), w, SEED, H, L,
                                       rate)
    torch.testing.assert_close(dx, xt.grad, atol=2e-5, rtol=0)
    for name, got, want in zip(DT.FusionWeights._fields, dw, wt):
        torch.testing.assert_close(got, want.grad, atol=2e-5, rtol=1e-5, msg=name)


def test_autograd_function_takes_the_hand_written_backward(case):
    _, w, x, dy = case
    wt = DT.FusionWeights(*(t.clone().requires_grad_(True) for t in w))
    xt = _t(x).requires_grad_(True)
    y = DT.fused_fusion_layer(xt, wt, SEED, H, L, 0.1)
    assert y.grad_fn is not None and "FusedFusionLayer" in type(y.grad_fn).__name__
    (y * _t(dy)).sum().backward()
    _, kvs, ss = DT.fusion_layer_fwd_plain(_t(x), w, SEED, H, L, 0.1)
    dx, dw = DT.fusion_layer_bwd_plain(_t(x), _t(dy), kvs, ss, w, SEED, H, L, 0.1)
    torch.testing.assert_close(xt.grad, dx, atol=0, rtol=0)
    torch.testing.assert_close(wt.wf1.grad, dw.wf1, atol=0, rtol=0)
    with torch.no_grad():                                # eval: no checkpoints, same y
        torch.testing.assert_close(DT.fused_fusion_layer(xt, wt, SEED, H, L, 0.1), y.detach(),
                                   atol=0, rtol=0)


def test_wrappers_check_their_inputs(case):
    _, w, x, _ = case
    with pytest.raises(ValueError, match="multiple of chunk"):
        DT.fusion_layer_fwd(_t(x), w, SEED, H, 5, 0.0)
    with pytest.raises(ValueError, match="float32"):
        DT.fusion_layer_fwd(_t(x).double(), w, SEED, H, L, 0.0)
    with pytest.raises(ValueError, match="wf1"):
        DT.fusion_layer_fwd(_t(x), w._replace(wf1=w.wf1[:, :-1]), SEED, H, L, 0.0)


def test_fused_decoder_end_pads_exactly():
    """An internal chunk that does not divide T end-pads the slot grid;
    causality makes the first T frames exact: they equal the same chunk's
    run on a longer sequence that shares them, with dropout on."""
    cfg = T.LSEENDConfig(in_size=8, n_units=D, n_heads=H, enc_n_layers=1, dec_n_layers=2,
                         dec_dim_feedforward=F, chunk_size=6, conv_kernel_size=4,
                         conv_delay=2, max_nspks=C, use_fused_dec=True, fused_dec_chunk=4,
                         dropout=0.1)
    model = T.init_ls_eend(cfg, torch.Generator().manual_seed(1), device="cpu")
    emb = torch.as_tensor(np.random.default_rng(2).standard_normal((B, 20, D)),
                          dtype=torch.float32)
    with torch.no_grad():
        long = T.decode(model, emb, C, train=True, gen=torch.Generator().manual_seed(9))
        short = T.decode(model, emb[:, :18], C, train=True, gen=torch.Generator().manual_seed(9))
        plain = T.decode(T.with_cfg(model, dataclasses.replace(cfg, use_fused_dec=False,
                                                               chunk_size=4)), emb, C)
        fused = T.decode(T.with_cfg(model, dataclasses.replace(cfg, chunk_size=4)), emb, C)
    assert short.shape == (B, 18, C, D)
    torch.testing.assert_close(short, long[:, :18], atol=1e-6, rtol=0)
    # in eval, at equal chunk, the fused decoder is the plain chunkwise one
    torch.testing.assert_close(fused, plain, atol=2e-5, rtol=0)


def test_weights_map_to_the_jax_layout(case):
    """The layer's JAX pytree has the JAX package's own structure (that of
    `init_fusion_layer`), and pack_fusion of a port FusionLayer holding it
    equals the JAX kernel's own packing."""
    lp, w, _, _ = case
    cfg = J.LSEENDConfig(in_size=8, n_units=D, n_heads=H, enc_n_layers=1, dec_n_layers=1,
                         dec_dim_feedforward=F, chunk_size=L)
    shapes = jax.eval_shape(lambda k: J.init_fusion_layer(k, cfg), jax.random.PRNGKey(0))
    def leaves(tree):               # (path, shape) of every array leaf
        return [(jax.tree_util.keystr(p), a.shape)
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]

    assert leaves(shapes) == leaves(lp)
    model = T.init_ls_eend(TCFG, torch.Generator().manual_seed(0), device="cpu")
    params, mstate = CV.ls_params_to_jax(model)
    params["dec"]["layers"][0] = jax.tree.map(np.asarray, lp)
    model = CV.ls_params_from_jax(params, mstate, TCFG, "cpu")
    for name, got, want in zip(DT.FusionWeights._fields, DT.pack_fusion(model.dec.layers[0]), w):
        torch.testing.assert_close(got.detach(), want, atol=0, rtol=0, msg=name)
