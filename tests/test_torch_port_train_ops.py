"""PyTorch port, the building blocks of training: dropout, train-mode
BatchNorm against the JAX package's `batch_norm(train=True)`, attention
with dropout on its weights, the retention modes' gradients against
`jax.grad` (the renormalizers detached where JAX stops their gradient), and
the recompute backward of the two chunkwise kernels (`kernels/
chunk_retention.py`, `kernels/retention_layer.py`) against autograd through
their plain versions.

Same numpy inputs and weights on both sides, float32.  Tolerance 1e-5 for
single ops, 2e-4 for gradients through a retention layer (as the port's
forward tests)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.ops import nn as jnn
from fseend_tpu.ops import retention as JR
from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.ops import retention as TR

torch.set_num_threads(1)
D, H, L = 32, 4, 8


def _np(x):
    return np.array(x, dtype=np.float32)


def test_dropout_keep_rate_and_determinism():
    x = torch.ones(200, 500)
    a = tnn.dropout(x, 0.1, torch.Generator().manual_seed(3))
    b = tnn.dropout(x, 0.1, torch.Generator().manual_seed(3))
    c = tnn.dropout(x, 0.1, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a > 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.9), atol=0, rtol=0)
    assert tnn.dropout(x, 0.1, None) is x and tnn.dropout(x, 0.0, torch.Generator()) is x


def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(0)
    Dn = 12
    x = (rng.standard_normal((3, 7, Dn)) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, Dn).astype(np.float32),
         "bias": rng.normal(size=Dn).astype(np.float32)}
    st = {"mean": rng.normal(size=Dn).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, Dn).astype(np.float32)}
    want, want_st = jnn.batch_norm(p, st, jnp.asarray(x), train=True)
    bn = torch.nn.BatchNorm1d(Dn)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(p["scale"]))
        bn.bias.copy_(torch.as_tensor(p["bias"]))
        bn.running_mean.copy_(torch.as_tensor(st["mean"]))
        bn.running_var.copy_(torch.as_tensor(st["var"]))
    y, new = tnn.batch_norm_train(torch.as_tensor(x), bn)
    np.testing.assert_allclose(y.detach().numpy(), _np(want), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), _np(want_st[k]), atol=1e-6)
    torch.testing.assert_close(bn.running_mean, torch.as_tensor(st["mean"]))  # buffers untouched


def test_mha_dropout_is_on_the_softmax_weights():
    """With a generator the weights are dropped as tnn.dropout drops them:
    the same generator state gives attention with those weights."""
    rng = np.random.default_rng(1)
    m = tnn.MultiheadAttention(16, 2)
    x = torch.as_tensor(rng.standard_normal((3, 5, 16)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    got = tnn.mha(m, x, x, x, 0.3, gen)
    q, k, v = (tnn.linear(x, m.in_proj.weight[i * 16:(i + 1) * 16],
                          m.in_proj.bias[i * 16:(i + 1) * 16]).reshape(3, 5, 2, 8).transpose(1, 2)
               for i in range(3))
    w = torch.softmax(q @ k.transpose(-1, -2) / 8 ** 0.5, dim=-1)
    w = tnn.dropout(w, 0.3, torch.Generator().manual_seed(7))
    want = tnn.linear((w @ v).transpose(1, 2).reshape(3, 5, 16), m.out_proj.weight,
                      m.out_proj.bias)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(tnn.mha(m, x, x, x), tnn.mha(m, x, x, x, 0.3, None))


def _pair(seed=5):
    jcfg = JR.RetentionConfig(D, H, 1, L)
    p = JR.init_retention(jax.random.PRNGKey(seed), jcfg)
    m = TR.Retention(TR.RetentionConfig(D, H, 1, L))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj"):
            lin = getattr(m, name)
            scale = 3.0 if name in ("q_proj", "k_proj") else 1.0   # renormalizers above 1
            lin.weight.copy_(torch.as_tensor(_np(p[name]["kernel"]).T * scale))
            lin.bias.copy_(torch.as_tensor(rng.normal(size=lin.bias.shape[0]) * 0.1,
                                           dtype=torch.float32))
            p[name] = {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
                       "bias": jnp.asarray(lin.bias.detach().numpy())}
    return jcfg, p, m


@pytest.mark.parametrize("mode", ["parallel", "chunkwise"])
def test_retention_gradients_match_jax(mode):
    """jax.grad through the stop-gradient renormalizers == torch autograd
    through the detached ones, for every weight and the input; chunkwise
    over three chunks, so the carried state's gradient is in it."""
    jcfg, p, m = _pair()
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 3 * L, D)) * 2).astype(np.float32)
    tgt = rng.standard_normal((2, 3 * L, D)).astype(np.float32)
    jfn = JR.retention_parallel if mode == "parallel" else JR.retention_chunkwise
    tfn = TR.retention_parallel if mode == "parallel" else TR.retention_chunkwise
    gp, gx = jax.grad(lambda p_, x_: jnp.sum(jfn(p_, x_, jcfg) * tgt), argnums=(0, 1))(
        p, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (tfn(m, xt, TR.RetentionConfig(D, H, 1, L, kernel="plain")) * torch.as_tensor(tgt)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(gx), atol=2e-4)
    for name in ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj"):
        lin = getattr(m, name)
        np.testing.assert_allclose(lin.weight.grad.numpy().T, _np(gp[name]["kernel"]), atol=2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(lin.bias.grad.numpy(), _np(gp[name]["bias"]), atol=2e-4,
                                   err_msg=name)


def _grads(fn, inputs):
    """Gradients of sum(out * w) for every output of fn(*inputs) with
    fixed weights w, w.r.t. every input."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    gen = torch.Generator().manual_seed(0)
    loss = sum((o * torch.randn(o.shape, generator=gen)).sum() for o in outs if o.requires_grad)
    loss.backward()
    return [t.grad for t in ins]


@pytest.mark.parametrize("carried", [False, True])
def test_chunk_retention_function_matches_plain_autograd(carried):
    rng = np.random.default_rng(12)
    BH, T0, dk = 6, 3 * L, 8

    def r(*s, sc=1.0):
        return torch.as_tensor(rng.standard_normal(s) * sc, dtype=torch.float32)

    kv0 = r(BH, dk, dk) if carried else torch.zeros(BH, dk, dk)
    s0 = torch.as_tensor(rng.uniform(1, 4, (BH, 1, 1)), dtype=torch.float32) if carried \
        else torch.ones(BH, 1, 1)
    gam = torch.ones(BH)
    inputs = [r(BH, T0, dk, sc=2), r(BH, T0, dk, sc=2), r(BH, T0, dk), kv0, s0]
    got = _grads(lambda *a: CR.chunk_retention(gam, *a, L), inputs)
    want = _grads(lambda *a: CR.chunk_retention_plain(gam, *a, L), inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    assert got[0].abs().max() > 0 and got[3].abs().max() > 0


def test_retention_layer_function_matches_plain_autograd():
    _, _, m = _pair()
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.standard_normal((2, 2 * L, D)), dtype=torch.float32)
    st = TR.chunk_state_init(TR.RetentionConfig(D, H, 1, L), 2)
    gam = torch.ones(H)
    inputs = [x, *RL.pack_retention(m), st["kv"], st["scale"]]

    def run(fn):
        return lambda x_, a, b, c, d, kv, s: fn(gam, x_, RL.RetLayerWeights(a, b, c, d), kv, s, L)

    got = _grads(run(RL.retention_layer), inputs)
    want = _grads(run(RL.retention_layer_plain), inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    # the kernel routes of the chunkwise mode train: the same gradients as
    # "plain", for the input and for the module's own weights
    grads = {}
    for kernel in ("plain", "core", "fused"):
        xt = x.clone().requires_grad_(True)
        m.zero_grad()
        cfg = dataclasses.replace(TR.RetentionConfig(D, H, 1, L), kernel=kernel)
        TR.retention_chunkwise(m, xt, cfg).square().sum().backward()
        grads[kernel] = [xt.grad] + [p.grad.clone() for p in m.parameters()]
    for kernel in ("core", "fused"):
        for g, want in zip(grads[kernel], grads["plain"]):
            torch.testing.assert_close(g, want, atol=2e-5, rtol=1e-5)
