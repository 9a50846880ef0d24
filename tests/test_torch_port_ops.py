"""PyTorch port, building blocks: `fseend_tpu_torch.ops` against the JAX
package's `ops.nn` / `ops.retention` on the same numpy inputs and weights,
and the port's import hygiene (no JAX, nothing of `fseend_tpu`).

Tolerance: float32 on both sides, another summation order (atol 2e-4 where
state is carried over steps, 1e-5 for single ops)."""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.ops import nn as jnn
from fseend_tpu.ops import retention as JR
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.ops import retention as TR

torch.set_num_threads(1)
ATOL_OP = 1e-5
ATOL_STATE = 2e-4


def _np(x):
    return np.array(x, dtype=np.float32)


def _lin_from(p):
    """Port nn.Linear from a JAX {"kernel" (in, out), "bias"} leaf."""
    kin, kout = np.asarray(p["kernel"]).shape
    lin = torch.nn.Linear(kin, kout)
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(_np(p["kernel"]).T))
        lin.bias.copy_(torch.as_tensor(_np(p["bias"])))
    return lin


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_linear_and_layer_norm(rng):
    p = jnn.torch_linear_init(jax.random.PRNGKey(0), 24, 40)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    lin = _lin_from(p)
    with jax.default_matmul_precision("highest"):
        want = jnn.linear(p, jnp.asarray(x))
    got = tnn.linear(torch.as_tensor(x), lin.weight, lin.bias)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=ATOL_OP)

    scale = rng.uniform(0.5, 1.5, 40).astype(np.float32)
    bias = rng.normal(size=40).astype(np.float32)
    y = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3 + 1
    want = jnn.layer_norm({"scale": scale, "bias": bias}, jnp.asarray(y))
    got = tnn.layer_norm(torch.as_tensor(y), torch.as_tensor(scale), torch.as_tensor(bias))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_OP)
    np.testing.assert_allclose(tnn.layer_norm(torch.as_tensor(y), eps=1e-6).numpy(),
                               _np(jnn.layer_norm(None, jnp.asarray(y), eps=1e-6)),
                               atol=ATOL_OP)


def test_l2_normalize_has_no_eps(rng):
    x = rng.standard_normal((4, 7)).astype(np.float32)
    np.testing.assert_allclose(tnn.l2_normalize(torch.as_tensor(x)).numpy(),
                               _np(jnn.l2_normalize(jnp.asarray(x))), atol=ATOL_OP)
    z = tnn.l2_normalize(torch.zeros(1, 3))
    assert torch.isnan(z).all()        # 0 / 0, like the reference's torch.norm division


def test_batch_norm_eval(rng):
    D = 16
    p = {"scale": rng.uniform(0.5, 1.5, D).astype(np.float32),
         "bias": rng.normal(size=D).astype(np.float32)}
    st = {"mean": rng.normal(size=D).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, D).astype(np.float32)}
    x = rng.standard_normal((3, 6, D)).astype(np.float32)
    want, _ = jnn.batch_norm(p, st, jnp.asarray(x), train=False)
    bn = torch.nn.BatchNorm1d(D).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(p["scale"]))
        bn.bias.copy_(torch.as_tensor(p["bias"]))
        bn.running_mean.copy_(torch.as_tensor(st["mean"]))
        bn.running_var.copy_(torch.as_tensor(st["var"]))
        got = tnn.batch_norm(torch.as_tensor(x), bn)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_OP)


def test_mha_and_ff_block(rng):
    D, H = 32, 4
    p = jnn.mha_init(jax.random.PRNGKey(1), D, H)
    p["in_proj"]["bias"] = jnp.asarray(rng.normal(size=3 * D) * 0.1, jnp.float32)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    m = tnn.MultiheadAttention(D, H)
    with torch.no_grad():
        m.in_proj.weight.copy_(torch.as_tensor(_np(p["in_proj"]["kernel"]).T))
        m.in_proj.bias.copy_(torch.as_tensor(_np(p["in_proj"]["bias"])))
        m.out_proj.weight.copy_(torch.as_tensor(_np(p["out_proj"]["kernel"]).T))
        m.out_proj.bias.copy_(torch.as_tensor(_np(p["out_proj"]["bias"])))
        xt = torch.as_tensor(x)
        got = tnn.mha(m, xt, xt, xt)
    with jax.default_matmul_precision("highest"):
        want = jnn.mha(p, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_OP)

    fp = {"linear1": jnn.torch_linear_init(jax.random.PRNGKey(2), D, 48),
          "linear2": jnn.torch_linear_init(jax.random.PRNGKey(3), 48, D)}
    with jax.default_matmul_precision("highest"):
        want = jnn.ff_block(fp, jnp.asarray(x))
    with torch.no_grad():
        got = tnn.ff_block(torch.as_tensor(x), _lin_from(fp["linear1"]),
                           _lin_from(fp["linear2"]))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_OP)


@pytest.mark.parametrize("delay", [0, 2])
def test_conv1d_valid_and_lookahead(rng, delay):
    Cin, Cout, k = 12, 10, 2 * delay + 1 if delay else 4
    p = jnn.conv1d_init(jax.random.PRNGKey(4), Cin, Cout, k)
    x = rng.standard_normal((2, 9, Cin)).astype(np.float32)
    w = torch.as_tensor(_np(p["kernel"]).transpose(2, 1, 0).copy())
    b = torch.as_tensor(_np(p["bias"]))
    with jax.default_matmul_precision("highest"):
        if delay:
            want = jnn.lookahead_conv(p, jnp.asarray(x), delay)
        else:
            want = jnn.conv1d(p, jnp.asarray(x), padding=[(0, 0)])
    got = (tnn.lookahead_conv(torch.as_tensor(x), w, b, delay) if delay
           else tnn.conv1d(torch.as_tensor(x), w, b))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_OP)


def test_sinusoidal_table():
    np.testing.assert_allclose(tnn.sinusoidal_table(50, 64).numpy(),
                               _np(jnn.sinusoidal_table(50, 64)), atol=1e-5)


def _retention_pair(D=32, H=4):
    cfg = JR.RetentionConfig(D, H)
    p = JR.init_retention(jax.random.PRNGKey(5), cfg)
    m = TR.Retention(TR.RetentionConfig(D, H))
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj"):
            lin = getattr(m, name)
            lin.weight.copy_(torch.as_tensor(_np(p[name]["kernel"]).T))
            lin.bias.copy_(torch.as_tensor(
                np.random.default_rng(6).normal(size=lin.bias.shape[0]).astype(np.float32) * 0.1))
            p[name]["bias"] = jnp.asarray(lin.bias.numpy())
    return cfg, p, TR.RetentionConfig(D, H), m


def test_retention_recurrent_step_carries_state(rng):
    """Five steps with the state carried across calls, from a non-zero
    incoming state: output and both state leaves after every step."""
    jcfg, p, tcfg, m = _retention_pair()
    B = 3
    kv0 = rng.standard_normal((B, 4, 8, 8)).astype(np.float32) * 0.3
    sc0 = np.full((B, 4), 4.0, np.float32)
    jst = {"kv": jnp.asarray(kv0), "scale": jnp.asarray(sc0)}
    tst = {"kv": torch.as_tensor(kv0), "scale": torch.as_tensor(sc0)}
    for _ in range(5):
        x = rng.standard_normal((B, 32)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            jy, jst = JR.retention_recurrent_step(p, jnp.asarray(x), jst, jcfg)
        with torch.no_grad():
            ty, tst = TR.retention_recurrent_step(m, torch.as_tensor(x), tst, tcfg)
        np.testing.assert_allclose(ty.numpy(), _np(jy), atol=ATOL_STATE)
        np.testing.assert_allclose(tst["kv"].numpy(), _np(jst["kv"]), atol=ATOL_STATE)
        np.testing.assert_allclose(tst["scale"].numpy(), _np(jst["scale"]), atol=0)


def test_retention_recurrent_sequence_and_decay(rng):
    jcfg, p, tcfg, m = _retention_pair()
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = JR.retention_recurrent(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = TR.retention_recurrent(m, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_STATE)
    dcfg = TR.RetentionConfig(32, 4, use_decay=True)
    np.testing.assert_allclose(
        TR.decay_gammas(dcfg).numpy(),
        _np(JR.decay_gammas(JR.RetentionConfig(32, 4, use_decay=True))), atol=0)
    assert (TR.decay_gammas(tcfg) == 1).all()


def test_port_imports_without_jax():
    """Every module of fseend_tpu_torch imports with JAX unimportable, and
    none of them loads a module of the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import fseend_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(fseend_tpu_torch.__path__,
                                                       "fseend_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = [m for m in sys.modules if m in ("fseend_tpu", "cli")
               or m.startswith(("fseend_tpu.", "cli."))]
        assert not bad, bad
        for n in ("serving.runtime", "kernels.chunk_retention", "kernels.retention_layer",
                  "kernels._dtype", "kernels.dec_frame_scan", "kernels.enc_frame_scan",
                  "kernels.dec_train_fusion", "kernels.cached_attention", "utils.checkpoint",
                  "utils.torch_convert", "ops.retention", "models.ls_eend", "models.fs_eend",
                  "train.labels", "train.losses", "train.optim", "train.trainer",
                  "train.loop", "data.loader", "data.sampler", "data.kaldi", "data.dataset",
                  "data.flac", "data._native", "ops.features", "ops.features_tpu",
                  "ops.enhancement", "serving.raw_audio", "models.eend_eda",
                  "serving.flex_stb", "utils.rttm", "utils.metrics", "utils.postprocess",
                  "utils.config", "train.aux_utils", "utils.profiling", "serving.aot",
                  "cli", "cli.common", "cli.train", "cli.infer", "cli.streaming_infer",
                  "cli.serve", "cli.score", "cli.sad_postprocess", "cli.stb_eval",
                  "cli.convert", "cli.export", "parallel", "parallel.collectives",
                  "parallel.mesh", "parallel.sp"):
            assert "fseend_tpu_torch." + n in names, (n, names)
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 62
