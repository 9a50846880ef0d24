"""PyTorch port, the last two leftovers of ported modules (ROADMAP A19): the
FLAC encoder (`fseend_tpu_torch/data/flac.py:write_flac`) and the xpos
rotation of retention (`ops/retention.py`, `use_xpos=True`), against the
JAX package's.

* `write_flac` writes the JAX encoder's bytes, 16- and 24-bit, mono and
  stereo, a length that is no multiple of the block size, silence (the
  CONSTANT subframe); both decoders read the file back to the same samples,
  within half a quantization step of the input;
* xpos: `retention_parallel` and `retention_chunkwise` on every route
  against JAX's at 1e-5 (the "fused" route runs the plain one, bit for
  bit, as JAX's fused layer skips itself), the LS batch pass
  (`ls_forward`, "plain" and "core") against JAX's at 1e-5, the fused
  decoder refusing xpos (its kernels have none, as JAX's), and the
  recurrent step applying none, as JAX's.

About 9 s of tests on one core, the JAX compiles most of it (CHANGES.md)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.data import flac as JFL
from fseend_tpu.models import ls_eend as JL
from fseend_tpu.ops import retention as JR
from fseend_tpu_torch.data import flac as TFL
from fseend_tpu_torch.models import ls_eend as TL
from fseend_tpu_torch.ops import retention as TR
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
ATOL = 1e-5
D, H, L, T = 32, 4, 8, 24
# XLA's older CPU fusion path compiles these programs in a fraction of the
# time (tests/test_torch_port_bf16_train.py)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}


def _jax(fn, *args):
    """fn(*args) as one JAX program, compiled with FAST, at full float32
    precision."""
    with jax.default_matmul_precision("highest"):
        return jax.tree.map(np.asarray, jax.jit(fn).lower(*args).compile(FAST)(*args))


@pytest.mark.parametrize("depth,channels,silent", [(16, 1, False), (16, 2, False),
                                                   (24, 1, False), (24, 2, False),
                                                   (16, 2, True)])
def test_write_flac_bytes_equal_jax_and_round_trip(tmp_path, depth, channels, silent):
    rng = np.random.default_rng(depth + channels)
    n = 2 * 1024 + 357                               # three frames, the last short
    t = np.arange(n) / 16000.0
    x = (0.4 * np.sin(2 * np.pi * 220.0 * t)[:, None] * np.arange(1, channels + 1)
         + 0.05 * rng.standard_normal((n, channels))).clip(-1.0, 0.99)
    x = np.zeros((n, channels)) if silent else x
    x = (x[:, 0] if channels == 1 else x).astype(np.float32)
    TFL.write_flac(tmp_path / "port.flac", x, 16000, depth=depth, block_size=1024)
    JFL.write_flac(tmp_path / "jax.flac", x, 16000, depth=depth, block_size=1024)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()
    got, sr = TFL.read_flac(tmp_path / "port.flac")
    want, jsr = JFL.read_flac(tmp_path / "port.flac")
    assert sr == jsr == 16000 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(got - x).max()) <= 0.5 / 2 ** (depth - 1) + 1e-9


def _pair(seed=5):
    """The same retention weights (non-zero biases) as a JAX pytree and a
    port module."""
    p = JR.init_retention(jax.random.PRNGKey(seed), JR.RetentionConfig(D, H, 1, L))
    m = TR.Retention(TR.RetentionConfig(D, H, 1, L))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj"):
            lin = getattr(m, name)
            lin.weight.copy_(torch.as_tensor(np.array(p[name]["kernel"]).T))
            lin.bias.copy_(torch.as_tensor(rng.normal(size=lin.bias.shape[0])
                                           .astype(np.float32) * 0.1))
            p[name]["bias"] = jnp.asarray(lin.bias.numpy())
    return p, m


def test_xpos_retention_matches_jax_on_every_route():
    p, m = _pair()
    x = np.random.default_rng(1).standard_normal((2, T, D)).astype(np.float32)
    jc = JR.RetentionConfig(D, H, 1, L, use_xpos=True)
    want_par, want_chunk, plain = _jax(lambda p, x: (
        JR.retention_parallel(p, x, jc), JR.retention_chunkwise(p, x, jc),
        JR.retention_parallel(p, x, dataclasses.replace(jc, use_xpos=False))), p, jnp.asarray(x))
    assert float(np.abs(want_par - plain).max()) > 0.05      # the rotation matters here
    outs = {}
    with torch.no_grad():
        for route in TR.ROUTES:
            tc = TR.RetentionConfig(D, H, 1, L, use_xpos=True, kernel=route)
            np.testing.assert_allclose(TR.retention_parallel(m, torch.as_tensor(x), tc),
                                       want_par, atol=ATOL, err_msg=route)
            outs[route] = TR.retention_chunkwise(m, torch.as_tensor(x), tc)
            np.testing.assert_allclose(outs[route], want_chunk, atol=ATOL, err_msg=route)
    assert torch.equal(outs["fused"], outs["plain"])


@dataclasses.dataclass(frozen=True)
class _JXposLS(JL.LSEENDConfig):
    """The JAX LS config with xpos on in every retention layer (its config
    has no field for it)."""

    @property
    def ret_cfg(self):
        return dataclasses.replace(super().ret_cfg, use_xpos=True)


def test_xpos_ls_forward_matches_jax_and_the_fused_decoder_refuses_it():
    jcfg = _JXposLS(in_size=23, n_units=D, n_heads=H, enc_n_layers=1, dec_n_layers=1,
                    chunk_size=L, ff_expansion=2, conv_kernel_size=5, dec_dim_feedforward=64,
                    conv_delay=3, max_nspks=4, dropout=0.0)
    params, mstate = JL.init_ls_eend(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 20, 23)).astype(np.float32)
    lens = np.array([20, 13], np.int32)
    want = _jax(lambda p, s, x, n: JL.ls_forward(p, s, jcfg, x, n, 4)["logits"], params,
                mstate, jnp.asarray(xs), jnp.asarray(lens))
    cfg = TL.LSEENDConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(TL.LSEENDConfig) if hasattr(jcfg, f.name)},
                          use_xpos=True, kernel="plain")
    model = CV.ls_params_from_jax(jax.tree.map(np.asarray, params), mstate, cfg, "cpu")
    for route in TR.ROUTES:
        got = TL.ls_forward(TL.with_cfg(model, dataclasses.replace(cfg, kernel=route)), xs, lens,
                            4)["logits"]
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=route)
    off = TL.ls_forward(TL.with_cfg(model, dataclasses.replace(cfg, use_xpos=False)), xs, lens,
                        4)["logits"]
    assert float(np.abs(off.numpy() - want).max()) > 1e-3
    with pytest.raises(ValueError, match="xpos"):
        TL.ls_forward(TL.with_cfg(model, dataclasses.replace(cfg, use_fused_dec=True)), xs, lens,
                      4)


def test_recurrent_step_applies_no_xpos_as_jax():
    p, m = _pair(seed=9)
    x = np.random.default_rng(2).standard_normal((3, 4, D)).astype(np.float32)
    jc = JR.RetentionConfig(D, H, 1, L, use_xpos=True)

    def scan(p, xs):
        return jax.lax.scan(lambda st, x_t: JR.retention_recurrent_step(p, x_t, st, jc)[::-1],
                            JR.retention_state_init(jc, 3), xs.swapaxes(0, 1))[1]

    jys = _jax(scan, p, jnp.asarray(x))
    ts = TR.retention_state_init(TR.RetentionConfig(D, H), 3)
    ts_off = dict(ts)
    for t, jy in enumerate(jys):
        with torch.no_grad():
            ty, ts = TR.retention_recurrent_step(m, torch.as_tensor(x[:, t]), ts,
                                                 TR.RetentionConfig(D, H, 1, L, use_xpos=True))
            ty_off, ts_off = TR.retention_recurrent_step(m, torch.as_tensor(x[:, t]), ts_off,
                                                         TR.RetentionConfig(D, H, 1, L))
        assert torch.equal(ty, ty_off)
        np.testing.assert_allclose(ty, jy, atol=ATOL)
