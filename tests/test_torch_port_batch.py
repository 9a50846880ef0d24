"""PyTorch port, the LS-EEND batch pass: `ls_forward` / `ls_test` of
`fseend_tpu_torch.models.ls_eend` against the JAX package's on the same
weights (JAX init -> `ls_params_from_jax`, non-trivial BatchNorm statistics)
and inputs, in all three time modes and through every chunkwise route; the
reference golden; the port's streaming against its own batch pass; and the
reader of the JAX package's npz checkpoints.

Tolerance: atol 2e-4 (float32, another summation order through 2 encoder and
2 decoder layers), as the JAX package's own golden test."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.models import ls_eend as J
from fseend_tpu.ops import nn as jnn
from fseend_tpu.utils import checkpoint as JCK
from fseend_tpu.utils import torch_convert as JTC
from fseend_tpu_torch.models import ls_eend as T
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.utils import checkpoint as CK
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.LSEENDConfig(
    in_size=20, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=2, chunk_size=8,
    conv_kernel_size=4, dec_dim_feedforward=48, conv_delay=2, max_nspks=3, dropout=0.0)
TCFG = T.LSEENDConfig(**{f.name: getattr(JCFG, f.name)
                         for f in dataclasses.fields(T.LSEENDConfig)
                         if hasattr(JCFG, f.name)})
B, T0, C = 2, 21, 3                     # 21 frames: not a multiple of the chunk
LENS = np.array([21, 13])
ATOL = 2e-4


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
    rng = np.random.default_rng(7)
    mstate = {"conv_bn": [{"mean": jnp.asarray(rng.normal(0, 0.2, 32), jnp.float32),
                           "var": jnp.asarray(rng.uniform(0.5, 2.0, 32), jnp.float32)}
                          for _ in range(2)]}
    model = CV.ls_params_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, mstate), TCFG, "cpu")
    xs = (rng.standard_normal((B, T0, JCFG.in_size)) * 2).astype(np.float32)
    return params, mstate, model, xs


def _with_route(model, kernel):
    return T.with_cfg(model, dataclasses.replace(model.cfg, kernel=kernel))


def test_causal_depthwise_conv_matches_jax():
    rng = np.random.default_rng(2)
    D, k = 12, 5
    p = jnn.conv1d_init(jax.random.PRNGKey(4), D, D, k, groups=D, bias=False)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    w = torch.as_tensor(np.array(p["kernel"]).transpose(2, 1, 0).copy())      # (D, 1, k)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jnn.causal_depthwise_conv(p, jnp.asarray(x), k))
    got = tnn.causal_depthwise_conv(torch.as_tensor(x), w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # block by block with the carried history equals the whole sequence
    first = tnn.causal_depthwise_conv(torch.as_tensor(x[:, :4]), w)
    second = tnn.causal_depthwise_conv(torch.as_tensor(x[:, 4:]), w,
                                       cache=torch.as_tensor(x[:, :4]))
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("time_mode", ["chunkwise", "recurrent", "parallel"])
def test_ls_forward_matches_jax(setup, time_mode):
    """lens shorter than T on one recording, T not a chunk multiple."""
    params, mstate, model, xs = setup
    with jax.default_matmul_precision("highest"):
        want = J.ls_forward(params, mstate, JCFG, jnp.asarray(xs), jnp.asarray(LENS), C,
                            time_mode=time_mode)
    got = T.ls_forward(model, torch.as_tensor(xs), torch.as_tensor(LENS), C,
                       time_mode=time_mode)
    assert got["logits"].shape == (B, T0, C) and got["attractors"].shape == (B, T0, C, 32)
    for key in ("logits", "emb", "attractors"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("kernel", ["plain", "core"])
def test_ls_test_routes_agree(setup, kernel):
    """Each chunkwise route gives the default ("fused") route's result, and
    JAX's; ls_test takes numpy input and the config's slot count."""
    params, mstate, model, xs = setup
    assert model.cfg.kernel == "fused"
    with jax.default_matmul_precision("highest"):
        want = J.ls_test(params, mstate, JCFG, jnp.asarray(xs), jnp.asarray(LENS))
    fused = T.ls_test(model, xs, LENS)
    other = T.ls_test(_with_route(model, kernel), xs, LENS)
    np.testing.assert_allclose(fused["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(other["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(other["emb"].numpy(), fused["emb"].numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="float32"):
        T.ls_test(model, xs.astype(np.float64), LENS)


def test_ls_reference_golden():
    """The reference model's stored output through the JAX package's
    converter and then the port's, the way tests/test_torch_convert.py reads
    the golden for JAX."""
    g = np.load(pathlib.Path(__file__).parent / "goldens" / "ls_model_ref.npz")
    sd = {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}
    jcfg = J.LSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2,
                          dec_n_layers=2, chunk_size=8, ff_expansion=2,
                          conv_kernel_size=5, dec_dim_feedforward=64, conv_delay=3,
                          max_nspks=4)
    tcfg = T.LSEENDConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(T.LSEENDConfig)
                             if hasattr(jcfg, f.name)})
    params, state = JTC.ls_from_state_dict(sd, jcfg)
    model = CV.ls_params_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, state), tcfg, "cpu")
    out = T.ls_test(model, g["x"], np.array([16, 16]), max_nspks=4)
    np.testing.assert_allclose(out["logits"].numpy(), g["logits"], atol=ATOL)
    np.testing.assert_allclose(out["emb"].numpy(), g["emb"], atol=ATOL)


def test_streaming_equals_recurrent_batch(setup):
    """The port's per-frame streaming against the port's own batch pass in
    recurrent time_mode, aligned and flushed as tests/test_ls_eend.py does
    it for JAX (atol 1e-4 there too)."""
    _, _, model, xs = setup
    x = torch.as_tensor(xs)
    batch = T.ls_forward(model, x, torch.full((B,), T0), C, time_mode="recurrent")
    state = T.ls_stream_init(TCFG, B, C, device="cpu")
    logits, emb = T.ls_stream_scan(model, state, x, C)
    np.testing.assert_allclose(emb.numpy(), batch["emb"].numpy(), atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), batch["logits"].numpy(), atol=1e-4)
    fused = T.ls_stream_scan_fused(model, T.ls_stream_init(TCFG, B, C, device="cpu"), x, C)
    np.testing.assert_allclose(fused.numpy(), batch["logits"].numpy(), atol=ATOL)


@pytest.mark.parametrize("with_state", [True, False])
def test_checkpoint_written_by_jax_loads_into_the_port(setup, tmp_path, with_state):
    """save_pytree from the JAX package, read by the port, same logits; a
    params-only file gets fresh BatchNorm statistics."""
    params, mstate, _, xs = setup
    tree = {"params": params}
    if with_state:
        tree["model_state"] = mstate
    else:
        mstate = {"conv_bn": [jnn.batch_norm_init(32)[1] for _ in range(2)]}
    path = tmp_path / "ckpt_epoch=1.npz"
    JCK.save_pytree(path, tree, extra={"epoch": 1})
    model = CK.load_ls_eend(path, TCFG, device="cpu")
    assert "__extra__/epoch" in CK.load_flat(path)
    assert CK.load_pytree(path, "opt_state") is None
    with jax.default_matmul_precision("highest"):
        want = J.ls_test(params, mstate, JCFG, jnp.asarray(xs), jnp.asarray(LENS))
    got = T.ls_test(model, xs, LENS)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    with pytest.raises(KeyError, match="params"):
        JCK.save_pytree(tmp_path / "empty.npz", {"other": {"a": np.zeros(1)}})
        CK.load_ls_eend(tmp_path / "empty.npz", TCFG, device="cpu")
