"""PyTorch port, FS-EEND building blocks: the masked attention ops and the
post-norm transformer layer of `fseend_tpu_torch.ops.nn` against the JAX
package's `ops.nn`, and the plain versions of the two cached-attention
kernels (`fseend_tpu_torch.kernels.cached_attention`) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance: 1e-5 for single ops (float32 on both sides, another summation
order); 3e-5 for the plain kernels against the online-softmax Pallas
kernels, the JAX package's own bound for its flash route
(tests/test_fs_eend.py:233-236)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import cached_attention_pallas as JCA
from fseend_tpu.ops import nn as jnn
from fseend_tpu_torch.kernels import cached_attention as CA
from fseend_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)
ATOL_OP = 1e-5
ATOL_FLASH = 3e-5


def _np(x):
    return np.array(x, dtype=np.float32)


def _mha_pair(rng, D=32, H=4):
    """A JAX mha pytree with non-zero in-projection biases and the port's
    MultiheadAttention holding the same weights."""
    p = jnn.mha_init(jax.random.PRNGKey(1), D, H)
    p["in_proj"]["bias"] = jnp.asarray(rng.normal(size=3 * D) * 0.1, jnp.float32)
    m = tnn.MultiheadAttention(D, H)
    with torch.no_grad():
        m.in_proj.weight.copy_(torch.as_tensor(_np(p["in_proj"]["kernel"]).T))
        m.in_proj.bias.copy_(torch.as_tensor(_np(p["in_proj"]["bias"])))
        m.out_proj.weight.copy_(torch.as_tensor(_np(p["out_proj"]["kernel"]).T))
        m.out_proj.bias.copy_(torch.as_tensor(_np(p["out_proj"]["bias"])))
    return p, m


@pytest.fixture
def rng():
    return np.random.default_rng(4321)


@pytest.mark.parametrize("delay", [0, 2])
def test_causal_mask(delay):
    np.testing.assert_array_equal(tnn.causal_mask(7, delay).numpy(),
                                  _np(jnn.causal_mask(7, delay)))


def test_mha_core_and_mha_with_masks(rng):
    p, m = _mha_pair(rng)
    x = rng.standard_normal((2, 3, 6, 32)).astype(np.float32)
    q, k, v = (rng.standard_normal((2, 4, 6, 8)).astype(np.float32) for _ in range(3))
    # causal, causal with a look-ahead, and a random mask with the diagonal kept
    rand = np.where((rng.uniform(size=(6, 6)) < 0.5) & ~np.eye(6, dtype=bool),
                    -np.inf, 0.0).astype(np.float32)
    for mask in (_np(jnn.causal_mask(6)), _np(jnn.causal_mask(6, 2)), rand, None):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.as_tensor(mask)
        with jax.default_matmul_precision("highest"):
            want_core = jnn.mha_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
            want = jnn.mha(p, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), jm)
        got_core = tnn.mha_core(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), tm)
        with torch.no_grad():
            xt = torch.as_tensor(x)
            got = tnn.mha(m, xt, xt, xt, mask=tm)
        np.testing.assert_allclose(got_core.numpy(), _np(want_core), atol=ATOL_OP)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_OP)
    # the split/merge pair of the JAX package
    y = torch.as_tensor(x)
    np.testing.assert_array_equal(tnn.split_heads(y, 4).numpy(),
                                  _np(jnn._split_heads(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tnn.merge_heads(tnn.split_heads(y, 4)).numpy(), x)


def test_transformer_layer(rng):
    D, H, F = 32, 4, 48
    p = jnn.transformer_layer_init(jax.random.PRNGKey(2), D, H, F)
    for name in ("norm1", "norm2"):
        p[name] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, D), jnp.float32),
                   "bias": jnp.asarray(rng.normal(size=D) * 0.1, jnp.float32)}
    layer = tnn.TransformerLayer(D, H, F)
    with torch.no_grad():
        for name in ("linear1", "linear2"):
            lin = getattr(layer, name)
            lin.weight.copy_(torch.as_tensor(_np(p[name]["kernel"]).T))
            lin.bias.copy_(torch.as_tensor(_np(p[name]["bias"])))
        for name in ("norm1", "norm2"):
            getattr(layer, name).weight.copy_(torch.as_tensor(_np(p[name]["scale"])))
            getattr(layer, name).bias.copy_(torch.as_tensor(_np(p[name]["bias"])))
        sa = layer.self_attn
        sa.in_proj.weight.copy_(torch.as_tensor(_np(p["self_attn"]["in_proj"]["kernel"]).T))
        sa.in_proj.bias.copy_(torch.as_tensor(_np(p["self_attn"]["in_proj"]["bias"])))
        sa.out_proj.weight.copy_(torch.as_tensor(_np(p["self_attn"]["out_proj"]["kernel"]).T))
        sa.out_proj.bias.copy_(torch.as_tensor(_np(p["self_attn"]["out_proj"]["bias"])))
        x = rng.standard_normal((2, 9, D)).astype(np.float32)
        got = tnn.transformer_layer(layer, torch.as_tensor(x), tnn.causal_mask(9))
    with jax.default_matmul_precision("highest"):
        want = jnn.transformer_layer(p, jnp.asarray(x), jnn.causal_mask(9))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_OP)


# ---------------------------------------------------------------------------
# the cached-attention kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

R, HD, CAP, BK = 8, 16, 64, 16


def _qkv(rng, K, R=R):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((R, K, HD), (R, CAP, HD), (R, CAP, HD)))


@pytest.mark.parametrize("K,start", [(8, 0), (8, 40), (1, 0), (1, 63)])
def test_shared_head_plain_matches_pallas(rng, K, start):
    """start 40: the kv blocks past position 47 are dead (skipped by the
    Pallas kernel, masked here); K = 1 is the one-frame step."""
    q, k, v = _qkv(rng, K)
    with jax.default_matmul_precision("highest"):
        want = JCA.flash_cached_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          start, interpret=True, block_kv=BK)
    got = CA.cached_attention_plain(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v), start)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_FLASH)
    # on a CPU tensor the wrapper is the plain version
    wrapped = CA.cached_attention(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), torch.tensor(start, dtype=torch.int32))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("K,starts,min_pos", [
    (8, [0, 1, 20, 50], 0),       # skewed lanes; lane 3's last blocks are dead
    (8, [0, 1, 20, 50], 3),       # lanes 0 and 1 start before warm-up
    (1, [0, 2, 3, 60], 3),        # one frame: pre-warm-up, edge and late lanes
])
def test_perlane_plain_matches_pallas(rng, K, starts, min_pos):
    """Rows lane-major, two per lane.  Every row is compared: a pre-warm-up
    query (qpos < min_pos) reads its own position only, in both."""
    q, k, v = _qkv(rng, K)
    st = np.array(starts, np.int32)
    with jax.default_matmul_precision("highest"):
        want = JCA.flash_cached_attention_perlane(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
            rows_per_lane=2, min_pos=min_pos, interpret=True, block_kv=BK)
    args = (torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(st))
    got = CA.cached_attention_perlane_plain(*args, 2, min_pos)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_FLASH)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(CA.cached_attention_perlane(*args, 2, min_pos).numpy(),
                                  got.numpy())
    if min_pos:
        # a pre-warm-up query returns the value at its own position
        qpos = st[0] + np.arange(K)
        pre = qpos < min_pos
        np.testing.assert_allclose(got.numpy()[0][pre], v[0][qpos[pre]], atol=1e-6)


def test_wrappers_check_their_arguments(rng):
    q, k, v = (torch.as_tensor(a) for a in _qkv(rng, 4))
    with pytest.raises(ValueError, match="float32"):
        CA.cached_attention(q.double(), k.double(), v.double(), 0)
    with pytest.raises(ValueError, match="does not fit"):
        CA.cached_attention(q[:, :, :8], k, v, 0)
    with pytest.raises(ValueError, match="rows_per_lane"):
        CA.cached_attention_perlane(q, k, v, torch.zeros(3, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="start"):
        CA.cached_attention_perlane(q, k, v, torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="start"):
        CA.cached_attention(q, k, v, torch.zeros(2, dtype=torch.int32))
