"""PyTorch port, the chunkwise retention core as the CUDA kernel computes it
(`fseend_tpu_torch/kernels/csrc/chunk_retention_tc.cuh`, shared by
`chunk_retention` and `retention_layer`): its plain mirror
`chunk_retention_passes` against `chunk_retention_plain` and against the JAX
package's Pallas kernel `retention_pallas._forward_stateful` in interpret
mode.

The mirror: each chunk zero-padded to whole 64-frame tiles; (a) each chunk's
summary U_m = K_m^T (V_m * last mask row) in 32-frame slices; (b) the state
before each chunk scanned from those summaries in chunk order, with its
scale formed after the scan; (c) the output per (chunk, 64-query tile) in
two sums added at the end, each from the cross read over one half of dk and
one 32-frame half of every k/v tile.

Cases: three chunks of 20 frames from a non-zero incoming state (gamma = 1
and a per-row gamma < 1), an odd chunk (75 = 64 + 11: a padded second tile),
one chunk of three tiles (no scan), and chunks of 8 frames (under a half
tile).

Tolerance: 1e-9 against the plain version, both in float64, so that the
comparison sees the algorithm (they differ by ~1e-15); 2e-5 against the
Pallas kernel in float32 (another summation order over 20-frame chunks and
one division by max(inner, c) where the TPU kernel multiplies by two
ratios)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import retention_pallas as JKP
from fseend_tpu_torch.kernels import chunk_retention as CR

torch.set_num_threads(1)
ATOL_PLAIN, ATOL_JAX = 1e-9, 2e-5

# (rows, chunk, chunks, dk, dv, gamma)
CASES = {
    "three chunks, gamma 1": (3, 20, 3, 16, 16, 1.0),
    "three chunks, gamma < 1": (3, 20, 3, 16, 16, 0.9),
    "odd chunk": (2, 75, 2, 16, 32, 0.97),
    "one chunk": (2, 130, 1, 16, 16, 1.0),
    "chunks of 8": (2, 8, 4, 16, 16, 0.95),
}


def _inputs(rng, BH, L, N, dk, dv, gamma, dtype):
    """Per-row gamma (every other row a little closer to 1 when < 1), q, k
    (scaled), v, and a non-zero incoming state with its scale."""
    T = L * N

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(dtype)

    gam = np.full((BH,), gamma, dtype)
    if gamma < 1:
        gam[::2] = gamma + 0.02
    kv0 = randn(BH, dk, dv, scale=2.0)
    s0 = np.abs(kv0).sum(1, keepdims=True).max(2, keepdims=True).clip(1, None)
    return gam, randn(BH, T, dk), randn(BH, T, dk, scale=dk ** -0.5), randn(BH, T, dv), kv0, s0


@pytest.mark.parametrize("case", list(CASES))
def test_passes_match_plain(case):
    BH, L, N, dk, dv, gamma = CASES[case]
    args = [torch.as_tensor(a) for a in _inputs(np.random.default_rng(len(case)), BH, L, N,
                                                 dk, dv, gamma, np.float64)]
    got = CR.chunk_retention_passes(*args, L)
    want = CR.chunk_retention_plain(*args, L)
    for name, g, w in zip(("out", "kv", "scale"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=ATOL_PLAIN, rtol=0, msg=name)
    assert float(want[2].max()) > 1.0           # the carried scale is in play


@pytest.fixture(scope="module")
def jax_cases():
    """The Pallas kernel in interpret mode, once per gamma, on the
    three-chunk shape in float32."""
    out = {}
    for case in ("three chunks, gamma 1", "three chunks, gamma < 1"):
        BH, L, N, dk, dv, gamma = CASES[case]
        ins = _inputs(np.random.default_rng(77), BH, L, N, dk, dv, gamma, np.float32)
        with jax.default_matmul_precision("highest"):
            want = JKP._forward_stateful(*(jnp.asarray(a) for a in ins), L, interpret=True)
        out[case] = ins, [np.asarray(w, np.float32) for w in want]
    return out


@pytest.mark.parametrize("case", ["three chunks, gamma 1", "three chunks, gamma < 1"])
def test_passes_match_pallas(jax_cases, case):
    ins, want = jax_cases[case]
    L = CASES[case][1]
    got = CR.chunk_retention_passes(*(torch.as_tensor(a) for a in ins), L)
    for name, g, w in zip(("out", "kv", "scale"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL_JAX, err_msg=name)
