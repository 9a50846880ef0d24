"""PyTorch port, FLEX-STB block streaming (`serving/flex_stb.py`): its
numpy helpers (the KL weights, the buffer update in its three forms, the
block split, the correlation permutation) equal to the JAX package's on
the same inputs and seed; `FlexSTB.run` against the JAX `FlexSTB.run` on
the same weights and features, with every buffer form; `eda_test`'s padded
scoring through `lens` equal to scoring the true length.

Tolerances: the helpers are copies, so exact; end to end 1e-5 on the
probabilities (float32 on both sides, another summation order; the JAX
scorer pads to buffer + block and masks the pad, the port scores the true
length).  The v1 / v2 buffers draw frames with `rng.choice(p=...)` from
the probabilities of both packages: a probability off by ~1e-7 could, in
principle, flip a draw, so the run is also held block by block."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fseend_tpu.models import eend_eda as J
from fseend_tpu.serving import flex_stb as JS
from fseend_tpu_torch.models import eend_eda as T
from fseend_tpu_torch.serving import flex_stb as TS
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.EDAConfig(in_size=24, n_units=32, n_heads=4, n_layers=2, dim_feedforward=64,
                   dropout=0.0)
TCFG = T.EDAConfig(**dataclasses.asdict(JCFG))
N_SPK, BUF, BLOCK, TT = 2, 30, 12, 60
WEIGHTS = ("fifo", "v1", "v2")


@pytest.fixture(scope="module")
def shared():
    params, _ = J.init_eend_eda(jax.random.PRNGKey(6), JCFG)
    model = CV.eda_params_from_jax(jax.tree.map(np.asarray, params), TCFG, "cpu")
    rng = np.random.default_rng(12)
    act = (rng.uniform(size=(TT, N_SPK)) > 0.5).astype(np.float32)
    feats = (act @ rng.standard_normal((N_SPK, JCFG.in_size))
             + 0.3 * rng.standard_normal((TT, JCFG.in_size))).astype(np.float32)
    return params, model, feats


@pytest.fixture(scope="module")
def jax_runs(shared):
    """The JAX FlexSTB's probabilities with each buffer form (three
    compiles of its padded scorer)."""
    params, _, feats = shared
    with jax.default_matmul_precision("highest"):
        return {w: JS.FlexSTB(params=params, cfg=JCFG, n_speakers=N_SPK, buf_size=BUF,
                              block_size=BLOCK, buffer_weights=w).run(feats)
                for w in WEIGHTS}


def _probs(rng, T, S):
    y = rng.uniform(size=(T, S)).astype(np.float32)
    y[rng.uniform(size=T) < 0.2] = 0.0                 # all-silent frames: the clamps
    y[:3, 0] = 0.999
    return y


def test_kl_weights_equal_jax():
    rng = np.random.default_rng(0)
    for S in (2, 4):
        y = _probs(rng, 50, S)
        np.testing.assert_array_equal(TS.kl_weights(y), JS.kl_weights(y))
        np.testing.assert_array_equal(TS.kl_weights_v2(y), JS.kl_weights_v2(y))


@pytest.mark.parametrize("weights", WEIGHTS)
def test_update_buffer_selects_the_same_frames_as_jax(weights):
    """From the same buffer, block and seed both packages keep the same
    frames, over several updates of one generator (a buffer that does not
    overflow yet is concatenated)."""
    rng = np.random.default_rng(1)
    t_rng, j_rng = np.random.default_rng(9), np.random.default_rng(9)
    xb, yb = np.zeros((0, 5), np.float32), np.zeros((0, 3), np.float32)
    jxb, jyb = xb, yb
    for i in range(5):
        x = rng.standard_normal((12, 5)).astype(np.float32)
        y = _probs(rng, 12, 3)
        xb, yb = TS.update_buffer(xb, x, yb, y, 30, t_rng, weights)
        jxb, jyb = JS.update_buffer(jxb, x, jyb, y, 30, j_rng, weights)
        np.testing.assert_array_equal(xb, jxb, err_msg=f"update {i}")
        np.testing.assert_array_equal(yb, jyb, err_msg=f"update {i}")
    assert len(xb) == 30


def test_split_correlation_and_permutation_equal_jax():
    rng = np.random.default_rng(2)
    labels = (rng.uniform(size=(47, 4)) > 0.6).astype(np.float32)
    labels[:20, 3] = 0
    preds = rng.uniform(size=(47, 4)).astype(np.float32)
    got, want = TS.split_results(labels, preds, 10), JS.split_results(labels, preds, 10)
    assert got[2] == want[2]
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)
    y = rng.uniform(size=(40, 3)).astype(np.float32)
    y_pred = y[:, [2, 0, 1]] + 0.01 * rng.standard_normal((40, 3)).astype(np.float32)
    assert TS.correlation(y[:, 0], y_pred[:, 1]) == JS.correlation(y[:, 0], y_pred[:, 1])
    perm = TS.find_best_perm(y, y_pred)
    np.testing.assert_array_equal(perm, JS.find_best_perm(y, y_pred))
    np.testing.assert_array_equal(perm, [1, 2, 0])


@pytest.mark.parametrize("weights", WEIGHTS)
def test_flex_stb_run_matches_jax(shared, jax_runs, weights):
    """FlexSTB.run over 60 frames in 12-frame blocks with a 30-frame
    buffer (three blocks overflow it): the port's probabilities within
    1e-5 of the JAX package's with each buffer form; the first block, which
    sees no buffer, the same for every form."""
    params, model, feats = shared
    stb = TS.FlexSTB(model, TCFG, N_SPK, buf_size=BUF, block_size=BLOCK, buffer_weights=weights)
    got = stb.run(feats)
    assert got.shape == (TT, N_SPK) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_runs[weights], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:BLOCK], jax_runs["fifo"][:BLOCK], atol=1e-5, rtol=0)


def test_flex_stb_blocks_match_jax_scorer_on_its_buffers(shared):
    """Block by block on the JAX streamer's own buffers (v1): the port's
    scorer gives the JAX padded scorer's logits within 1e-5 for every
    buffer + block it was given."""
    params, model, feats = shared
    jstb = JS.FlexSTB(params=params, cfg=JCFG, n_speakers=N_SPK, buf_size=BUF,
                      block_size=BLOCK, buffer_weights="v1")
    seen = []
    orig = jstb._pad_score

    def spy(inp):
        out = orig(inp)
        seen.append((inp.copy(), np.asarray(out)))
        return out

    jstb._pad_score = spy
    with jax.default_matmul_precision("highest"):
        jstb.run(feats)
    stb = TS.FlexSTB(model, TCFG, N_SPK, buf_size=BUF, block_size=BLOCK)
    assert len(seen) == TT // BLOCK and len(seen[-1][0]) == BUF + BLOCK
    for i, (inp, want) in enumerate(seen):
        np.testing.assert_allclose(stb.score(inp), want, atol=1e-5, rtol=0, err_msg=f"block {i}")


def test_padded_scoring_equals_unpadded(shared):
    """eda_test on a batch padded past each length with `lens` (the JAX
    scorer's fixed shape) equals eda_test on each true-length sequence:
    the valid frames' logits, the attractors, the existence."""
    _, model, feats = shared
    lens = [17, 40]
    padded = np.zeros((2, 52, JCFG.in_size), np.float32)
    for b, n in enumerate(lens):
        padded[b, :n] = feats[b:b + n]
    out = T.eda_test(model, torch.as_tensor(padded), n_attractors=3, lens=torch.as_tensor(lens))
    for b, n in enumerate(lens):
        exact = T.eda_test(model, torch.as_tensor(padded[b:b + 1, :n]), n_attractors=3)
        torch.testing.assert_close(out["logits"][b, :n], exact["logits"][0], atol=2e-6, rtol=0)
        torch.testing.assert_close(out["attractors"][b], exact["attractors"][0], atol=2e-6,
                                   rtol=0)
        torch.testing.assert_close(out["exist_probs"][b], exact["exist_probs"][0], atol=2e-6,
                                   rtol=0)


def test_flex_stb_refuses_an_unknown_buffer_form(shared):
    _, model, _ = shared
    with pytest.raises(ValueError, match="buffer_weights"):
        TS.FlexSTB(model, TCFG, N_SPK, buffer_weights="lifo")
