"""PyTorch port, EEND-EDA: the LSTM scan (with and without `lens`),
`encode`, `eda_attractors`, `eda_forward` and `eda_test` (`lens`,
`n_attractors`, the time shuffle) against the JAX package's
`fseend_tpu.models.eend_eda` on the same weights (carried by
`utils/convert.py:eda_params_from_jax`); the converter's round trip; the
attractor-existence loss and the EDA `compute_loss` with its gradients
against `jax.value_and_grad`; three Noam-Adam steps against optax; EDA
`run_training` with a checkpoint the JAX package reads, a resume and
`average_epoch_range`; the dropout sites' keep rate and scale; a seeded
step repeated bit for bit.

Tolerances: 1e-5 between the two packages' float32 outputs and losses on
the same inputs (another summation order); gradients rtol 1e-4 + atol
1e-5; post-step weights 1e-5 (three Adam steps of at most lr each).
There is no EDA golden: the reference for the port is the JAX function."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fseend_tpu.models import eend_eda as J
from fseend_tpu.train import losses as JL
from fseend_tpu.train import optim as JO
from fseend_tpu.train import trainer as JTRN
from fseend_tpu.utils import checkpoint as JCK
from fseend_tpu_torch.models import eend_eda as T
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.train import loop as LOOP
from fseend_tpu_torch.train import losses as TL
from fseend_tpu_torch.train import optim as TO
from fseend_tpu_torch.train import trainer as TRN
from fseend_tpu_torch.utils import checkpoint as CK
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
JCFG = J.EDAConfig(in_size=24, n_units=32, n_heads=4, n_layers=2, dim_feedforward=64,
                   dropout=0.0, max_attractors=5)
TCFG = T.EDAConfig(**dataclasses.asdict(JCFG))
ATOL = 1e-5
B, TT, S = 3, 40, 3
LENS = np.array([40, 31, 17])
N_SPK = np.array([3, 2, 1])
SHUFFLE_SEED = 11
LOSSES = ("pit_loss", "emb_loss", "tot_loss")


def _np(x):
    return np.array(x, dtype=np.float32)


def _batch():
    rng = np.random.default_rng(3)
    labels = (rng.uniform(size=(B, TT, S)) > 0.55).astype(np.float32)
    for b in range(B):
        labels[b, :, N_SPK[b]:] = 0.0
        labels[b, LENS[b]:] = 0.0
    feats = (labels @ rng.standard_normal((S, JCFG.in_size))
             + 0.5 * rng.standard_normal((B, TT, JCFG.in_size))).astype(np.float32)
    return {"feats": feats, "labels": labels, "lens": LENS.astype(np.int32),
            "n_spk": N_SPK.astype(np.int32)}


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _lstm_inputs():
    """(h0 (B, D), xs (B, T, D)): an initial state and the LSTM's inputs."""
    rng = np.random.default_rng(7)
    return (rng.standard_normal((B, JCFG.n_units)).astype(np.float32),
            rng.standard_normal((B, TT, JCFG.n_units)).astype(np.float32))


def _order():
    """The time order eda_test draws from a generator seeded SHUFFLE_SEED."""
    return torch.randperm(TT, generator=torch.Generator().manual_seed(SHUFFLE_SEED)).numpy()


@pytest.fixture(scope="module")
def shared():
    """(the JAX init's params, the port's EENDEDA carrying them)."""
    params, mstate = J.init_eend_eda(jax.random.PRNGKey(4), JCFG)
    assert mstate == {}
    return params, CV.eda_params_from_jax(jax.tree.map(np.asarray, params), TCFG, "cpu")


@pytest.fixture(scope="module")
def jax_ref(shared):
    """One JAX program (one compile at XLA's lowest optimization level):
    every model function on the shared batch and compute_loss with its
    gradients; returned with its results on the shared weights."""
    params, _ = shared
    batch = _batch()
    xs = jnp.asarray(batch["feats"])
    lens = jnp.asarray(batch["lens"])
    order = jnp.asarray(_order())
    h0, ys = _lstm_inputs()
    h0, ys = jnp.asarray(h0), jnp.asarray(ys)

    def ref(params):
        p = params["eda"]["encoder"]
        out = {"scan": J.lstm_scan(p, ys), "scan_lens": J.lstm_scan(p, ys, lens=lens),
               "scan_h0": J.lstm_scan(p, ys, h0, -h0, lens=lens)}
        emb = J.encode(params, JCFG, xs)
        out["emb"] = emb
        out["emb_lens"] = J.encode(params, JCFG, xs, lens=lens)
        out["attr"] = J.eda_attractors(params, emb, S + 1)
        out["attr_lens"] = J.eda_attractors(params, out["emb_lens"], S + 1, lens=lens)
        out["attr_shuffled"] = J.eda_attractors(params, emb[:, order], JCFG.max_attractors)
        out["forward"] = J.eda_forward(params, JCFG, xs, S)
        out["test"] = J.eda_test(params, JCFG, xs)
        out["test_lens"] = J.eda_test(params, JCFG, xs, n_attractors=2, lens=lens)
        task = JTRN.TaskConfig(model="eda", label_mode="pit")
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        out["loss"] = jax.value_and_grad(
            lambda q: JTRN.compute_loss(task, JCFG, q, {}, jb, None, train=True),
            has_aux=True)(params)
        return out

    with jax.default_matmul_precision("highest"):
        fn = jax.jit(ref).lower(params).compile(compiler_options={
            "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return fn, batch, fn(params)


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=atol, rtol=0, err_msg=msg)


@pytest.mark.parametrize("case", ["scan", "scan_lens", "scan_h0"])
def test_lstm_scan_matches_jax(shared, jax_ref, case):
    """The encoder LSTM over a ragged batch: outputs and the final state,
    without `lens`, with it (the state frozen past each length), and from
    a given (h0, c0)."""
    _, model = shared
    _, batch, want = jax_ref
    h0, xs = (torch.as_tensor(a) for a in _lstm_inputs())
    lens = torch.as_tensor(batch["lens"])
    p = model.eda.encoder
    with torch.no_grad():
        got = {"scan": lambda: T.lstm_scan(p, xs),
               "scan_lens": lambda: T.lstm_scan(p, xs, lens=lens),
               "scan_h0": lambda: T.lstm_scan(p, xs, h0, -h0, lens=lens)}[case]()
    ys, (h, c) = got
    wys, (wh, wc) = want[case]
    _close(ys, wys, msg="outputs")
    _close(h, wh, msg="h_T")
    _close(c, wc, msg="c_T")
    if case != "scan":
        # the frozen state is the output at each sequence's last valid frame
        torch.testing.assert_close(h, ys[torch.arange(B), lens - 1], atol=0, rtol=0)


def test_lstm_cell_is_one_scan_step(shared):
    _, model = shared
    rng = np.random.default_rng(8)
    x, h, c = (torch.as_tensor(rng.standard_normal((2, 32)), dtype=torch.float32)
               for _ in range(3))
    with torch.no_grad():
        hc = T.lstm_cell(model.eda.decoder, x, h, c)
        ys, hc_scan = T.lstm_scan(model.eda.decoder, x[:, None], h, c)
    for a, b in zip(hc, hc_scan):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_encode_and_attractors_match_jax(shared, jax_ref):
    """`encode` without and with the key-padding mask, `eda_attractors`
    with and without `lens`: embeddings, attractors and existence logits."""
    _, model = shared
    _, batch, want = jax_ref
    xs = torch.as_tensor(batch["feats"])
    lens = torch.as_tensor(batch["lens"])
    with torch.no_grad():
        emb = T.encode(model, xs)
        emb_l = T.encode(model, xs, lens=lens)
        attr = T.eda_attractors(model, emb, S + 1)
        attr_l = T.eda_attractors(model, emb_l, S + 1, lens=lens)
    _close(emb, want["emb"], msg="emb")
    _close(emb_l, want["emb_lens"], msg="emb with lens")
    for got, w, what in ((attr, want["attr"], "attractors"),
                         (attr_l, want["attr_lens"], "attractors with lens")):
        _close(got[0], w[0], msg=what)
        _close(got[1], w[1], msg=what + ": existence logits")


def test_eda_forward_matches_jax(shared, jax_ref):
    """eda_forward (S + 1 attractors, logits on the first S): every output,
    without autograd in eval and with it at train=True."""
    _, model = shared
    _, batch, want = jax_ref
    got = T.eda_forward(model, torch.as_tensor(batch["feats"]), S)
    for key in ("logits", "emb", "attractors", "exist_logits"):
        _close(got[key], want["forward"][key], msg=key)
    assert got["logits"].shape == (B, TT, S) and not got["logits"].requires_grad
    assert T.eda_forward(model, torch.as_tensor(batch["feats"]), S,
                         train=True)["logits"].requires_grad


def test_eda_test_matches_jax(shared, jax_ref):
    """eda_test with the default attractor count (cfg.max_attractors) and
    with n_attractors=2 and `lens` (the valid frames only: the JAX package
    says the rest are garbage): logits, attractors, existence
    probabilities."""
    _, model = shared
    _, batch, want = jax_ref
    xs = torch.as_tensor(batch["feats"])
    got = T.eda_test(model, xs)
    for key in ("logits", "attractors", "exist_probs"):
        _close(got[key], want["test"][key], msg=key)
    assert got["logits"].shape == (B, TT, JCFG.max_attractors)
    got = T.eda_test(model, xs, n_attractors=2, lens=torch.as_tensor(batch["lens"]))
    for key in ("attractors", "exist_probs"):
        _close(got[key], want["test_lens"][key], msg=key + " with lens")
    for b, n in enumerate(batch["lens"]):
        _close(got["logits"][b, :n], want["test_lens"]["logits"][b, :n], msg=f"logits {b}")


def test_eda_test_shuffle_reads_the_drawn_order(shared, jax_ref):
    """With the time shuffle the attractors are JAX's `eda_attractors` on
    the embeddings in the order the port's generator draws (the packages
    draw different orders); the logits keep the time order; the shuffle
    and `lens` together are refused."""
    _, model = shared
    _, batch, want = jax_ref
    xs = torch.as_tensor(batch["feats"])
    got = T.eda_test(model, xs, shuffle_generator=torch.Generator().manual_seed(SHUFFLE_SEED))
    attr, exist = want["attr_shuffled"]
    _close(got["attractors"], attr, msg="attractors")
    _close(got["exist_probs"], jax.nn.sigmoid(exist), msg="existence")
    torch.testing.assert_close(got["logits"], torch.einsum("btd,bcd->btc", got["emb"],
                                                           got["attractors"]))
    assert not np.array_equal(_order(), np.arange(TT))
    with pytest.raises(ValueError, match="shuffle"):
        T.eda_test(model, xs, shuffle_generator=torch.Generator(), lens=torch.as_tensor(LENS))


def test_params_round_trip_exact(shared):
    """eda_params_to_jax(eda_params_from_jax(tree)) is the JAX init's tree
    leaf for leaf, bit for bit (the static `_n_heads` aside), and the
    port's own initializer gives the JAX tree's shapes."""
    params, model = shared
    tree, mstate = CV.eda_params_to_jax(model)
    assert mstate == {}
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = {jax.tree_util.keystr(k): v for k, v in got.items()}
    n = 0
    for path, leaf in want:
        key = jax.tree_util.keystr(path)
        if "_n_heads" in key:
            continue
        np.testing.assert_array_equal(got[key], np.asarray(leaf), err_msg=key)
        n += 1
    assert n == len(got)
    fresh = T.init_eend_eda(TCFG, torch.Generator().manual_seed(0), device="cpu")
    ftree, _ = CV.eda_params_to_jax(fresh)
    shapes = {jax.tree_util.keystr(k): v.shape
              for k, v in jax.tree_util.tree_leaves_with_path(ftree)}
    assert shapes == {jax.tree_util.keystr(k): np.shape(v) for k, v in want
                      if "_n_heads" not in jax.tree_util.keystr(k)}
    with torch.no_grad():
        assert float(fresh.enc.proj.weight.abs().max()) <= 0.1
        assert float(fresh.eda.encoder.weight_hh.abs().max()) <= 32 ** -0.5


def test_attractor_existence_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 6)).astype(np.float32) * 3
    n_spk = np.array([0, 2, 5, 3])
    got = TL.attractor_existence_loss(torch.as_tensor(logits), torch.as_tensor(n_spk))
    want = JL.attractor_existence_loss(jnp.asarray(logits), jnp.asarray(n_spk))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _task():
    return TRN.TaskConfig(model="eda", label_mode="pit")


def _as_port(tree):
    m = CV.eda_params_from_jax(jax.tree.map(np.asarray, tree), TCFG, "cpu")
    return {n: p.detach().numpy() for n, p in m.named_parameters()}


def test_compute_loss_and_gradients_match_jax(shared, jax_ref):
    """The EDA compute_loss (PIT over every speaker column, the existence
    loss): every metric, and every gradient leaf against JAX's
    `jax.value_and_grad` on the same weights and ragged batch."""
    _, model = shared
    _, batch, want = jax_ref
    (_, (_, want_m)), want_g = want["loss"]
    model.zero_grad(set_to_none=True)
    loss, (bn_state, metrics) = TRN.compute_loss(_task(), model, _tbatch(batch), None,
                                                 train=True)
    loss.backward()
    assert bn_state == {}
    assert set(metrics) == set(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=ATOL, err_msg=k)
    wg = _as_port(want_g)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), wg[name], rtol=1e-4, atol=1e-5,
                                   err_msg=f"gradient of {name}")
    model.zero_grad(set_to_none=True)


def test_three_noam_adam_steps_match_optax(shared, jax_ref):
    """Three make_train_step steps with Noam-Adam (the JAX package's
    build_optimizer, clipping on) against JAX's value_and_grad, optax's
    update and apply_updates from the same weights: each step's losses,
    the weights after the last.  The attention's key bias is held apart:
    the softmax does not depend on it, so its true gradient is 0 and both
    packages get float32 rounding noise, which Adam (eps 1e-9) scales up
    to steps of the learning rate's size in either direction; that its
    gradient is noise in both is checked instead."""
    params, model0 = shared
    fn, batch, _ = jax_ref
    model = T.empty_eend_eda(TCFG, "cpu")
    model.load_state_dict(model0.state_dict())
    kw = dict(d_model=32, warmup_steps=4, grad_clip=0.5)
    tx = TO.build_optimizer("noam", 1.0, **kw)
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(_task(), TCFG, tx, device="cpu")
    jtx = JO.build_optimizer("noam", 1.0, **kw)
    jupdate = jax.jit(jtx.update)
    opt = jtx.init(params)
    D = TCFG.n_units
    key_bias = slice(D, 2 * D)
    for i in range(3):
        state, metrics = step(state, _tbatch(batch), 0)
        (_, (_, jm)), grads = fn(params)["loss"]
        for layer, jl in zip(model.enc.layers, grads["enc"]["layers"]):
            assert float(layer.self_attn.in_proj.bias.grad[key_bias].abs().max()) < 1e-6
            assert float(jnp.abs(jl["self_attn"]["in_proj"]["bias"][key_bias]).max()) < 1e-6
        updates, opt = jupdate(grads, opt, params)
        params = optax.apply_updates(params, updates)
        for k in LOSSES:
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-4, atol=ATOL,
                                       err_msg=f"{k} step {i}")
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(grads)),
                                   rtol=1e-4)
    want = _as_port(params)
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name]
        if name.endswith("self_attn.in_proj.bias"):
            got, w = np.delete(got, key_bias), np.delete(w, key_bias)
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=0, err_msg=name)


def test_dropout_sites_keep_rate_and_scale(shared, jax_ref):
    """At dropout 0.25 the training pass draws 4 masks per encoder layer
    (attention weights, attention output, the FFN twice), as the JAX
    `transformer_layer` does, and none in the LSTMs; each keeps within 5
    sigma of 75 % of its elements and scales them by exactly 1 / 0.75."""
    _, model = shared
    _, batch, _ = jax_ref
    cfg = dataclasses.replace(TCFG, dropout=0.25)
    calls = []
    orig = tnn.dropout

    def spy(x, rate, generator):
        y = orig(x, rate, generator)
        if rate > 0 and generator is not None:
            calls.append((x.detach(), y.detach()))
        return y

    tnn.dropout = spy
    try:
        T.eda_forward(TRN.ls_eend.with_cfg(model, cfg), torch.as_tensor(batch["feats"]), S,
                      train=True, generator=torch.Generator().manual_seed(3))
    finally:
        tnn.dropout = orig
    assert len(calls) == 4 * cfg.n_layers
    for i, (x, y) in enumerate(calls):
        kept = y != 0
        nz = x != 0
        n = int(nz.sum())
        rate = float((kept & nz).sum()) / n
        assert abs(rate - 0.75) <= 5 * (0.75 * 0.25 / n) ** 0.5, (i, rate, n)
        torch.testing.assert_close(y[kept], x[kept] / 0.75, atol=0, rtol=0)


def test_seeded_step_repeats_bit_for_bit(shared):
    """Two EDA train steps from the same weights with the same seed,
    dropout 0.1: the same parameters bit for bit; another seed gives
    others."""
    _, model0 = shared
    cfg = dataclasses.replace(TCFG, dropout=0.1)
    tx = TO.build_optimizer("noam", 1.0, d_model=32, warmup_steps=10)
    batch = _tbatch(_batch())
    out = []
    for seed in (5, 5, 6):
        model = T.empty_eend_eda(cfg, "cpu")
        model.load_state_dict(model0.state_dict())
        state = TRN.TrainState.create(model, tx)
        state, _ = TRN.make_train_step(_task(), cfg, tx, device="cpu")(state, batch, seed)
        out.append(state.model.state_dict())
    for name, a in out[0].items():
        torch.testing.assert_close(a, out[1][name], atol=0, rtol=0, msg=name)
    assert not torch.equal(out[0]["enc.proj.weight"], out[2]["enc.proj.weight"])


class Items:
    """An in-memory dataset: (feats (T, F), labels (T, S), recording id)."""

    def __init__(self, n, seed, frames=14, in_size=24, spk=2):
        rng = np.random.default_rng(seed)
        self.items = [(rng.standard_normal((frames - i % 3, in_size)).astype(np.float32),
                       (rng.uniform(size=(frames - i % 3, spk)) > 0.5).astype(np.float32),
                       f"rec{i}") for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


SMALL = T.EDAConfig(in_size=24, n_units=16, n_heads=2, n_layers=1, dim_feedforward=24,
                    dropout=0.1)


def _train(tmp_path, name, **kw):
    logger = LOOP.MetricsLogger(str(tmp_path), name)
    args = dict(task=_task(), model_cfg=SMALL, train_dataset=Items(4, 0),
                val_dataset=Items(2, 1),
                tx=TO.build_optimizer("noam", 1.0, d_model=16, warmup_steps=10),
                logger=logger, batch_size=2, chunk_size=14, max_speakers=2,
                input_dim=SMALL.in_size, max_epochs=2, seed=7, log_every=1, device="cpu")
    args.update(kw)
    try:
        return LOOP.run_training(**args)
    finally:
        logger.close()


def test_run_training_eda_checkpoints_resumes_and_averages(tmp_path):
    """EDA run_training: two epochs of two steps, validated and
    checkpointed in the JAX package's EDA layout (reloaded bit for bit
    through `load_eend_eda`; the JAX package's `load_pytree` reads it into
    its init's template); one epoch then a resume from its checkpoint
    equals the uninterrupted run; `average_epoch_range` of both epochs (no
    model_state: EEND-EDA has no BatchNorm)."""
    state, ckpt_dir = _train(tmp_path, "full")
    assert state.step == 4 and isinstance(state.model, T.EENDEDA)
    last = ckpt_dir / "ckpt_epoch=1.npz"
    fresh = CK.load_eend_eda(last, SMALL, "cpu")
    for (name, a), b in zip(state.model.state_dict().items(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    jcfg = J.EDAConfig(**dataclasses.asdict(SMALL))
    params, mstate = jax.eval_shape(lambda k: J.init_eend_eda(k, jcfg), jax.random.PRNGKey(0))
    got = JCK.load_pytree(last, {"params": params, "model_state": mstate})
    want, _ = CV.eda_params_to_jax(state.model)
    for leaf in (lambda t: t["eda"]["encoder"]["w_hh"],
                 lambda t: t["enc"]["layers"][0]["linear1"]["kernel"]):
        np.testing.assert_array_equal(np.asarray(leaf(got["params"])), leaf(want))
    recs = (ckpt_dir / "metrics.jsonl").read_text()
    assert "val/DER" in recs and "train/emb_loss" in recs

    _, first_dir = _train(tmp_path, "first", max_epochs=1)
    resumed, _ = _train(tmp_path, "resumed", resume_from=str(first_dir / "ckpt_epoch=0.npz"))
    assert resumed.step == 4
    for (name, a), b in zip(state.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)
    avg, mstate_avg, paths = LOOP.average_epoch_range(ckpt_dir, 0, 1)
    assert len(paths) == 2 and mstate_avg is None
    p0 = CK.load_pytree(paths[0], "params")
    p1 = CK.load_pytree(paths[1], "params")
    counter = [p["eda"]["counter"]["kernel"] for p in (p0, p1)]
    np.testing.assert_allclose(avg["eda"]["counter"]["kernel"], (counter[0] + counter[1]) / 2,
                               rtol=1e-6)
    warm, _ = _train(tmp_path, "warm", max_epochs=0, init_ckpt=str(last))
    for (name, a), b in zip(state.model.state_dict().items(), warm.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_task_config_eda_family():
    """TaskConfig(model="eda") takes any label_mode (the EDA protocol reads
    none; the JAX package's CLI passes "pit"), which LS and FS still refuse;
    a step for EDA refuses another family's config."""
    assert TRN.TaskConfig(model="eda", label_mode="pit").model == "eda"
    with pytest.raises(ValueError, match="label_mode"):
        TRN.TaskConfig(model="fs", label_mode="pit")
    with pytest.raises(TypeError, match="EDAConfig"):
        TRN.make_train_step(_task(), TRN.fs_eend.FSEENDConfig(), TO.Optimizer(), device="cpu")
