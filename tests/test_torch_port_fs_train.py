"""PyTorch port, FS-EEND training: `fs_forward(train=True)` (train-mode
BatchNorm over padded frames, the dropout sites) against the JAX package's
`fseend_tpu.models.fs_eend.fs_forward` on the same weights; the FS
`compute_loss` and its gradients in every label mode against JAX's
`jax.value_and_grad` (one jitted JAX program for all of them) and, in the
golden's protocol, against the reference's own torch run
(`tests/goldens/fs_train_ref.npz`, read through the port's
`utils/torch_convert.py`); a 3-step Adam trajectory against the golden and
against JAX's optax steps; `run_training` for FS with checkpoints in the
JAX package's layout and a resume; the dropout sites' keep rate and scale;
a seeded step repeated bit for bit.

Tolerances: those of the JAX package's `tests/test_train_parity.py` against
the golden (losses rtol 1e-4 at step 0, 2e-4 over the trajectory;
gradients atol 1e-5 + rtol 1e-3; post-step weights atol 1e-4, BatchNorm
statistics 1e-5); 1e-5 between the two packages' forward outputs and
losses on the same inputs (float32 both sides, another summation order)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fseend_tpu.models import fs_eend as J
from fseend_tpu.ops import nn as JNN
from fseend_tpu.train import trainer as JTRN
from fseend_tpu.utils import checkpoint as JCK
from fseend_tpu_torch.models import fs_eend as T
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.train import loop as LOOP
from fseend_tpu_torch.train import optim as TO
from fseend_tpu_torch.train import trainer as TRN
from fseend_tpu_torch.utils import checkpoint as CK
from fseend_tpu_torch.utils import convert as CV
from fseend_tpu_torch.utils import torch_convert as TC

torch.set_num_threads(1)
GOLDENS = pathlib.Path(__file__).parent / "goldens"
# the golden's model (tests/test_train_parity.py:FS_CFG), held to the golden
# by the port alone
GCFG = T.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=2,
                      enc_dim_feedforward=2048, dec_dim_feedforward=64, conv_delay=9,
                      max_nspks=5, dropout=0.0)
# a smaller one for the comparisons with JAX (whose compile time grows with
# the layers)
JCFG = J.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=1,
                      enc_dim_feedforward=64, dec_dim_feedforward=64, conv_delay=3,
                      max_nspks=5, dropout=0.0)
TCFG = T.FSEENDConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
ATOL = 1e-5
MODES = ("fixed", "spk_pit", "spk_pit_hungarian")
LOSSES = ("pit_loss", "emb_loss", "tot_loss")


def _np(x):
    return np.array(x, dtype=np.float32)


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDENS / "fs_train_ref.npz")

    def sub(prefix):
        return {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}

    batch = {k: g[k] for k in ("feats", "labels", "lens", "n_spk")}
    return g["steps"], sub("sd__"), sub("gr__"), sub("sdN__"), batch


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(model):
    """Every parameter's gradient by name (zeros for the unused norm12, as
    JAX and the reference give)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def shared():
    """(the port's FSEEND of TCFG, the same weights as a JAX (params,
    model_state)): the port's initializer with random attention biases and
    BatchNorm statistics, carried into a JAX pytree whose static metadata
    comes from `jax.eval_shape` of the JAX init."""
    model = T.init_fs_eend(TCFG, torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tnn.MultiheadAttention):
                m.in_proj.bias.copy_(torch.as_tensor(rng.normal(0, 0.1, m.in_proj.bias.shape)))
        model.enc.bn.running_mean.copy_(torch.as_tensor(rng.normal(0, 0.2, TCFG.in_size)))
        model.enc.bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, TCFG.in_size)))
    tree, mstate = CV.fs_params_to_jax(model)
    shapes, _ = jax.eval_shape(lambda k: J.init_fs_eend(k, JCFG), jax.random.PRNGKey(0))

    def leaf(path, _):
        node = tree
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        return jnp.asarray(node)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    return model, params, jax.tree.map(jnp.asarray, mstate)


@pytest.fixture(scope="module")
def jax_ref(shared, golden):
    """One JAX program (one compile, at XLA's lowest optimization level: it
    runs a few times and compiles for most of its cost): the training
    forward and compute_loss with its gradients in every label mode, on the
    golden's batch (lengths 16 and 12); returned with its results on the
    shared weights."""
    *_, batch = golden

    def ref(params, mstate):
        fwd = J.fs_forward(params, mstate, JCFG, jnp.asarray(batch["feats"]),
                           jnp.asarray(batch["lens"]), 5, train=True)
        out = {}
        for mode in MODES:
            task = JTRN.TaskConfig(model="fs", label_mode=mode)
            out[mode] = jax.value_and_grad(
                lambda p: JTRN.compute_loss(task, JCFG, p, mstate, _jbatch(batch), None,
                                            train=True), has_aux=True)(params)
        return fwd, out

    _, params, mstate = shared
    with jax.default_matmul_precision("highest"):
        fn = jax.jit(ref).lower(params, mstate).compile(compiler_options={
            "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return fn, batch, fn(params, mstate)


def _as_port(tree, mstate):
    """A JAX (params-shaped tree, model_state) as the port's named tensors."""
    m = CV.fs_params_from_jax(jax.tree.map(np.asarray, tree), jax.tree.map(np.asarray, mstate),
                              TCFG, "cpu")
    return {n: p.detach().numpy() for n, p in m.named_parameters()}


def test_batch_norm_train_counts_padded_frames_as_jax():
    """The train-mode BatchNorm over a padded batch whose frames past each
    length hold -1 (what `encode` feeds it): the same normalized output and
    running statistics as the JAX package's `batch_norm(train=True)`."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, 5)).astype(np.float32) * 2 + 0.5
    lens = np.array([11, 6, 2])
    x = np.where((np.arange(11)[None, :] < lens[:, None])[..., None], x, -1.0).astype(np.float32)
    bn = torch.nn.BatchNorm1d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, 5)))
        bn.bias.copy_(torch.as_tensor(rng.normal(0, 0.3, 5)))
        bn.running_mean.copy_(torch.as_tensor(rng.normal(0, 0.2, 5)))
        bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, 5)))
    p = {"scale": jnp.asarray(_np(bn.weight.detach())), "bias": jnp.asarray(_np(bn.bias.detach()))}
    st = {"mean": jnp.asarray(_np(bn.running_mean)), "var": jnp.asarray(_np(bn.running_var))}
    want, want_st = JNN.batch_norm(p, st, jnp.asarray(x), train=True)
    got, got_st = tnn.batch_norm_train(torch.as_tensor(x), bn)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_st[k].numpy(), _np(want_st[k]), atol=1e-7, err_msg=k)


def test_fs_forward_train_matches_jax(shared, jax_ref):
    """fs_forward(train=True) at dropout 0 on a ragged batch (the golden's
    feats, lengths 16 and 12): logits, emb,
    attractors and the new BatchNorm statistics, and the pass carries
    autograd (train=False does not)."""
    model, *_ = shared
    _, b, (want, _) = jax_ref
    got = T.fs_forward(model, torch.as_tensor(b["feats"]), torch.as_tensor(b["lens"]), 5,
                       train=True)
    for key in ("logits", "emb", "attractors"):
        np.testing.assert_allclose(got[key].detach().numpy(), _np(want[key]), atol=ATOL,
                                   err_msg=key)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got["state"]["bn"][k].numpy(), _np(want["state"]["bn"][k]),
                                   atol=ATOL, err_msg=k)
    assert got["logits"].requires_grad
    ev = T.fs_forward(model, torch.as_tensor(b["feats"]), torch.as_tensor(b["lens"]), 5)
    assert not ev["logits"].requires_grad
    torch.testing.assert_close(ev["state"]["bn"]["mean"], model.enc.bn.running_mean)


def _task(mode):
    return TRN.TaskConfig(model="fs", label_mode=mode)


@pytest.mark.parametrize("mode", MODES)
def test_step0_losses_and_gradients_match_jax(shared, jax_ref, golden, mode):
    """compute_loss and its backward in each label mode: every metric, the
    new BatchNorm statistics and every gradient leaf against JAX's
    `jax.value_and_grad` on the same weights and the golden's batch."""
    model, *_ = shared
    *_, batch = golden
    _, _, (_, out) = jax_ref
    (_, (want_state, want_m)), want_g = out[mode]
    model.zero_grad(set_to_none=True)
    loss, (bn_state, metrics) = TRN.compute_loss(_task(mode), model, _tbatch(batch), None,
                                                 train=True)
    loss.backward()
    for k, v in want_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=ATOL, atol=ATOL, err_msg=k)
    for k in ("mean", "var"):
        np.testing.assert_allclose(bn_state["bn"][k].numpy(), _np(want_state["bn"][k]),
                                   atol=ATOL)
    want = _as_port(want_g, want_state)
    for name, g in _grads(model).items():
        np.testing.assert_allclose(g, want[name], atol=1e-5, rtol=1e-3,
                                   err_msg=f"gradient of {name} against JAX")


def test_step0_losses_and_gradients_match_golden(golden):
    """The reference's own step-0 losses and every gradient, through the
    port's state-dict reader ("fixed" labels, the golden's protocol)."""
    steps, sd, gr, _, batch = golden
    model = TC.fs_from_state_dict(sd, GCFG, "cpu")
    loss, (_, metrics) = TRN.compute_loss(_task("fixed"), model, _tbatch(batch), None,
                                          train=True)
    loss.backward()
    for i, k in enumerate(LOSSES):
        np.testing.assert_allclose(float(metrics[k]), steps[0][i], rtol=1e-4, err_msg=k)
    full = {k: np.zeros_like(v) for k, v in sd.items()}
    full.update(gr)
    ref = dict(TC.fs_from_state_dict(full, GCFG, "cpu").named_parameters())
    for name, g in _grads(model).items():
        np.testing.assert_allclose(g, ref[name].detach().numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=f"gradient of {name}")


def test_three_step_adam_trajectory_matches_golden(golden):
    """make_train_step for three Adam steps (torch.optim.Adam's defaults,
    the golden's): every step's losses against the reference, the post-step
    weights and BatchNorm statistics against its final state dict."""
    steps, sd, _, sdN, batch = golden
    model = TC.fs_from_state_dict(sd, GCFG, "cpu")
    tx = TO.Optimizer("adam", 1e-3)
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(_task("fixed"), GCFG, tx, device="cpu")
    for i in range(steps.shape[0]):
        state, metrics = step(state, _tbatch(batch), 0)
        for j, k in enumerate(LOSSES):
            np.testing.assert_allclose(float(metrics[k]), steps[i][j], rtol=2e-4,
                                       err_msg=f"{k} step {i}")
    ref = TC.fs_from_state_dict(sdN, GCFG, "cpu").state_dict()
    for name, t in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            atol = 1e-5 if "running_" in name else 1e-4
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(), atol=atol, err_msg=name)


def test_three_step_adam_trajectory_matches_jax(shared, jax_ref, golden):
    """Three make_train_step steps against the JAX package's optax steps
    (value_and_grad of compute_loss, `tx.update`, `apply_updates`, the new
    BatchNorm state carried: what its `make_train_step` does) from the same
    weights: the losses of every step, the weights and BatchNorm statistics
    after the last."""
    model0, params, mstate = shared
    fn, _, _ = jax_ref
    *_, batch = golden
    model = T.empty_fs_eend(TCFG, "cpu")
    model.load_state_dict(model0.state_dict())
    tx = TO.Optimizer("adam", 1e-3)
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(_task("fixed"), TCFG, tx, device="cpu")
    jtx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jupdate = jax.jit(jtx.update)
    opt = jtx.init(params)
    for i in range(3):
        state, metrics = step(state, _tbatch(batch), 0)
        (_, (mstate, jmetrics)), grads = fn(params, mstate)[1]["fixed"]
        updates, opt = jupdate(grads, opt, params)
        params = optax.apply_updates(params, updates)
        for k in LOSSES:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=ATOL,
                                       atol=ATOL, err_msg=f"{k} step {i}")
    want = CV.fs_params_from_jax(jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray, mstate), TCFG, "cpu").state_dict()
    for name, t in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            atol = 1e-5 if "running_" in name else 1e-4
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=atol, err_msg=name)


def test_dropout_sites_keep_rate_and_scale(golden):
    """At dropout 0.25 the training pass draws 4 masks per encoder layer
    (attention weights, attention output, the FFN twice) and 4 per decoder
    layer (both attentions' weights and outputs), as the JAX call sites
    do; each keeps within 5 sigma of 75 % of its elements and scales them
    by exactly 1 / 0.75."""
    _, sd, _, _, batch = golden
    cfg = dataclasses.replace(GCFG, dropout=0.25)
    model = TC.fs_from_state_dict(sd, cfg, "cpu")
    calls = []
    orig = tnn.dropout

    def spy(x, rate, generator):
        y = orig(x, rate, generator)
        if rate > 0 and generator is not None:
            calls.append((x.detach(), y.detach()))
        return y

    tnn.dropout = spy
    try:
        T.fs_forward(model, torch.as_tensor(batch["feats"]), torch.as_tensor(batch["lens"]), 5,
                     train=True, generator=torch.Generator().manual_seed(3))
    finally:
        tnn.dropout = orig
    assert len(calls) == 4 * cfg.enc_n_layers + 4 * cfg.dec_n_layers
    for i, (x, y) in enumerate(calls):
        kept = y != 0
        nz = x != 0
        n = int(nz.sum())
        rate = float((kept & nz).sum()) / n
        assert abs(rate - 0.75) <= 5 * (0.75 * 0.25 / n) ** 0.5, (i, rate, n)
        torch.testing.assert_close(y[kept], x[kept] / 0.75, atol=0, rtol=0)


def test_seeded_step_repeats_bit_for_bit(golden):
    """Two train steps from the same weights with the same seed, dropout
    on: the same parameters, moments and BatchNorm statistics, bit for bit;
    another seed gives other parameters."""
    _, sd, _, _, batch = golden
    cfg = dataclasses.replace(GCFG, dropout=0.1)
    task = _task("fixed")
    tx = TO.build_optimizer("noam", 1.0, d_model=cfg.n_units, warmup_steps=10)
    out = []
    for seed in (5, 5, 6):
        model = TC.fs_from_state_dict(sd, cfg, "cpu")
        state = TRN.TrainState.create(model, tx)
        state, _ = TRN.make_train_step(task, cfg, tx, device="cpu")(state, _tbatch(batch), seed)
        out.append(state.model.state_dict())
    for name, a in out[0].items():
        torch.testing.assert_close(a, out[1][name], atol=0, rtol=0, msg=name)
    assert not torch.equal(out[0]["enc.proj.weight"], out[2]["enc.proj.weight"])


class Items:
    """An in-memory dataset: (feats (T, F), labels (T, S), recording id)."""

    def __init__(self, n, seed, frames=12, in_size=23, spk=2):
        rng = np.random.default_rng(seed)
        self.items = [(rng.standard_normal((frames - i % 3, in_size)).astype(np.float32),
                       (rng.uniform(size=(frames - i % 3, spk)) > 0.5).astype(np.float32),
                       f"rec{i}") for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


SMALL = T.FSEENDConfig(in_size=23, n_units=16, n_heads=2, enc_n_layers=1, dec_n_layers=1,
                       enc_dim_feedforward=24, dec_dim_feedforward=24, conv_delay=2,
                       max_nspks=4, dropout=0.1)


def _train(tmp_path, name, **kw):
    logger = LOOP.MetricsLogger(str(tmp_path), name)
    args = dict(task=_task("fixed"), model_cfg=SMALL, train_dataset=Items(4, 0),
                val_dataset=Items(2, 1),
                tx=TO.build_optimizer("noam", 1.0, d_model=16, warmup_steps=10),
                logger=logger, batch_size=2, chunk_size=12, max_speakers=2,
                input_dim=SMALL.in_size, max_epochs=2, seed=7, log_every=1, device="cpu")
    args.update(kw)
    try:
        return LOOP.run_training(**args)
    finally:
        logger.close()


def test_run_training_fs_checkpoints_and_resumes(tmp_path):
    """FS run_training: two epochs of two steps, validated and
    checkpointed in the JAX package's FS layout (a fresh model reloaded bit
    for bit through `load_fs_eend`; the file loads into the JAX package's
    template); one epoch then a resume from its checkpoint equals the
    uninterrupted run; `average_epoch_range` of the two epochs."""
    state, ckpt_dir = _train(tmp_path, "full")
    assert state.step == 4
    assert isinstance(state.model, T.FSEEND)
    last = ckpt_dir / "ckpt_epoch=1.npz"
    fresh = CK.load_fs_eend(last, SMALL, "cpu")
    for (name, a), b in zip(state.model.state_dict().items(), fresh.state_dict().values()):
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    jcfg = J.FSEENDConfig(**{f.name: getattr(SMALL, f.name)
                             for f in dataclasses.fields(J.FSEENDConfig)})
    params, mstate = jax.eval_shape(lambda k: J.init_fs_eend(k, jcfg), jax.random.PRNGKey(0))
    got = JCK.load_pytree(last, {"params": params, "model_state": mstate})
    want_p, want_m = CV.fs_params_to_jax(state.model)
    np.testing.assert_array_equal(np.asarray(got["model_state"]["bn"]["var"]), want_m["bn"]["var"])
    np.testing.assert_array_equal(np.asarray(got["params"]["dec"]["layers"][0]["linear1"]["kernel"]),
                                  want_p["dec"]["layers"][0]["linear1"]["kernel"])

    _, first_dir = _train(tmp_path, "first", max_epochs=1)
    resumed, _ = _train(tmp_path, "resumed", resume_from=str(first_dir / "ckpt_epoch=0.npz"))
    assert resumed.step == 4
    for (name, a), b in zip(state.model.state_dict().items(), resumed.model.state_dict().values()):
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)
    avg, mstate_avg, paths = LOOP.average_epoch_range(ckpt_dir, 0, 1)
    assert len(paths) == 2 and "bn" in mstate_avg
    p0 = CK.load_pytree(paths[0], "params")
    p1 = CK.load_pytree(paths[1], "params")
    np.testing.assert_allclose(avg["enc"]["proj"]["kernel"],
                               (p0["enc"]["proj"]["kernel"] + p1["enc"]["proj"]["kernel"]) / 2,
                               rtol=1e-6)


def test_family_and_config_must_agree():
    """A train step for one family refuses the other family's config; the
    port's default family stays "ls"."""
    assert TRN.TaskConfig().model == "ls"
    with pytest.raises(TypeError, match="FSEENDConfig"):
        TRN.make_train_step(_task("fixed"), TRN.ls_eend.LSEENDConfig(), TO.Optimizer(),
                            device="cpu")
    with pytest.raises(TypeError, match="LSEENDConfig"):
        TRN.make_eval_step(TRN.TaskConfig(), GCFG)
