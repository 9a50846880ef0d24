"""PyTorch port, the LS-EEND train step: the label protocol and every
ported loss against the JAX package's `train/labels.py` and
`train/losses.py`; the port's `compute_loss` and its gradients, and a
3-step Adam trajectory with the post-step weights and BatchNorm statistics,
against the reference's own torch run (`tests/goldens/ls_train_ref.npz`,
read through the port's `utils/torch_convert.py`) on both decoder routes;
the Noam schedule, clipping and accumulation against optax.

Tolerances are those of the JAX package's `tests/test_train_parity.py`:
losses rtol 1e-4 (step 0) and 2e-4 (the trajectory), gradients atol 1e-5 +
rtol 1e-3, post-step weights atol 1e-4, BatchNorm statistics atol 1e-5;
1e-5 between the two packages' losses on the same inputs."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fseend_tpu.models import ls_eend as J
from fseend_tpu.train import labels as JL
from fseend_tpu.train import losses as JLS
from fseend_tpu.train import optim as JO
from fseend_tpu.utils import torch_convert as JTC
from fseend_tpu_torch.models import ls_eend as T
from fseend_tpu_torch.parallel import mesh as PM
from fseend_tpu_torch.train import labels as TL
from fseend_tpu_torch.train import losses as TLS
from fseend_tpu_torch.train import optim as TO
from fseend_tpu_torch.train import trainer as TRN
from fseend_tpu_torch.utils import convert as CV
from fseend_tpu_torch.utils import torch_convert as TC

torch.set_num_threads(1)
GOLDENS = pathlib.Path(__file__).parent / "goldens"
CFG = T.LSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=2,
                     chunk_size=8, ff_expansion=2, conv_kernel_size=5, dec_dim_feedforward=64,
                     conv_delay=3, max_nspks=5, dropout=0.0)
TASK = TRN.TaskConfig(label_mode="fixed", masked_emb_loss=True)


def _np(x):
    return np.array(x, dtype=np.float32)


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDENS / "ls_train_ref.npz")

    def sub(prefix):
        return {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}

    batch = {k: torch.as_tensor(g[k]) for k in ("feats", "labels", "lens", "n_spk")}
    return g["steps"], sub("sd__"), sub("gr__"), sub("sdN__"), batch


@pytest.fixture(scope="module")
def diar():
    """Logits, labels, lengths and speaker counts of a small batch."""
    rng = np.random.default_rng(4)
    B, T0, S = 3, 14, 4
    labels = (rng.uniform(size=(B, T0, S)) > 0.6).astype(np.float32)
    labels[2, :, 3] = 0                                   # a silent speaker column
    lens = np.array([14, 9, 11], np.int32)
    n_spk = np.array([4, 2, 3], np.int32)
    logits = (rng.standard_normal((B, T0, S + 2)) * 2).astype(np.float32)
    emb = rng.standard_normal((B, T0, 8)).astype(np.float32)
    emb[1, 9:] = 0                                        # zero rows past a length
    return logits, labels, lens, n_spk, emb


def _t(a):
    return torch.as_tensor(a)


def test_prepare_labels_matches_jax(diar):
    _, labels, lens, n_spk, _ = diar
    want, want_mask = JL.prepare_labels(jnp.asarray(labels), jnp.asarray(lens), jnp.asarray(n_spk))
    got, got_mask = TL.prepare_labels(_t(labels), _t(lens), _t(n_spk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    for a, b in zip(TL.pin_silence_none(got), JL.pin_silence_none(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["standard_bce_loss", "standard_mask_loss", "standard_loss_sep"])
@pytest.mark.parametrize("delay", [0, 2])
def test_frame_losses_match_jax(diar, name, delay):
    logits, labels, lens, n_spk, _ = diar
    slot, mask = JL.prepare_labels(jnp.asarray(labels), jnp.asarray(lens), jnp.asarray(n_spk))
    lg = logits * (0.3 if name == "standard_loss_sep" else 1.0)   # |logit| < 1 for sep
    want = getattr(JLS, name)(jnp.asarray(lg), slot, jnp.asarray(lens), mask, label_delay=delay)
    got = getattr(TLS, name)(_t(lg), _t(np.asarray(slot)), _t(lens), _t(np.asarray(mask)),
                             label_delay=delay)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("from_logits", [True, False])
def test_batch_pit_matches_jax(diar, from_logits):
    logits, labels, lens, n_spk, _ = diar
    lg = logits[..., 1:-1] if from_logits else 1 / (1 + np.exp(-logits[..., 1:-1]))
    want = JLS.batch_pit_loss(jnp.asarray(lg), jnp.asarray(labels), jnp.asarray(lens),
                              jnp.asarray(n_spk), label_delay=1, from_logits=from_logits)
    got = TLS.batch_pit_loss(_t(lg), _t(labels), _t(lens), _t(n_spk), label_delay=1,
                             from_logits=from_logits)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_hungarian_pit_matches_jax(diar):
    logits, labels, lens, n_spk, _ = diar
    want, want_perm = JLS.hungarian_pit_permute(jnp.asarray(logits[..., 1:-1]),
                                                jnp.asarray(labels), jnp.asarray(lens),
                                                jnp.asarray(n_spk))
    lg = _t(logits[..., 1:-1]).requires_grad_(True)
    got, got_perm = TLS.hungarian_pit_permute(lg, _t(labels), _t(lens), _t(n_spk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    assert not got.requires_grad                          # no gradient through the assignment


@pytest.mark.parametrize("form", ["plain", "masked", "ls"])
def test_emb_consistency_losses_match_jax(diar, form):
    _, labels, lens, n_spk, emb = diar
    slot, _ = JL.prepare_labels(jnp.asarray(labels), jnp.asarray(lens), jnp.asarray(n_spk))
    args = (jnp.asarray(emb), slot)
    targs = (_t(emb), _t(np.asarray(slot)))
    if form == "ls":
        want = JLS.emb_consistency_loss_ls(*args, jnp.asarray(lens))
        got = TLS.emb_consistency_loss_ls(*targs, _t(lens))
    else:
        want = JLS.emb_consistency_loss(*args, jnp.asarray(lens), masked=form == "masked")
        got = TLS.emb_consistency_loss(*targs, _t(lens), masked=form == "masked")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the zero rows past a length give a finite gradient (no NaN from sqrt(0))
    e = _t(emb).requires_grad_(True)
    TLS.emb_consistency_loss(e, targs[1]).backward()
    assert torch.isfinite(e.grad).all()


def test_der_counters_match_jax(diar):
    logits, labels, lens, n_spk, _ = diar
    mask = np.arange(4)[None] < n_spk[:, None]
    want = JLS.diarization_error_counters(jnp.asarray(logits[..., 1:-1]), jnp.asarray(labels),
                                          jnp.asarray(lens), jnp.asarray(mask), label_delay=1)
    got = TLS.diarization_error_counters(_t(logits[..., 1:-1]), _t(labels), _t(lens), _t(mask),
                                         label_delay=1)
    assert set(got) == set(want)
    for k in want:
        assert int(got[k]) == int(want[k]), k
    np.testing.assert_allclose(float(TLS.der_from_counters(got)),
                               float(JLS.der_from_counters(want)), rtol=1e-6)


def test_converter_matches_the_jax_package(golden):
    """The port's own reference-state-dict converter == the JAX package's
    converter followed by `ls_params_from_jax`; and ls_params_to_jax
    inverts ls_params_from_jax."""
    _, sd, _, _, _ = golden
    got = TC.ls_from_state_dict(sd, CFG, "cpu")
    jcfg = J.LSEENDConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)
                             if f.name in J.LSEENDConfig.__dataclass_fields__})
    params, mstate = JTC.ls_from_state_dict(sd, jcfg)
    want = CV.ls_params_from_jax(jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray, mstate), CFG, "cpu")
    for (name, a), b in zip(got.state_dict().items(), want.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    p2, m2 = CV.ls_params_to_jax(got)
    back = CV.ls_params_from_jax(p2, m2, CFG, "cpu")
    for (name, a), b in zip(got.state_dict().items(), back.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def _cfg(fused):
    return dataclasses.replace(CFG, use_fused_dec=fused)


@pytest.mark.parametrize("fused", [False, True])
def test_step0_losses_and_gradients_match_golden(golden, fused):
    steps, sd, gr, _, batch = golden
    model = TC.ls_from_state_dict(sd, _cfg(fused), "cpu")
    loss, (_, metrics) = TRN.compute_loss(TASK, model, batch, None, train=True)
    loss.backward()
    for i, k in enumerate(("pit_loss", "emb_loss", "tot_loss")):
        np.testing.assert_allclose(float(metrics[k]), steps[0][i], rtol=1e-4, err_msg=k)
    full = {k: np.zeros_like(v) for k, v in sd.items()}
    full.update(gr)
    ref = dict(TC.ls_from_state_dict(full, CFG, "cpu").named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].detach().numpy(), atol=1e-5,
                                   rtol=1e-3, err_msg=f"gradient of {name}")


@pytest.mark.parametrize("fused", [False, True])
def test_three_step_adam_trajectory(golden, fused):
    steps, sd, _, sdN, batch = golden
    model = TC.ls_from_state_dict(sd, _cfg(fused), "cpu")
    tx = TO.Optimizer("adam", 1e-3)            # torch.optim.Adam's defaults, the golden's
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(TASK, _cfg(fused), tx, device="cpu")
    for i in range(steps.shape[0]):
        state, metrics = step(state, batch, 0)
        for j, k in enumerate(("pit_loss", "emb_loss", "tot_loss")):
            np.testing.assert_allclose(float(metrics[k]), steps[i][j], rtol=2e-4,
                                       err_msg=f"{k} step {i}")
    ref = TC.ls_from_state_dict(sdN, CFG, "cpu").state_dict()
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        atol = 1e-5 if "running_" in name else 1e-4
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), atol=atol, err_msg=name)


def _optax_run(tx, params, grads_seq):
    st = tx.init(params)
    out = []
    for g in grads_seq:
        upd, st = tx.update(g, st, params)
        params = optax.apply_updates(params, upd)
        out.append(params)
    return out


@pytest.mark.parametrize("opt,accum", [("noam", 1), ("adam", 1), ("sgd", 1), ("noam", 2)])
def test_optimizers_match_optax(opt, accum):
    """Noam-Adam, Adam, SGD, clipping (clip 5 against gradients of norm
    around 10 and 0.5) and accumulation: the same parameter trajectory as
    the JAX package's optax chain."""
    rng = np.random.default_rng(8)
    shapes = [(6, 5), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (3.0, 0.1, 2.0, 0.2)]
    kw = dict(d_model=256, warmup_steps=3, grad_clip=5.0, grad_accum=accum)
    lr = 1.0 if opt == "noam" else 0.01
    want = _optax_run(JO.build_optimizer(opt, lr, **kw), [jnp.asarray(p) for p in params],
                      [[jnp.asarray(g) for g in gs] for gs in grads])
    tx = TO.build_optimizer(opt, lr, **kw)
    ps = [torch.as_tensor(p) for p in params]
    st = tx.init(ps)
    for i, gs in enumerate(grads):
        tx.step(ps, [torch.as_tensor(g) for g in gs], st)
        for p, w in zip(ps, want[i]):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7,
                                       err_msg=f"update {i}")
    sched = JO.noam_schedule(256, 3)
    for k in range(5):
        np.testing.assert_allclose(TO.noam_schedule(256, 3)(k), float(sched(jnp.asarray(k))),
                                   rtol=1e-6)


def test_unported_families_say_where_they_are_queued():
    # FS-EEND and EEND-EDA training are ported (tests/test_torch_port_fs_train.py,
    # tests/test_torch_port_eda.py)
    assert TRN.TaskConfig(model="fs").model == "fs"
    assert TRN.TaskConfig(model="eda").model == "eda"
    # bf16 mixed precision is ported (tests/test_torch_port_bf16_train.py)
    assert TRN.TaskConfig(compute_dtype="bf16").compute_dtype == "bf16"
    with pytest.raises(ValueError, match="compute_dtype"):
        TRN.TaskConfig(compute_dtype="f16")
    # data-parallel and tensor-parallel training are ported
    # (tests/test_torch_port_parallel.py, tests/test_torch_port_tp.py); they
    # take a mesh of processes, and a model axis needs its devices
    with pytest.raises(TypeError, match="mesh of processes"):
        TRN.make_train_step(TASK, CFG, TO.Optimizer(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="2 model over 1 devices"):
        PM.make_mesh(n_model=2, devices=["cpu"])
    grid = PM.make_mesh(n_model=2, devices=["cpu", "cpu"])
    assert (grid.n_data, grid.n_model, len(grid.devices)) == (1, 2, 1)


def test_remat_recomputes_the_same_masks(golden):
    """remat (each conformer block recomputed in the backward) with dropout
    on: the same loss, gradients and generator state after the step as
    without it, in float32 and in bf16 (whose recompute must run on the
    bf16 casts of the parameters, not on the float32 masters)."""
    _, sd, _, _, batch = golden
    for dtype in ("f32", "bf16"):
        task = dataclasses.replace(TASK, compute_dtype=dtype)
        out = {}
        for remat in (False, True):
            cfg = dataclasses.replace(CFG, dropout=0.1, remat=remat)
            model = TC.ls_from_state_dict(sd, cfg, "cpu")
            gen = torch.Generator().manual_seed(5)
            loss, _ = TRN.compute_loss(task, model, batch, gen, train=True)
            loss.backward()
            out[remat] = (loss.item(), [p.grad for p in model.parameters()], gen.get_state())
        assert out[True][0] == out[False][0], dtype
        for a, b in zip(out[True][1], out[False][1]):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
        assert torch.equal(out[True][2], out[False][2])
