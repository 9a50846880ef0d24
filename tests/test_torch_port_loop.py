"""PyTorch port, the training loop (`fseend_tpu_torch/train/loop.py`):
`run_training` on an in-memory dataset with validation and per-epoch
checkpoints; checkpoints read by the other package (the JAX package's
`load_pytree` into its own template, and the port's loader on a file the
JAX package wrote); resume against an uninterrupted run; the SIGTERM
checkpoint; `average_epoch_range` against the JAX package's.

A tiny LS-EEND (D 16, one encoder and one decoder layer) on the CPU, the
fused decoder route, dropout on.  Weights round-trip exactly; a resumed run
equals the uninterrupted one to 1e-6 (the same float32 arithmetic, the
moments and the step restored)."""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from fseend_tpu.models import ls_eend as J
from fseend_tpu.train import loop as JLOOP
from fseend_tpu.utils import checkpoint as JCK
from fseend_tpu_torch.models import ls_eend as T
from fseend_tpu_torch.train import loop as LOOP
from fseend_tpu_torch.train import optim
from fseend_tpu_torch.train import trainer as TRN
from fseend_tpu_torch.utils import checkpoint as CK
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
CFG = T.LSEENDConfig(in_size=6, n_units=16, n_heads=2, enc_n_layers=1, dec_n_layers=1,
                     chunk_size=8, ff_expansion=2, conv_kernel_size=3, dec_dim_feedforward=24,
                     conv_delay=2, max_nspks=4, dropout=0.1, use_fused_dec=True,
                     fused_dec_chunk=4)
JCFG = J.LSEENDConfig(**{k: getattr(CFG, k) for k in J.LSEENDConfig.__dataclass_fields__
                         if hasattr(CFG, k)})
TASK = TRN.TaskConfig(label_mode="fixed", masked_emb_loss=True)
FRAMES, SPK = 12, 2


class Items:
    """An in-memory dataset: (feats (T, F), labels (T, S), recording id)."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.items = [(rng.standard_normal((FRAMES - i % 3, CFG.in_size)).astype(np.float32),
                       (rng.uniform(size=(FRAMES - i % 3, SPK)) > 0.5).astype(np.float32),
                       f"rec{i}") for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _train(tmp_path, name, **kw):
    logger = LOOP.MetricsLogger(str(tmp_path), name)
    args = dict(task=TASK, model_cfg=CFG, train_dataset=Items(4, 0), val_dataset=Items(2, 1),
                tx=optim.build_optimizer("noam", 1.0, d_model=16, warmup_steps=10),
                logger=logger, batch_size=2, chunk_size=FRAMES, max_speakers=SPK,
                input_dim=CFG.in_size, max_epochs=2, seed=7, log_every=1, device="cpu")
    args.update(kw)
    try:
        return LOOP.run_training(**args)
    finally:
        logger.close()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two epochs of two steps each, validated and checkpointed."""
    return _train(tmp_path_factory.mktemp("run"), "full")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items() for k2, v in _flat(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v for i, sub in enumerate(tree) for k2, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def test_run_training_logs_validates_and_checkpoints(run):
    state, ckpt_dir = run
    assert state.step == 4
    files = sorted(p.name for p in ckpt_dir.glob("*.npz"))
    assert files == ["ckpt_epoch=0.npz", "ckpt_epoch=1.npz"]
    lines = (ckpt_dir / "metrics.jsonl").read_text().splitlines()
    assert sum('"train/tot_loss"' in ln for ln in lines) == 4
    assert sum('"val/DER"' in ln for ln in lines) == 2
    extra = CK.load_extra(ckpt_dir / "ckpt_epoch=1.npz")
    assert int(extra["epoch"]) == 1 and int(extra["step"]) == 4
    assert np.isfinite(float(extra["val_der"]))


def _jax_template():
    """The JAX package's (params, model_state) structure, shapes only."""
    return jax.eval_shape(lambda k: J.init_ls_eend(k, JCFG), jax.random.PRNGKey(0))


def test_port_checkpoint_loads_into_the_jax_template(run):
    state, ckpt_dir = run
    params, mstate = _jax_template()
    got = JCK.load_pytree(ckpt_dir / "ckpt_epoch=1.npz",
                          {"params": params, "model_state": mstate})
    want_p, want_m = CV.ls_params_to_jax(state.model)
    for tree, want in ((got["params"], want_p), (got["model_state"], want_m)):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat = _flat(want)
        assert len(leaves) == len(flat)
        for path, leaf in leaves:
            key = "/" + "/".join(JCK._key_str(p) for p in path)
            np.testing.assert_array_equal(np.asarray(leaf), flat[key], err_msg=key)
    # and a fresh model reloaded from it is the trained one, bit for bit
    fresh = CK.load_ls_eend(ckpt_dir / "ckpt_epoch=1.npz", CFG, "cpu")
    for (name, a), b in zip(state.model.state_dict().items(), fresh.state_dict().values()):
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_jax_checkpoint_warm_starts_the_port(tmp_path):
    """A file the JAX package's save_pytree wrote (other weights than the
    run's initial ones) is the port's starting point, bit for bit."""
    params, mstate = CV.ls_params_to_jax(
        T.init_ls_eend(CFG, torch.Generator().manual_seed(4), device="cpu"))
    mstate["conv_bn"][0]["mean"] += 0.5
    path = tmp_path / "avg_model.npz"
    JCK.save_pytree(path, {"params": params, "model_state": mstate})
    state, _ = _train(tmp_path, "warm", init_ckpt=str(path), max_epochs=0)
    want = CV.ls_params_from_jax(params, mstate, CFG, "cpu")
    for (name, a), b in zip(state.model.state_dict().items(), want.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_resume_reproduces_the_uninterrupted_run(run, tmp_path):
    state, ckpt_dir = run
    resumed, _ = _train(tmp_path, "resumed", resume_from=str(ckpt_dir / "ckpt_epoch=0.npz"))
    assert resumed.step == state.step
    for (name, a), b in zip(state.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)
    for a, b in zip(state.opt_state["mu"], resumed.opt_state["mu"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_sigterm_saves_a_preemption_checkpoint(tmp_path):
    class Interrupting(Items):
        def __getitem__(self, i):
            # arrives during the first step, and only to run_training's handler
            if signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, before):
                raise RuntimeError("run_training installed no SIGTERM handler")
            os.kill(os.getpid(), signal.SIGTERM)
            return super().__getitem__(i)

    before = signal.getsignal(signal.SIGTERM)
    state, ckpt_dir = _train(tmp_path, "preempt", train_dataset=Interrupting(4, 0))
    assert (ckpt_dir / "ckpt_preempt.npz").exists()
    assert state.step == 1
    extra = CK.load_extra(ckpt_dir / "ckpt_preempt.npz")
    assert int(extra["epoch"]) == -1 and int(extra["step"]) == 1
    assert signal.getsignal(signal.SIGTERM) == before


def test_average_epoch_range_matches_jax(run):
    _, ckpt_dir = run
    params, mstate = _jax_template()
    j_avg, j_m, j_paths = JLOOP.average_epoch_range(ckpt_dir, params, 0, 1, mstate)
    t_avg, t_m, t_paths = LOOP.average_epoch_range(ckpt_dir, 0, 1)
    assert [p.name for p in t_paths] == [p.name for p in j_paths]
    for tree, mine in ((j_avg, t_avg), (j_m, t_m)):
        flat = _flat(mine)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/" + "/".join(JCK._key_str(p) for p in path)
            np.testing.assert_array_equal(np.asarray(leaf), flat[key], err_msg=key)
    with pytest.raises(FileNotFoundError):
        LOOP.average_epoch_range(ckpt_dir, 5, 6)


def test_early_stop_on_validation_der(tmp_path):
    state, ckpt_dir = _train(tmp_path, "early", early_stop_patience=0)
    assert state.step == 2
    assert [p.name for p in ckpt_dir.glob("*.npz")] == ["ckpt_epoch=0.npz"]
