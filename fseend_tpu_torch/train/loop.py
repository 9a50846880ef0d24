"""The epoch loop of LS-EEND, FS-EEND and EEND-EDA training.

Port of `fseend_tpu/train/loop.py`: deterministic sharded sampling,
per-step scalar logging, validation with DER aggregation each
`val_interval` epochs, a checkpoint every epoch, early stopping on the
validation DER, `init_ckpt` warm start, `resume_from` (weights, BatchNorm
statistics, Adam moments and the step count), a checkpoint on SIGTERM, and
the uniform average of an epoch range of checkpoints afterwards.

The datasets are any objects with `__len__` and a `__getitem__` that
returns (feats (T, F), labels (T, S), recording id): `data/dataset.py`'s
`DiarizationDataset` and `OnTheFlyDiarizationDataset` over a Kaldi data
directory, or an in-memory one.  Checkpoints are the JAX package's npz
format for the family (`utils/checkpoint.py` reads both).

With a mesh (`parallel/mesh.py:make_mesh()`, one rank per card) each rank
reads its share of every global batch: the sampler's `num_replicas` is the
number of ranks and it interleaves the shuffled indices, so a step's ranks
together hold the items of the one-process run's step.  Rank 0 alone logs,
validates (on the whole validation set, as the JAX package's replicated
validation batches) and writes the checkpoints, in the JAX layout; the
validation DER and a SIGTERM on any rank reach every rank, so they stop
together.  A resume loads on every rank.

With a model axis (`make_mesh(n_model > 1)`) the sampler, the batch and
the dropout stream follow the data coordinate (the ranks of one model
group read the same rows), the model is sharded after any warm start or
resume has loaded it whole (`parallel/mesh.py:shard_model_`; the resumed
moments are sliced alike), and global rank 0 logs, validates and writes.
The checkpoints stay whole, in the JAX layout: at each epoch's end every
rank gathers the parameters and the moments over its model group
(`whole_state`) before rank 0 validates and writes.
"""

from __future__ import annotations

import json
import signal
import time
from pathlib import Path

import numpy as np
import torch

from fseend_tpu_torch.data.loader import Prefetcher, batched
from fseend_tpu_torch.data.sampler import ShardedSampler
from fseend_tpu_torch.models import eend_eda, fs_eend, ls_eend
from fseend_tpu_torch.parallel import collectives as C
from fseend_tpu_torch.parallel import mesh as pmesh
from fseend_tpu_torch.train import trainer as trainer_lib
from fseend_tpu_torch.utils import checkpoint as ckpt_lib
from fseend_tpu_torch.utils import convert


class MetricsLogger:
    """JSONL scalar logger under log_dir/model_name/version_N (the first N
    not taken)."""

    def __init__(self, log_dir: str, model_name: str):
        base = Path(log_dir) / model_name
        version = 0
        while (base / f"version_{version}").exists():
            version += 1
        self.dir = base / f"version_{version}"
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")

    def log(self, step: int, scalars: dict, prefix: str = ""):
        rec = {"step": step, **{f"{prefix}{k}": _to_float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


_INIT = {"ls": ls_eend.init_ls_eend, "fs": fs_eend.init_fs_eend,
         "eda": eend_eda.init_eend_eda}


def _converters(model):
    """(to_jax(model) -> (params, model_state), from_jax(params,
    model_state, cfg, device) -> module) of the model's family."""
    if isinstance(model, fs_eend.FSEEND):
        return convert.fs_params_to_jax, convert.fs_params_from_jax
    if isinstance(model, eend_eda.EENDEDA):
        return (convert.eda_params_to_jax,
                lambda params, _, cfg, device: convert.eda_params_from_jax(params, cfg, device))
    return convert.ls_params_to_jax, convert.ls_params_from_jax


def save_train_state(path, state: trainer_lib.TrainState, extra: dict) -> None:
    """The JAX layout's params and model_state, the port's opt_state."""
    params, model_state = _converters(state.model)[0](state.model)
    ckpt_lib.save_pytree(path, {"params": params, "model_state": model_state,
                                "opt_state": ckpt_lib.opt_state_tree(state.model,
                                                                     state.opt_state)},
                         extra)


def whole_state(state: trainer_lib.TrainState, mesh) -> trainer_lib.TrainState:
    """The train state with every tensor-parallel shard gathered whole (the
    model and the optimizer's per-parameter tensors); `state` itself when
    nothing is split.  Every rank of the model group calls it."""
    shards = list(C.param_shards(state.model).values())
    if mesh is None or not any(shards):
        return state
    opt = dict(state.opt_state)
    for key in ("mu", "nu", "acc"):
        if key in opt:
            opt[key] = pmesh.gather_full(opt[key], shards, mesh)
    return trainer_lib.TrainState(pmesh.gather_model(state.model, mesh), opt, state.step)


@torch.no_grad()
def load_weights(model, path) -> None:
    """A checkpoint's params (and model_state, when it has one) into
    `model` (any family); a file of bare params (no "params/" level) is
    accepted too."""
    cfg = model.cfg
    params = ckpt_lib.load_pytree(path, "params") if ckpt_lib.has_subtree(path, "params") \
        else ckpt_lib.load_pytree(path, "")
    to_jax, from_jax = _converters(model)
    mstate = ckpt_lib.load_pytree(path, "model_state")
    if mstate is None:
        _, mstate = to_jax(model)
    loaded = from_jax(params, mstate, cfg, "cpu")
    for dst, src in zip(model.state_dict().values(), loaded.state_dict().values()):
        dst.copy_(src)


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def run_training(*, task: trainer_lib.TaskConfig, model_cfg,
                 train_dataset, val_dataset, tx, logger: MetricsLogger | None, batch_size: int,
                 chunk_size: int, max_speakers: int, input_dim: int, max_epochs: int,
                 seed: int = 777, early_stop_patience: int | None = None,
                 val_interval: int = 1, init_ckpt: str | None = None,
                 resume_from: str | None = None, on_the_fly: bool = False, mesh=None,
                 log_every: int = 100, limit_train_batches: int | None = None,
                 limit_val_batches: int | None = None, device=None):
    """Returns (final TrainState, checkpoint dir).  The model is the family
    `task.model` names, `init_ls_eend`, `init_fs_eend` or `init_eend_eda`
    of `model_cfg`, on `device`, the card unless the caller names another.
    With `on_the_fly` the training items are fetched as dataset[(index,
    item seed)] (an `OnTheFlyDiarizationDataset` draws its random crop
    from the seed).  `limit_train_batches` / `limit_val_batches` end an
    epoch's training / validation after that many batches (the configs'
    `debug:` section).  With `mesh` the run is data parallel (module
    docstring): `batch_size` is the global batch, the device is the mesh's,
    and ranks other than 0 take `logger=None` and return None for the
    checkpoint dir; with a model axis the returned state holds this rank's
    shards (`whole_state` gathers them)."""
    if mesh is not None:
        trainer_lib.check_mesh(mesh)
        if batch_size % mesh.n_data:
            raise ValueError(f"global batch {batch_size} must divide over the "
                             f"{mesh.n_data} data-parallel ranks")
        device = mesh.device
    if (logger is None) != (mesh is not None and not mesh.main):
        raise ValueError("rank 0 (or a run without a mesh) logs; the other ranks take "
                         "logger=None")
    device = ls_eend.resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = _INIT[task.model](model_cfg, gen, device=device)
    if init_ckpt:
        load_weights(model, init_ckpt)
    start_epoch = 0
    if resume_from:
        load_weights(model, resume_from)
    if mesh is not None:
        pmesh.shard_model_(model, mesh)
    state = trainer_lib.TrainState.create(model, tx)
    if resume_from:
        # weights (above), BatchNorm statistics, Adam moments and the step
        # (the Noam schedule's position); a file without the port's
        # opt_state resumes with fresh moments
        extra = ckpt_lib.load_extra(resume_from)
        if "opt_state/count" in ckpt_lib.load_flat(resume_from):
            state.opt_state = ckpt_lib.load_opt_state(resume_from, model, state.opt_state)
        state.step = int(extra.get("step", 0))
        start_epoch = int(extra.get("epoch", -1)) + 1

    # On SIGTERM the in-flight step finishes, ckpt_preempt.npz is saved and
    # the loop returns; its `epoch` is the last completed one, so a resume
    # replays the interrupted epoch from its start.
    preempt = {"flag": False}

    def _on_term(signum, frame):
        preempt["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:          # not the main thread
        prev_handler = None
    try:
        return _run_training_body(
            task=task, model_cfg=model_cfg, state=state, tx=tx, logger=logger,
            train_dataset=train_dataset, val_dataset=val_dataset, batch_size=batch_size,
            chunk_size=chunk_size, max_speakers=max_speakers, input_dim=input_dim,
            max_epochs=max_epochs, seed=seed, start_epoch=start_epoch,
            early_stop_patience=early_stop_patience, val_interval=val_interval,
            on_the_fly=on_the_fly, log_every=log_every,
            limit_train_batches=limit_train_batches, limit_val_batches=limit_val_batches,
            preempt=preempt, device=device, mesh=mesh)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


def _run_training_body(*, task, model_cfg, state, tx, logger, train_dataset, val_dataset,
                       batch_size, chunk_size, max_speakers, input_dim, max_epochs, seed,
                       start_epoch, early_stop_patience, val_interval, on_the_fly, log_every,
                       limit_train_batches, limit_val_batches, preempt, device, mesh):
    train_step = trainer_lib.make_train_step(task, model_cfg, tx, mesh=mesh, device=device)
    eval_step = trainer_lib.make_eval_step(task, model_cfg)
    n_ranks, rank = (1, 0) if mesh is None else (mesh.n_data, mesh.rank)
    main = mesh is None or mesh.main

    def save(path, whole, epoch, val_der=None):
        save_train_state(path, whole, {"epoch": epoch, "step": whole.step,
                                       "val_der": val_der if val_der is not None else np.nan})

    def any_rank(flag: bool) -> bool:
        if mesh is None:
            return flag
        return bool(C.sum_scalars({"f": torch.tensor(float(flag), device=device)},
                                  mesh.world)["f"] > 0)

    # drop_last: the ranks' shares hold the one-process run's items, step by step
    sampler = ShardedSampler(len(train_dataset), n_ranks, rank, shuffle=True, seed=seed,
                             drop_last=True)
    local_batch = batch_size // n_ranks
    best = (np.inf, -1)
    for epoch in range(start_epoch, max_epochs):
        sampler.set_epoch(epoch)
        idx_iter = (i if on_the_fly else i[0] for i in sampler.indices())

        def make_iter():
            return batched(train_dataset, idx_iter, local_batch, chunk_size, max_speakers,
                           input_dim)

        t0 = time.time()
        n_steps = 0
        metrics = {}
        for batch in Prefetcher(make_iter):
            batch.pop("recs")
            state, metrics = train_step(state, _to_device(batch, device), seed)
            n_steps += 1
            if any_rank(preempt["flag"]):
                whole = whole_state(state, mesh)
                if main:
                    save(logger.dir / "ckpt_preempt.npz", whole, epoch - 1)
                    print(f"SIGTERM: saved {logger.dir}/ckpt_preempt.npz at step {state.step} "
                          f"(epoch {epoch} will replay on resume)", flush=True)
                return state, logger.dir if main else None
            if main and n_steps % log_every == 0:
                logger.log(state.step, {k: metrics[k] for k in
                                        ("pit_loss", "emb_loss", "tot_loss", "grad_norm")},
                           prefix="train/")
            if limit_train_batches and n_steps >= limit_train_batches:
                break
        dt = time.time() - t0

        val_der = None
        whole = whole_state(state, mesh)
        validate = val_dataset is not None and (epoch + 1) % val_interval == 0
        if validate and main:
            vms = []
            for batch in batched(val_dataset, range(len(val_dataset)), batch_size, chunk_size,
                                 max_speakers, input_dim, drop_last=False):
                batch.pop("recs")
                vms.append({k: float(v) for k, v in
                            eval_step(whole, _to_device(batch, device)).items()})
                if limit_val_batches and len(vms) >= limit_val_batches:
                    break
            agg = trainer_lib.aggregate_metrics(vms)
            val_der = agg.get("DER", np.inf)
            logger.log(state.step, agg, prefix="val/")
        if validate and mesh is not None:
            # rank 0's DER decides the early stop on every rank
            v = torch.tensor(np.nan if val_der is None else val_der, dtype=torch.float64,
                             device=device)
            torch.distributed.broadcast(v, 0, group=mesh.world)
            val_der = float(v)

        if main:
            loss = float(metrics["tot_loss"]) if metrics else float("nan")
            print(f"epoch {epoch}: {n_steps} steps in {dt:.1f}s loss={loss:.4f}"
                  + (f" val/DER={val_der:.4f}" if val_der is not None else ""), flush=True)
            save(logger.dir / f"ckpt_epoch={epoch}.npz", whole, epoch, val_der)
        if val_der is not None and val_der < best[0]:
            best = (val_der, epoch)
        if (early_stop_patience is not None and val_der is not None
                and epoch - best[1] >= early_stop_patience):
            if main:
                print(f"early stop at epoch {epoch} (best {best[0]:.4f} @ {best[1]})")
            break
    return state, logger.dir if main else None


def average_epoch_range(ckpt_dir, start_epoch: int | None = None,
                        end_epoch: int | None = None):
    """The uniform average of the "params" of the epoch checkpoints in
    [start_epoch, end_epoch] -> (params, model_state, paths), numpy trees in
    the JAX layout; model_state (the BatchNorm statistics) comes from the
    last checkpoint, None when it has none (EEND-EDA)."""
    paths = ckpt_lib.find_epoch_checkpoints(ckpt_dir, start_epoch, end_epoch)
    if not paths:
        raise FileNotFoundError(f"no epoch checkpoints in {ckpt_dir}")
    avg = ckpt_lib.average_checkpoints(paths, "params")
    mstate = None
    if ckpt_lib.has_subtree(paths[-1], "model_state"):
        mstate = ckpt_lib.load_pytree(paths[-1], "model_state")
    return avg, mstate, paths
