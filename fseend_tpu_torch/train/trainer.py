"""The LS-EEND, FS-EEND and EEND-EDA train and eval steps.

Port of `fseend_tpu/train/trainer.py`.  One train step is label protocol
-> train-mode forward -> (PIT or fixed-order) BCE + embedding-consistency
loss (EEND-EDA: PIT over every speaker column + the attractor-existence
loss) -> gradients -> optimizer update.  PyTorch runs eagerly, so a step
is a plain function over a `TrainState` that it updates in place.

Batches are fixed-shape dicts of tensors on the model's device:
  feats  (B, T, F)   features
  labels (B, T, S)   0/1 speaker activity (S = max_speakers)
  lens   (B,)        valid frame counts
  n_spk  (B,)        true speaker counts

Mixed precision (`TaskConfig(compute_dtype="bf16")`, the JAX package's
`trainer.py:78-96`): the forward and backward run on bf16 copies of the
float32 parameters and of the features, cast inside the autograd graph, so
the gradients arrive in float32 through the cast; the parameters, the
BatchNorm running statistics, the Adam moments and the clip stay float32.

Data parallelism (`make_train_step(mesh=...)`, ROADMAP A11): one rank per
card, each with its rows of the global batch.  The ranks compute the JAX
package's one program over the global batch, not a mean of per-rank
means: every loss divides by a count over the whole batch and train
BatchNorm takes global statistics (`parallel/collectives.py:
data_parallel`), the gradients are summed over the ranks, the clip sees the
global norm, and Adam runs alike on every rank, so the parameters stay
equal.  The DER counters and the losses are summed over the ranks.  At
dropout > 0 each rank draws its own stream (the seed, the step and the
rank), as the JAX package's sequence parallelism folds the shard index into
its key; equality with one process holds at dropout 0.

Tensor parallelism (a mesh with n_model > 1, the model sharded by
`parallel/mesh.py:shard_model_`): the ranks of one model group take the
same rows and the same dropout generator (the data coordinate's), and run
the step inside `collectives.model_parallel`, where the split products
exchange their partial sums and the gathered weights their slices.  The
gradients of whole and of split parameters alike are summed over the data
group only (the model axis has split them already), BatchNorm statistics
and loss denominators too, and the clip's norm counts a split parameter
once (`optim.global_norm` over the model group).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from fseend_tpu_torch.models import eend_eda, fs_eend, ls_eend
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.parallel import collectives as C
from fseend_tpu_torch.parallel.mesh import Mesh
from fseend_tpu_torch.train import labels as labels_lib
from fseend_tpu_torch.train import losses
from fseend_tpu_torch.train.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    """The module (its parameters and, as buffers, the BatchNorm running
    statistics: the JAX `model_state`), the optimizer state and the number
    of steps taken."""
    model: ls_eend.LSEEND | fs_eend.FSEEND | eend_eda.EENDEDA
    opt_state: dict
    step: int = 0

    @classmethod
    def create(cls, model, tx: Optimizer) -> "TrainState":
        return cls(model, tx.init(list(model.parameters())), 0)


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """The model family ("ls", "fs" or "eda"; the JAX package defaults to
    "fs", the port to "ls") and the label and loss protocol.  label_mode:
    "fixed" (first-appearance order, standard BCE), "spk_pit" (rolled PIT
    over the speaker columns, silence and none pinned) or
    "spk_pit_hungarian" (Hungarian assignment over the speakers).  EEND-EDA
    has one protocol and does not read label_mode (the JAX package's CLI
    passes "pit")."""
    model: str = "ls"
    label_mode: str = "fixed"
    label_delay: int = 0
    consis_weight: float = 1.0
    masked_emb_loss: bool = False      # the LS sum-len^2 normalization
    use_mask_loss: bool = False        # standard_mask_loss instead of BCE
    compute_dtype: str = "f32"         # "f32" | "bf16" (mixed precision, module docstring)

    def __post_init__(self):
        if self.model not in ("ls", "fs", "eda"):
            raise ValueError(f"unknown model family {self.model!r}")
        if self.compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype must be 'f32' or 'bf16', got {self.compute_dtype!r}")
        if self.model != "eda" and self.label_mode not in ("fixed", "spk_pit",
                                                           "spk_pit_hungarian"):
            raise ValueError(f"unknown label_mode {self.label_mode!r}")


def _forward(task: TaskConfig, model, feats, lens, n_slots: int, train: bool, generator):
    forward = fs_eend.fs_forward if task.model == "fs" else ls_eend.ls_forward
    return forward(model, feats, lens, n_slots, train=train, generator=generator)


def compute_loss(task: TaskConfig, model, batch: dict,
                 generator: torch.Generator | None = None, *, train: bool, forward_fn=None):
    """Returns (loss, (new BatchNorm state, metrics)) for the model of
    `task.model`'s family.  In training the loss carries the graph back to
    the module's parameters; dropout draws from `generator`.  With
    compute_dtype "bf16" the pass runs on bf16 casts of the parameters and
    the features made inside the graph (the JAX `_cast_bf16`); the
    BatchNorm buffers are not cast.  `forward_fn(model, feats, lens,
    n_slots, train, generator)` replaces the family's batch pass (LS and FS;
    the sequence-parallel steps of `parallel/sp.py`)."""
    if task.compute_dtype == "bf16":
        batch = dict(batch, feats=batch["feats"].to(torch.bfloat16))
        cast = {name: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                for name, p in model.named_parameters()}
        return tnn.call_with(cast, model, _compute_loss, task, batch, generator, train=train,
                             forward_fn=forward_fn)
    return _compute_loss(model, task, batch, generator, train=train, forward_fn=forward_fn)


def _compute_loss(model, task: TaskConfig, batch: dict, generator, *, train: bool,
                  forward_fn=None):
    if task.model == "eda":
        return _compute_loss_eda(task, model, batch, generator, train=train)
    feats, labels, lens, n_spk = batch["feats"], batch["labels"], batch["lens"], batch["n_spk"]
    S = labels.shape[2]
    slot_labels, slot_mask = labels_lib.prepare_labels(labels, lens, n_spk)
    forward_fn = forward_fn or functools.partial(_forward, task)
    out = forward_fn(model, feats, lens, S + 2, train, generator)
    logits = out["logits"].float()

    if task.label_mode == "fixed":
        tgt = slot_labels
    else:
        sil, spk, none = labels_lib.pin_silence_none(slot_labels)
        if task.label_mode == "spk_pit":
            _, spk_perm, _ = losses.batch_pit_loss(logits[..., 1:-1].detach(), spk, lens, n_spk,
                                                   label_delay=task.label_delay)
        else:
            spk_perm, _ = losses.hungarian_pit_permute(logits[..., 1:-1], spk, lens, n_spk)
        tgt = torch.cat([sil, spk_perm, none], dim=-1)

    loss_fn = losses.standard_mask_loss if task.use_mask_loss else losses.standard_bce_loss
    pit_loss = loss_fn(logits, tgt, lens, slot_mask, label_delay=task.label_delay)
    emb = out["emb"].float()
    if task.masked_emb_loss:
        emb_loss = losses.emb_consistency_loss_ls(emb, tgt, lens)
    else:
        emb_loss = losses.emb_consistency_loss(emb, tgt)
    total = pit_loss + task.consis_weight * emb_loss
    # DER proxy over each sample's real speaker slots (columns 1..n_spk)
    real_mask = torch.arange(1, S + 1, device=lens.device)[None, :] <= n_spk[:, None]
    counters = losses.diarization_error_counters(logits[..., 1:-1].detach(), tgt[..., 1:-1],
                                                 lens, real_mask, label_delay=task.label_delay)
    metrics = {"pit_loss": pit_loss.detach(), "emb_loss": emb_loss.detach(),
               "tot_loss": total.detach(), **counters}
    return total, (out["state"], metrics)


def _compute_loss_eda(task: TaskConfig, model, batch: dict, generator, *, train: bool):
    """The EEND-EDA protocol (the reference's offl_tfm_lstm.py:49-123): PIT
    over all S speaker columns and the attractor-existence BCE, no silence
    or none slots; no BatchNorm state ({})."""
    labels, lens, n_spk = batch["labels"], batch["lens"], batch["n_spk"]
    S = labels.shape[2]
    out = eend_eda.eda_forward(model, batch["feats"], S, train=train, generator=generator)
    logits = out["logits"]
    pit_loss, labels_perm, _ = losses.batch_pit_loss(logits, labels, lens, n_spk,
                                                     label_delay=task.label_delay)
    attr_loss = losses.attractor_existence_loss(out["exist_logits"], n_spk)
    total = pit_loss + model.cfg.attractor_loss_ratio * attr_loss
    slot_mask = torch.arange(S, device=lens.device)[None, :] < n_spk[:, None]
    counters = losses.diarization_error_counters(logits.detach(), labels_perm, lens, slot_mask,
                                                 label_delay=task.label_delay)
    metrics = {"pit_loss": pit_loss.detach(), "emb_loss": attr_loss.detach(),
               "tot_loss": total.detach(), **counters}
    return total, ({}, metrics)


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The dropout generator of one step: `seed` and the step count decide
    it (the JAX step folds the step into its key), and on a data-parallel
    rank other than 0 the rank too (its data coordinate: the ranks of one
    model group draw the same masks)."""
    return torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + int(step) + (int(rank) << 40))


@torch.no_grad()
def _set_bn(model, bn_state: dict) -> None:
    """The new BatchNorm running statistics into the module's buffers: the
    conformer blocks' (LS, `bn_state["conv_bn"]`) or the input one's (FS,
    `bn_state["bn"]`); EEND-EDA has none (`bn_state` is {})."""
    if not bn_state:
        return
    if "bn" in bn_state:
        pairs = [(model.enc.bn, bn_state["bn"])]
    else:
        pairs = [(blk.conv.bn, st) for blk, st in zip(model.enc.blocks, bn_state["conv_bn"])]
    for bn, st in pairs:
        bn.running_mean.copy_(st["mean"])
        bn.running_var.copy_(st["var"])


_CONFIGS = {"ls": ls_eend.LSEENDConfig, "fs": fs_eend.FSEENDConfig, "eda": eend_eda.EDAConfig}


def _check_family(task: TaskConfig, cfg) -> None:
    want = _CONFIGS[task.model]
    if not isinstance(cfg, want):
        raise TypeError(f"TaskConfig(model={task.model!r}) needs a {want.__name__}, "
                        f"got {type(cfg).__name__}")


def check_mesh(mesh) -> None:
    """A mesh of processes (`parallel/mesh.py:make_mesh()`), or raise."""
    if not isinstance(mesh, Mesh) or mesh.group is None:
        raise TypeError(f"a data-parallel step needs a mesh of processes "
                        f"(parallel/mesh.py:make_mesh()), got {mesh!r}")


def make_train_step(task: TaskConfig, cfg, tx: Optimizer, mesh=None, device=None):
    """step(state, batch, seed) -> (state, metrics): one optimizer step on
    the model held by `state` (on `device`: the card unless the caller names
    another), with `cfg` (the family's config) deciding the model's routes
    and dropout.  The state is updated in place and returned.  With `mesh`
    (`parallel/mesh.py:make_mesh()`) the batch is this rank's rows of the
    global batch and the step is the global batch's (module docstring);
    with a model axis the model is this rank's shards
    (`parallel/mesh.py:shard_model_`)."""
    _check_family(task, cfg)
    if mesh is not None:
        check_mesh(mesh)
    # one data rank (a 1 x n grid) runs the one-process BatchNorm and losses
    group = None if mesh is None or mesh.n_data == 1 else mesh.group
    model_group = None if mesh is None else mesh.model_group

    def forward_backward(model, batch, gen):
        with C.data_parallel(group), C.model_parallel(model_group):
            loss, (bn_state, metrics) = compute_loss(task, ls_eend.with_cfg(model, cfg), batch,
                                                     gen, train=True)
            loss.backward()
        if group is not None:
            metrics = C.sum_scalars(metrics, group)
        return bn_state, metrics

    return optimizer_step(forward_backward, tx, device, mesh)


def optimizer_step(forward_backward, tx: Optimizer, device, mesh=None, axis: str = "data"):
    """step(state, batch, seed) -> (state, metrics) around
    `forward_backward(model, batch, generator) -> (BatchNorm state,
    metrics)`, which leaves this rank's gradients in the parameters; with a
    mesh they are summed over the ranks of its `axis` ("data"; "model" for
    sequence parallelism over the model axis) before the clip and the
    update, and the dropout generator is that axis' coordinate's."""
    device = ls_eend.resolve_device(device)
    rank = 0 if mesh is None else (mesh.rank if axis == "data" else mesh.m)
    group = None if mesh is None else (mesh.group if axis == "data" else mesh.model_group)

    def step(state: TrainState, batch: dict, seed: int):
        model = state.model
        params = list(model.parameters())
        if params[0].device.type != device.type:
            raise ValueError(f"train step made for {device}, model on {params[0].device}")
        for p in params:
            p.grad = None
        gen = step_generator(seed, state.step, params[0].device, rank)
        bn_state, metrics = forward_backward(model, batch, gen)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if mesh is not None:
            C.all_reduce_(grads, group)
        shards = list(C.param_shards(model).values())
        norm = functools.partial(global_norm, shards=shards,
                                 group=None if mesh is None else mesh.model_group)
        metrics["grad_norm"] = norm(grads)
        tx.step(params, grads, state.opt_state, norm=norm)
        _set_bn(model, bn_state)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(task: TaskConfig, cfg):
    """step(state, batch) -> metrics, without dropout or gradients."""
    _check_family(task, cfg)

    def step(state: TrainState, batch: dict) -> dict:
        _, (_, metrics) = compute_loss(task, ls_eend.with_cfg(state.model, cfg), batch,
                                       train=False)
        return metrics

    return step


_COUNTERS = {"speech_scored", "speech_miss", "speech_falarm", "speaker_scored", "speaker_miss",
             "speaker_falarm", "speaker_error", "diarization_error", "frames", "correct"}


def aggregate_metrics(metric_list: list) -> dict:
    """Counters summed and losses averaged over steps; DER = error / scored."""
    if not metric_list:
        return {}
    agg = {}
    for k in metric_list[0]:
        vals = [float(m[k]) for m in metric_list]
        agg[k] = sum(vals) if k in _COUNTERS else sum(vals) / len(vals)
    if agg.get("speaker_scored", 0) > 0:
        agg["DER"] = agg["diarization_error"] / agg["speaker_scored"]
    return agg
