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
"""

from __future__ import annotations

import dataclasses

import torch

from fseend_tpu_torch.models import eend_eda, fs_eend, ls_eend
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
    compute_dtype: str = "f32"

    def __post_init__(self):
        if self.model not in ("ls", "fs", "eda"):
            raise ValueError(f"unknown model family {self.model!r}")
        if self.compute_dtype != "f32":
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: the port runs float32 only; bf16 is "
                "ROADMAP B9")
        if self.model != "eda" and self.label_mode not in ("fixed", "spk_pit",
                                                           "spk_pit_hungarian"):
            raise ValueError(f"unknown label_mode {self.label_mode!r}")


def _forward(task: TaskConfig, model, feats, lens, n_slots: int, train: bool, generator):
    forward = fs_eend.fs_forward if task.model == "fs" else ls_eend.ls_forward
    return forward(model, feats, lens, n_slots, train=train, generator=generator)


def compute_loss(task: TaskConfig, model, batch: dict,
                 generator: torch.Generator | None = None, *, train: bool):
    """Returns (loss, (new BatchNorm state, metrics)) for the model of
    `task.model`'s family.  In training the loss carries the graph back to
    the module's parameters; dropout draws from `generator`."""
    if task.model == "eda":
        return _compute_loss_eda(task, model, batch, generator, train=train)
    feats, labels, lens, n_spk = batch["feats"], batch["labels"], batch["lens"], batch["n_spk"]
    S = labels.shape[2]
    slot_labels, slot_mask = labels_lib.prepare_labels(labels, lens, n_spk)
    out = _forward(task, model, feats, lens, S + 2, train, generator)
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


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step: `seed` and the step count decide
    it (the JAX step folds the step into its key)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


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


def make_train_step(task: TaskConfig, cfg, tx: Optimizer, mesh=None, device=None):
    """step(state, batch, seed) -> (state, metrics): one optimizer step on
    the model held by `state` (on `device`: the card unless the caller names
    another), with `cfg` (the family's config) deciding the model's routes
    and dropout.  The state is updated in place and returned."""
    _check_family(task, cfg)
    if mesh is not None:
        raise NotImplementedError("multi-GPU training is not ported yet (ROADMAP A11)")
    device = ls_eend.resolve_device(device)

    def step(state: TrainState, batch: dict, seed: int):
        model = state.model
        params = list(model.parameters())
        if params[0].device.type != device.type:
            raise ValueError(f"train step made for {device}, model on {params[0].device}")
        for p in params:
            p.grad = None
        gen = step_generator(seed, state.step, params[0].device)
        loss, (bn_state, metrics) = compute_loss(task, ls_eend.with_cfg(model, cfg), batch, gen,
                                                 train=True)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        metrics["grad_norm"] = global_norm(grads)
        tx.step(params, grads, state.opt_state)
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
