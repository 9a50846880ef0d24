"""Noam-Adam, Adam and SGD with global-norm clipping and gradient
accumulation, with optax's semantics (the JAX package's
`fseend_tpu/train/optim.py` builds them from optax).

An `Optimizer` updates a list of parameter tensors in place from their
gradients and keeps its state in a dict of tensors:
  * "count": updates applied so far (optax's count; the k-th update, k from
    0, takes the learning rate schedule(k));
  * "mu", "nu": Adam's moments, one tensor per parameter;
  * "acc", "mini_step": the gradient mean of the micro-steps so far when
    `grad_accum` > 1 (`optax.MultiSteps`: one update every k-th call, from
    the mean of the k gradients).
Clipping is optax's `clip_by_global_norm`: each gradient becomes
(g / norm) * max_norm when norm >= max_norm, else stays as it is.

Under tensor parallelism the parameters, gradients and moments are this
rank's shards (`parallel/mesh.py:shard_model_`): Adam and SGD are
elementwise, so they run on the shards as they are, and the global norm
sums a split parameter's squares over the model group once
(`global_norm(..., shards, group)`, passed to `step` as `norm`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fseend_tpu_torch.parallel import collectives as C


def noam_schedule(d_model: int, warmup_steps: int, scale: float = 1.0,
                  base_lr: float = 1.0):
    """lr(k) = base_lr * scale * d_model^-0.5 * min(s^-0.5, s * warmup^-1.5)
    with s = k + 1 for the k-th update."""

    def schedule(step: int) -> float:
        s = float(step + 1)
        return base_lr * scale * d_model ** -0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def global_norm(tensors, shards=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (optax's
    `global_norm`).  With `shards` (a `collectives.Shard` or None per
    tensor) and the model `group`, the split tensors are this rank's slices:
    their squares are summed over the group, each whole tensor counted
    once."""
    if shards is None or not any(shards):
        return torch.sqrt(sum(t.detach().square().sum() for t in tensors))
    whole = sum(t.detach().square().sum() for t, s in zip(tensors, shards) if s is None)
    split = sum(t.detach().square().sum() for t, s in zip(tensors, shards) if s is not None)
    return torch.sqrt(whole + C.psum(split, group))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """`kind` "adam" (Adam; the Noam schedule when `schedule` is set) or
    "sgd"; `lr` a float or a schedule of the update count."""
    kind: str = "adam"
    lr: object = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 0.0
    grad_accum: int = 1

    def init(self, params: list) -> dict:
        state = {"count": 0}
        if self.kind == "adam":
            state["mu"] = [torch.zeros_like(p) for p in params]
            state["nu"] = [torch.zeros_like(p) for p in params]
        if self.grad_accum > 1:
            state["acc"] = [torch.zeros_like(p) for p in params]
            state["mini_step"] = 0
        return state

    def _lr(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self, params: list, grads: list, state: dict, norm=global_norm) -> bool:
        """Apply one call's gradients; returns whether the parameters
        changed (False on the accumulating micro-steps).  `norm(grads)` is
        the clip's global norm (under tensor parallelism `global_norm` over
        the model group)."""
        if self.grad_accum > 1:
            n = state["mini_step"]
            for a, g in zip(state["acc"], grads):
                a.add_((g - a) / (n + 1))
            if n + 1 < self.grad_accum:
                state["mini_step"] = n + 1
                return False
            grads = [a.clone() for a in state["acc"]]
            for a in state["acc"]:
                a.zero_()
            state["mini_step"] = 0
        if self.grad_clip:
            total = norm(grads)
            if not bool(total < self.grad_clip):
                grads = [(g / total) * self.grad_clip for g in grads]
        count = state["count"]
        lr = self._lr(count)
        if self.kind == "sgd":
            for p, g in zip(params, grads):
                p.add_(g, alpha=-lr)
        else:
            c1 = 1.0 - self.b1 ** (count + 1)
            c2 = 1.0 - self.b2 ** (count + 1)
            for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
                mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                p.add_(-lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))
        state["count"] = count + 1
        return True


def build_optimizer(opt_name: str = "noam", lr: float = 1.0, *, d_model: int = 256,
                    warmup_steps: int = 100_000, schedule_scale: float = 1.0,
                    grad_clip: float = 5.0, grad_accum: int = 1) -> Optimizer:
    """The reference's optimizers:
      noam -> Adam(betas (0.9, 0.98), eps 1e-9) with the per-update Noam schedule
      adam -> Adam(lr)
      sgd  -> SGD(lr)
    with global-norm clipping and optional gradient accumulation."""
    name = opt_name.lower()
    if name == "noam":
        return Optimizer("adam", noam_schedule(d_model, warmup_steps, schedule_scale, lr),
                         0.9, 0.98, 1e-9, grad_clip, grad_accum)
    if name == "adam":
        return Optimizer("adam", lr, grad_clip=grad_clip, grad_accum=grad_accum)
    if name == "sgd":
        return Optimizer("sgd", lr, grad_clip=grad_clip, grad_accum=grad_accum)
    raise NotImplementedError(f"optimizer {opt_name}")
