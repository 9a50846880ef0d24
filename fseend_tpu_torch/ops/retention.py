"""Multi-scale retention, recurrent (per-frame, O(1) state) mode.

Port of the recurrent part of `fseend_tpu/ops/retention.py`.  The reference
quirks stay: per-head decay gamma is 1 unless `use_decay`; k is pre-scaled
by key_dim**-0.5; the output group norm is a non-affine layer norm over
head_dim with eps 1e-6; silu(g) gating; out projection.  The carried state
keeps its own dtype.

State convention: ``kv`` (B, H, dv, dk) with ``out[v] = sum_k q[k] kv[v, k]``
and a running ``scale`` (B, H).  Zeros are a fresh state: the first step then
reduces to the reference's uninitialized-state branch.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fseend_tpu_torch.ops import nn as tnn


@dataclasses.dataclass(frozen=True)
class RetentionConfig:
    embed_dim: int
    num_heads: int
    value_factor: int = 1
    use_decay: bool = False  # reference uses gamma = 1 (no decay)

    @property
    def key_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def head_dim(self) -> int:
        return self.embed_dim * self.value_factor // self.num_heads


class Retention(nn.Module):
    """q/k/v/g projections + out projection (the JAX `init_retention` pytree)."""

    def __init__(self, cfg: RetentionConfig):
        super().__init__()
        D, Fv = cfg.embed_dim, cfg.embed_dim * cfg.value_factor
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, Fv)
        self.g_proj = nn.Linear(D, Fv)
        self.out_proj = nn.Linear(Fv, D)


def decay_gammas(cfg: RetentionConfig, device=None) -> torch.Tensor:
    """Per-head decay: 1 (the reference), or 1 - 2^(-5-h) with use_decay."""
    if cfg.use_decay:
        h = torch.arange(cfg.num_heads, dtype=torch.float32, device=device)
        return 1.0 - torch.exp2(-5.0 - h)
    return torch.ones(cfg.num_heads, dtype=torch.float32, device=device)


def retention_state_init(cfg: RetentionConfig, batch: int,
                         dtype=torch.float32, device=None) -> dict:
    return {
        "kv": torch.zeros(batch, cfg.num_heads, cfg.head_dim, cfg.key_dim,
                          dtype=dtype, device=device),
        "scale": torch.zeros(batch, cfg.num_heads, dtype=dtype, device=device),
    }


def retention_recurrent_step(p: Retention, x_t: torch.Tensor, state: dict,
                             cfg: RetentionConfig):
    """x_t: (B, D) one frame -> (out (B, D), new_state):
      scale' = scale*gamma + 1
      kv'    = kv * (sqrt(scale)*gamma/sqrt(scale')) + (v k)/sqrt(scale')
      out    = sum_k q_k * kv'[v, k]
    """
    B = x_t.shape[0]
    H, dk, dv = cfg.num_heads, cfg.key_dim, cfg.head_dim
    q = tnn.linear(x_t, p.q_proj.weight, p.q_proj.bias).reshape(B, H, dk)
    k = (tnn.linear(x_t, p.k_proj.weight, p.k_proj.bias) * dk ** -0.5).reshape(B, H, dk)
    v = tnn.linear(x_t, p.v_proj.weight, p.v_proj.bias).reshape(B, H, dv)
    g = tnn.linear(x_t, p.g_proj.weight, p.g_proj.bias)
    gammas = decay_gammas(cfg, x_t.device)[None]          # (1, H)

    prev_scale = state["scale"]
    scale = prev_scale * gammas + 1.0
    decay_mix = (torch.sqrt(prev_scale) * gammas / torch.sqrt(scale))[..., None, None]
    kv_t = v[..., :, None] * k[..., None, :]               # (B, H, dv, dk)
    kv = state["kv"] * decay_mix + kv_t / torch.sqrt(scale)[..., None, None]
    out = torch.einsum("bhk,bhvk->bhv", q, kv)

    out = tnn.layer_norm(out, eps=1e-6).reshape(B, H * dv).to(x_t.dtype)
    out = torch.nn.functional.silu(g) * out
    out = tnn.linear(out, p.out_proj.weight, p.out_proj.bias)
    return out, {"kv": kv.to(state["kv"].dtype),
                 "scale": scale.to(state["scale"].dtype)}


def retention_recurrent(p: Retention, x: torch.Tensor,
                        cfg: RetentionConfig) -> torch.Tensor:
    """Whole-sequence recurrent evaluation: (B, T, D) -> (B, T, D)."""
    state = retention_state_init(cfg, x.shape[0], x.dtype, x.device)
    ys = []
    for t in range(x.shape[1]):
        y, state = retention_recurrent_step(p, x[:, t], state, cfg)
        ys.append(y)
    return torch.stack(ys, dim=1)
