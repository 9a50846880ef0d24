"""Multi-scale retention in its three modes: parallel, chunkwise (with the
state carried across chunks and calls) and recurrent (per-frame, O(1) state).

Port of `fseend_tpu/ops/retention.py`.  The reference quirks stay: per-head
decay gamma is 1 unless `use_decay`; k is pre-scaled by key_dim**-0.5; the
data-dependent renormalizers (parallel row sum, chunkwise inner scale, the
max-abs-sum kv scale) are clamped to >= 1; the output group norm is a
non-affine layer norm over head_dim with eps 1e-6; silu(g) gating; out
projection.  The xpos rotation, which the reference computes and never
applies, is not ported (`use_xpos=True` raises).  Inference only: nothing
here detaches the renormalizers for a backward pass.

Two state conventions, not interchangeable:
  * recurrent: ``kv`` (B, H, dv, dk) with ``out[v] = sum_k q[k] kv[v, k]``,
    kept normalized, and a running ``scale`` (B, H).  Zeros are a fresh
    state: the first step then reduces to the reference's
    uninitialized-state branch.
  * chunkwise (`chunk_state_init`): ``kv`` (B, H, dk, dv), carried
    unnormalized, and its ``scale`` (B, H, 1, 1), ones when fresh.

`retention_chunkwise_stateful` picks its route from `RetentionConfig.kernel`:
the whole layer in `kernels/retention_layer.py`, the core alone in
`kernels/chunk_retention.py`, or plain tensor ops.  On the card the first two
are CUDA kernels; on CPU tensors they run their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.ops import nn as tnn

ROUTES = ("fused", "core", "plain")


@dataclasses.dataclass(frozen=True)
class RetentionConfig:
    """`kernel` picks the route of the chunkwise mode: "fused" is the whole
    layer in one kernel call (the JAX package's `use_fused_ret`), "core" the
    chunkwise core as a kernel between plain projections (JAX `use_pallas`),
    "plain" tensor ops only (both JAX flags off)."""
    embed_dim: int
    num_heads: int
    value_factor: int = 1
    chunk_size: int = 500
    use_xpos: bool = False
    use_decay: bool = False  # reference uses gamma = 1 (no decay)
    kernel: str = "fused"

    def __post_init__(self):
        if self.use_xpos:
            raise NotImplementedError(
                "xpos rotation is not ported: the reference disables it")
        if self.kernel not in ROUTES:
            raise ValueError(f"kernel must be one of {ROUTES}, got {self.kernel!r}")

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


def _project_qkv(p: Retention, x: torch.Tensor, cfg: RetentionConfig):
    """x: (B, T, D) -> q, k: (B, H, T, dk), v: (B, H, T, dv), g: (B, T, D*F)."""
    B, T, _ = x.shape
    H, dk, dv = cfg.num_heads, cfg.key_dim, cfg.head_dim
    q = tnn.linear(x, p.q_proj.weight, p.q_proj.bias)
    k = tnn.linear(x, p.k_proj.weight, p.k_proj.bias) * dk ** -0.5
    v = tnn.linear(x, p.v_proj.weight, p.v_proj.bias)
    g = tnn.linear(x, p.g_proj.weight, p.g_proj.bias)
    q = q.reshape(B, T, H, dk).transpose(1, 2)
    k = k.reshape(B, T, H, dk).transpose(1, 2)
    v = v.reshape(B, T, H, dv).transpose(1, 2)
    return q, k, v, g


def _finish(p: Retention, out_heads: torch.Tensor, g: torch.Tensor):
    """out_heads: (B, H, T, dv) -> group norm -> gate -> out proj (B, T, D)."""
    B, H, T, dv = out_heads.shape
    out = tnn.layer_norm(out_heads.transpose(1, 2), eps=1e-6)   # non-affine, over dv
    out = F.silu(g) * out.reshape(B, T, H * dv)
    return tnn.linear(out, p.out_proj.weight, p.out_proj.bias)


def _decay_mask(T: int, gammas: torch.Tensor):
    """(H, T, T) normalized decay mask + (H, T, 1) sqrt-rowsum scale."""
    i = torch.arange(T, dtype=torch.float32, device=gammas.device)
    delta = i[:, None] - i[None, :]
    tri = delta >= 0
    mask = torch.where(tri, gammas[:, None, None] ** delta.clamp(min=0), 0.0)
    scale = torch.sqrt(mask.sum(-1, keepdim=True))
    return mask / scale, scale


# ---------------------------------------------------------------------------
# mode 1: parallel
# ---------------------------------------------------------------------------


def retention_parallel(p: Retention, x: torch.Tensor, cfg: RetentionConfig) -> torch.Tensor:
    """(B, T, D) -> (B, T, D), the (T x T) decay-masked form."""
    q, k, v, g = _project_qkv(p, x, cfg)
    mask, _ = _decay_mask(x.shape[1], decay_gammas(cfg, x.device))
    qk = (q @ k.transpose(-1, -2)) * mask
    qk = qk / qk.sum(-1, keepdim=True).abs().clamp(min=1.0)
    return _finish(p, qk @ v, g)


# ---------------------------------------------------------------------------
# mode 2: chunkwise, the state carried across chunks and calls
# ---------------------------------------------------------------------------


def chunk_state_init(cfg: RetentionConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """Cross-chunk carry: kv (B, H, dk, dv) zeros and its scale (B, H, 1, 1)
    ones; this start reproduces the from-scratch chunkwise pass exactly."""
    return {
        "kv": torch.zeros(batch, cfg.num_heads, cfg.key_dim, cfg.head_dim,
                          dtype=dtype, device=device),
        "scale": torch.ones(batch, cfg.num_heads, 1, 1, dtype=dtype, device=device),
    }


def retention_chunkwise(p: Retention, x: torch.Tensor, cfg: RetentionConfig) -> torch.Tensor:
    """(B, T, D) -> (B, T, D) with T % chunk_size == 0 (the model pads)."""
    return retention_chunkwise_stateful(p, x, None, cfg)[0]


def retention_chunkwise_stateful(p: Retention, x: torch.Tensor, state: dict | None,
                                 cfg: RetentionConfig,
                                 packed: RL.RetLayerWeights | None = None):
    """Chunkwise retention continuing from a cross-chunk `state` (None =
    fresh).  Returns (out (B, T, D), new_state); `state` is left as it was.
    The engine of blockwise serving: every arriving block is one or more
    chunks.  `packed` is `RL.pack_retention(p)` for the "fused" route (made
    here when None; a server packs once)."""
    B, T, _ = x.shape
    L = cfg.chunk_size
    if T % L:
        raise ValueError(f"T={T} must be a multiple of chunk_size={L}")
    N = T // L
    H, dk, dv = cfg.num_heads, cfg.key_dim, cfg.head_dim
    if state is None:
        state = chunk_state_init(cfg, B, x.dtype, x.device)
    gammas = decay_gammas(cfg, x.device)

    if cfg.kernel == "fused":
        y, kv_f, s_f = RL.retention_layer(
            gammas, x, RL.pack_retention(p) if packed is None else packed,
            state["kv"], state["scale"], L)
        return y, {"kv": kv_f, "scale": s_f}

    q, k, v, g = _project_qkv(p, x, cfg)             # (B, H, T, d*)
    if cfg.kernel == "core":
        out, kv_f, s_f = CR.chunk_retention(
            gammas.repeat(B),                         # row bh = b*H + h
            q.reshape(B * H, T, dk), k.reshape(B * H, T, dk), v.reshape(B * H, T, dv),
            state["kv"].reshape(B * H, dk, dv), state["scale"].reshape(B * H, 1, 1), L)
        return _finish(p, out.reshape(B, H, T, dv), g), {
            "kv": kv_f.reshape(B, H, dk, dv), "scale": s_f.reshape(B, H, 1, 1)}

    mask, scale = _decay_mask(L, gammas)              # (H, L, L), (H, L, 1)
    cross_decay = gammas[:, None, None] ** L          # (H, 1, 1)
    i = torch.arange(L, dtype=torch.float32, device=x.device)
    inner_decay = (gammas[:, None] ** (i + 1))[:, :, None] / (scale / scale[:, -1:])

    qc = q.reshape(B, H, N, L, dk)
    kc = k.reshape(B, H, N, L, dk)
    vc = v.reshape(B, H, N, L, dv)
    # intra-chunk attention, batched over chunks
    qk = (qc @ kc.transpose(-1, -2)) * mask[:, None]
    inner_scale = qk.abs().sum(-1, keepdim=True).clamp(min=1.0)
    inner_out = (qk / inner_scale) @ vc
    # per-chunk kv summaries k^T (v * last mask row), then the small scan
    kv_chunks = kc.transpose(-1, -2) @ (vc * mask[:, None, -1, :, None])
    kv_state, kv_scale = state["kv"], state["scale"]
    kv_rec, cross_scale = [], []
    for n in range(N):
        kv_rec.append(kv_state / kv_scale)
        cross_scale.append(kv_scale)
        kv_state = kv_state * cross_decay + kv_chunks[:, :, n]
        kv_scale = kv_state.abs().sum(-2, keepdim=True).amax(-1, keepdim=True).clamp(min=1.0)
    kv_rec = torch.stack(kv_rec, dim=2)               # (B, H, N, dk, dv)
    cross_scale = torch.stack(cross_scale, dim=2)     # (B, H, N, 1, 1)

    cross_out = (qc * inner_decay[:, None]) @ kv_rec
    all_scale = torch.maximum(inner_scale, cross_scale)
    out = inner_out * (inner_scale / all_scale) + cross_out * (cross_scale / all_scale)
    return _finish(p, out.reshape(B, H, T, dv), g), {"kv": kv_state, "scale": kv_scale}


# ---------------------------------------------------------------------------
# mode 3: recurrent (streaming, O(1) state)
# ---------------------------------------------------------------------------


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
