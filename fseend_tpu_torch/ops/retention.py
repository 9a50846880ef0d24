"""Multi-scale retention in its three modes: parallel, chunkwise (with the
state carried across chunks and calls) and recurrent (per-frame, O(1) state).

Port of `fseend_tpu/ops/retention.py`.  The reference quirks stay: per-head
decay gamma is 1 unless `use_decay`; k is pre-scaled by key_dim**-0.5; the
data-dependent renormalizers (parallel row sum, chunkwise inner scale, the
max-abs-sum kv scale) are clamped to >= 1; the output group norm is a
non-affine layer norm over head_dim with eps 1e-6; silu(g) gating; out
projection.  The xpos rotation, which the reference computes and never
applies, runs with `use_xpos=True` where the JAX package applies it: on q
and k at positions 0..T-1 of the call, in the parallel and chunkwise forms
(the "core" route's kernel input too), not in the recurrent step (JAX
applies none there either); the "fused" route then runs the plain one, as
JAX's fused layer skips itself.  The renormalizers are
detached where the JAX package stops their gradient (the parallel row sum,
the chunkwise inner scale and the recomputed kv scale), so a backward pass
gives its gradients.

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
are CUDA kernels; on CPU tensors they run their plain versions.  Both kernel
routes train: their backward recomputes the pure route the JAX package
differentiates (for the whole layer `retention_layer_pure`, the plain route
on the packed weights; for the core `chunk_retention_plain(..., pure=True)`),
in float32 the kernel's plain version.

Tensor parallelism (the q/k/v/g projections column-parallel shards, the
out projection row parallel: `parallel/mesh.py:shard_model_`): on the
"plain" and "core" routes each model rank projects its own heads, runs the
core and the per-head group norm on them and adds its share of the out
projection (`ops/nn.py:row_linear`); this needs the heads to divide over
the model ranks, else the weights are gathered whole.  The "fused" route
takes the gathered weights (`kernels/retention_layer.py:pack_retention`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.parallel import collectives as C

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


def _xpos_angles(cfg: RetentionConfig, device=None) -> torch.Tensor:
    """(dk,) rotation rates, each repeated for its pair of key dims."""
    half = cfg.key_dim // 2
    angle = 1.0 / (10000 ** torch.linspace(0, 1, half, dtype=torch.float32, device=device))
    return angle.repeat_interleave(2)


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...) over the last axis."""
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


def _theta_shift(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    return x * cos + _rotate_every_two(x) * sin


def head_split(p: Retention, cfg: RetentionConfig) -> C.Shard | None:
    """The model rank's share of the heads when the projections are
    tensor-parallel shards and the heads divide over the ranks, else None
    (the weights are then gathered whole)."""
    shard = tnn.column_shard(p.q_proj)
    out = C.shards_of(p.out_proj).get("weight")
    if (shard is None or cfg.num_heads % shard.n or out is None
            or not all(tnn.column_shard(m) for m in (p.k_proj, p.v_proj, p.g_proj))):
        return None
    return shard


def local_gammas(p: Retention, cfg: RetentionConfig, device=None) -> torch.Tensor:
    """`decay_gammas` of the heads this rank computes (all without a split)."""
    gammas = decay_gammas(cfg, device)
    split = head_split(p, cfg)
    return gammas if split is None else split.take(gammas)


def _project_qkv(p: Retention, x: torch.Tensor, cfg: RetentionConfig):
    """x: (B, T, D) -> q, k: (B, H, T, dk), v: (B, H, T, dv), g: (B, T, H*dv),
    H this rank's heads under a tensor-parallel split (`head_split`); q and
    k rotated by xpos at positions 0..T-1 with `use_xpos`."""
    B, T, _ = x.shape
    dk, dv = cfg.key_dim, cfg.head_dim
    # k scaled in x's dtype by dk**-0.5 rounded to it, as JAX scales by a
    # weak-typed constant
    kscale = float(torch.tensor(dk ** -0.5).to(x.dtype)) if x.dtype == torch.bfloat16 \
        else dk ** -0.5
    lin = tnn.full_linear if head_split(p, cfg) is None else tnn.column_linear
    q = lin(p.q_proj, x)
    k = lin(p.k_proj, x) * kscale
    v = lin(p.v_proj, x)
    g = lin(p.g_proj, x)
    H = q.shape[-1] // dk
    q = q.reshape(B, T, H, dk).transpose(1, 2)
    k = k.reshape(B, T, H, dk).transpose(1, 2)
    v = v.reshape(B, T, H, dv).transpose(1, 2)
    if cfg.use_xpos:
        angle = _xpos_angles(cfg, x.device)
        idx = torch.arange(T, dtype=torch.float32, device=x.device)
        sin = torch.sin(idx[:, None] * angle[None, :])
        cos = torch.cos(idx[:, None] * angle[None, :])
        q = _theta_shift(q, sin, cos)
        k = _theta_shift(k, sin, cos)
    return q, k, v, g


def _gate(out_heads: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """out_heads: (B, H, T, dv) -> group norm -> silu(g) gate: (B, T, H*dv)."""
    B, H, T, dv = out_heads.shape
    out = tnn.layer_norm(out_heads.transpose(1, 2), eps=1e-6)   # non-affine, over dv
    return F.silu(g) * out.reshape(B, T, H * dv)


def _finish(p: Retention, out_heads: torch.Tensor, g: torch.Tensor, cfg: RetentionConfig):
    """out_heads: (B, H, T, dv) -> group norm -> gate -> out proj (B, T, D);
    row parallel over this rank's heads under a split."""
    out = _gate(out_heads, g)
    if head_split(p, cfg) is None:
        return tnn.full_linear(p.out_proj, out)
    return tnn.row_linear(p.out_proj, out)


def _finish_w(out_heads: torch.Tensor, g: torch.Tensor, weight, bias):
    """_finish with the out projection's weight (out, in) and bias given."""
    return tnn.linear(_gate(out_heads, g), weight, bias)


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
    mask, _ = _decay_mask(x.shape[1], local_gammas(p, cfg, x.device))
    qk = (q @ k.transpose(-1, -2)) * mask
    qk = qk / qk.detach().sum(-1, keepdim=True).abs().clamp(min=1.0)
    return _finish(p, qk @ v, g, cfg)


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
    here when None; a server packs once).  Under xpos the "fused" route
    runs the plain one (the JAX package's fused layer skips itself)."""
    B, T, _ = x.shape
    L = cfg.chunk_size
    if T % L:
        raise ValueError(f"T={T} must be a multiple of chunk_size={L}")
    dk, dv = cfg.key_dim, cfg.head_dim

    if cfg.kernel == "fused" and not cfg.use_xpos:
        if state is None:
            state = chunk_state_init(cfg, B, x.dtype, x.device)
        y, kv_f, s_f = RL.retention_layer(
            decay_gammas(cfg, x.device), x, RL.pack_retention(p) if packed is None else packed,
            state["kv"], state["scale"], L)
        return y, {"kv": kv_f, "scale": s_f}

    q, k, v, g = _project_qkv(p, x, cfg)             # (B, H, T, d*), H this rank's heads
    H = q.shape[1]
    gammas = local_gammas(p, cfg, x.device)
    if state is None:                                 # chunk_state_init over these heads
        state = {"kv": x.new_zeros(B, H, dk, dv), "scale": x.new_ones(B, H, 1, 1)}
    if cfg.kernel == "core":
        out, kv_f, s_f = CR.chunk_retention(
            gammas.repeat(B),                         # row bh = b*H + h
            q.reshape(B * H, T, dk), k.reshape(B * H, T, dk), v.reshape(B * H, T, dv),
            state["kv"].reshape(B * H, dk, dv), state["scale"].reshape(B * H, 1, 1), L)
        return _finish(p, out.reshape(B, H, T, dv), g, cfg), {
            "kv": kv_f.reshape(B, H, dk, dv), "scale": s_f.reshape(B, H, 1, 1)}

    out, kv_f, s_f = _plain_core(q, k, v, state, gammas, L)
    return _finish(p, out.to(x.dtype), g, cfg), {
        "kv": kv_f.to(state["kv"].dtype), "scale": s_f.to(state["scale"].dtype)}


def _plain_core(q, k, v, state: dict, gammas: torch.Tensor, L: int):
    """The plain route's chunkwise core over q, k (B, H, T, dk), v (B, H, T,
    dv) from `state`: (out, kv, scale), float32 on bf16 data."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    N = T // L
    mask, scale = _decay_mask(L, gammas)              # (H, L, L), (H, L, 1)
    cross_decay = gammas[:, None, None] ** L          # (H, 1, 1)
    i = torch.arange(L, dtype=torch.float32, device=q.device)
    inner_decay = (gammas[:, None] ** (i + 1))[:, :, None] / (scale / scale[:, -1:])

    # the core in float32 on bf16 q, k, v (the JAX package's
    # preferred_element_type=float32), its output back in x's dtype
    up = torch.float32 if q.dtype == torch.bfloat16 else q.dtype
    qc, kc, vc = (t.reshape(B, H, N, L, d).to(up) for t, d in ((q, dk), (k, dk), (v, dv)))
    # intra-chunk attention, batched over chunks
    qk = (qc @ kc.transpose(-1, -2)) * mask[:, None]
    inner_scale = qk.detach().abs().sum(-1, keepdim=True).clamp(min=1.0)
    inner_out = (qk / inner_scale) @ vc
    # per-chunk kv summaries k^T (v * last mask row), then the small scan
    kv_chunks = kc.transpose(-1, -2) @ (vc * mask[:, None, -1, :, None])
    kv_state, kv_scale = state["kv"].to(up), state["scale"].to(up)
    kv_rec, cross_scale = [], []
    for n in range(N):
        kv_rec.append(kv_state / kv_scale)
        cross_scale.append(kv_scale)
        kv_state = kv_state * cross_decay + kv_chunks[:, :, n]
        kv_scale = (kv_state.detach().abs().sum(-2, keepdim=True).amax(-1, keepdim=True)
                    .clamp(min=1.0))
    kv_rec = torch.stack(kv_rec, dim=2)               # (B, H, N, dk, dv)
    cross_scale = torch.stack(cross_scale, dim=2)     # (B, H, N, 1, 1)

    cross_out = (qc * inner_decay[:, None]) @ kv_rec
    all_scale = torch.maximum(inner_scale, cross_scale)
    out = inner_out * (inner_scale / all_scale) + cross_out * (cross_scale / all_scale)
    return out.reshape(B, H, T, dv), kv_state, kv_scale


def retention_layer_pure(gammas: torch.Tensor, x: torch.Tensor, w: RL.RetLayerWeights,
                         kv0: torch.Tensor, s0: torch.Tensor, chunk: int):
    """The plain route on a retention layer's packed weights (`RL.pack_retention`;
    the arguments and results of `RL.retention_layer`): what the JAX
    package's custom VJP of its fused layer differentiates
    (`retention_layer_pallas.py:265-277`, both kernel flags off), the
    recompute of the "fused" route's bf16 gradient."""
    B, T, D = x.shape
    H, Fv = gammas.shape[0], w.wo.shape[0]
    dk, dv = D // H, Fv // H
    kscale = float(torch.tensor(dk ** -0.5).to(x.dtype)) if x.dtype == torch.bfloat16 \
        else dk ** -0.5
    q, k, v, g = tnn.linear(x, w.wqkvg.T, w.bqkvg).split([D, D, Fv, Fv], dim=-1)

    def heads(t, d):                                  # (B, T, H*d) -> (B, H, T, d)
        return t.reshape(B, T, H, d).transpose(1, 2)

    out, kv_f, s_f = _plain_core(heads(q, dk), heads(k * kscale, dk), heads(v, dv),
                                 {"kv": kv0, "scale": s0}, gammas, chunk)
    return (_finish_w(out.to(x.dtype), g, w.wo.T, w.bo), kv_f.to(kv0.dtype),
            s_f.to(s0.dtype))


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
    No xpos rotation, with `use_xpos` or without (as the JAX package's
    step); tensor-parallel shards are gathered whole.
    """
    B = x_t.shape[0]
    H, dk, dv = cfg.num_heads, cfg.key_dim, cfg.head_dim
    q = tnn.full_linear(p.q_proj, x_t).reshape(B, H, dk)
    k = (tnn.full_linear(p.k_proj, x_t) * dk ** -0.5).reshape(B, H, dk)
    v = tnn.full_linear(p.v_proj, x_t).reshape(B, H, dv)
    g = tnn.full_linear(p.g_proj, x_t)
    gammas = decay_gammas(cfg, x_t.device)[None]          # (1, H)

    prev_scale = state["scale"]
    scale = prev_scale * gammas + 1.0
    decay_mix = (torch.sqrt(prev_scale) * gammas / torch.sqrt(scale))[..., None, None]
    kv_t = v[..., :, None] * k[..., None, :]               # (B, H, dv, dk)
    kv = state["kv"] * decay_mix + kv_t / torch.sqrt(scale)[..., None, None]
    out = torch.einsum("bhk,bhvk->bhv", q.to(kv.dtype), kv)   # float32 on a bf16 state

    out = tnn.layer_norm(out, eps=1e-6).reshape(B, H * dv).to(x_t.dtype)
    out = torch.nn.functional.silu(g) * out
    out = tnn.full_linear(p.out_proj, out)
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
