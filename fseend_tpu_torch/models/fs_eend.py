"""FS-EEND: transformer encoder, look-ahead cnn and the non-autoregressive
attractor decoder, in four inference modes over one `FSEEND`.

Port of `fseend_tpu/models/fs_eend.py`.  Parameters live in `FSEEND`, an
`nn.Module` whose submodule paths follow the JAX parameter pytree (`enc.bn`,
`enc.layers.{i}.self_attn`, `dec.layers.{i}.time_attn`, ...); the input
BatchNorm's running statistics (the JAX `model_state["bn"]`) are its
buffers.  `dec.layers.{i}.norm12` is
allocated and unused, as in the reference.

1. Batch (`fs_forward`, `fs_test`): whole recordings, causal masks; with
   train=True the training pass (train-mode BatchNorm, dropout from a
   `torch.Generator`, autograd).
2. Per-frame streaming (`fs_stream_step` / `fs_stream_scan`): one frame per
   step against fixed-capacity KV caches at per-lane clocks; the oracle the
   fast block is held to.
3. The per-frame-exact fast block (`fs_framestream_block`): K frames per
   call with the outputs of K per-frame steps; the history prefix is read
   once per block and intra-block causality is a mask.  Decoder cache
   positions are the STREAM clock, the first `conv_delay` of them masked
   (`min_pos`), the self position always readable.  With
   `cfg.use_flash_attn` every layer's cached attention is one
   `kernels/cached_attention.py:cached_attention_perlane` call (a CUDA
   kernel on the card).
4. Blockwise streaming (`fs_blockstream_init/step/run`): K frames per step
   with one shared clock, one block of emission lag, equal to the batch
   pass.  With `cfg.use_flash_attn` the encoder's cached attention is one
   `cached_attention` call per layer; the decoder stays on the plain masked
   path, as in the JAX package (`fs_eend.py:453-458`).

Stream states are flat dicts of stacked, lane-major tensors
(`utils/convert.py` maps them to and from the JAX package's nested states).
The caches are written IN PLACE (they are ~4 GB at 64 lanes and capacity
2048); the returned state shares them.  Per frame (`fs_stream_init`):
  t, emitted     (B,)                    per-lane clocks
  enc_k, enc_v   (Le, B, H, cap, hd)
  conv_buf       (B, 2*delay+1, D)       look-ahead cnn window
  dec_k, dec_v   (Ld, B, C, H, cap, hd)
Blockwise (`fs_blockstream_init`): t, emitted, m as shared 0-dim int32
clocks, the same caches, h_prev (B, K, D) and h_tail2 (B, delay, D).

A block's cache write starts at its clock clamped to [0, cap - K], as JAX's
`dynamic_update_slice` clamps; a block that would run past the capacity
therefore lands at the tail (ROADMAP C): callers keep stream length +
conv_delay within the capacity, block-aligned.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from fseend_tpu_torch.kernels import cached_attention as CA
from fseend_tpu_torch.models.ls_eend import resolve_device
from fseend_tpu_torch.ops import nn as tnn


@dataclasses.dataclass(frozen=True)
class FSEENDConfig:
    """The JAX package's FSEENDConfig.  `use_flash_attn` picks the cached
    attention route of the fast block and of the blockwise encoder: True
    (the port's default) runs the `kernels/cached_attention.py` kernels on
    the card, False the plain masked form (what the kernels are held to).
    The JAX package defaults to False, its XLA path."""
    in_size: int = 345
    n_units: int = 256
    n_heads: int = 4
    enc_n_layers: int = 4
    dec_n_layers: int = 2
    enc_dim_feedforward: int = 2048
    dec_dim_feedforward: int = 2048
    dropout: float = 0.1               # training only
    conv_delay: int = 9
    mask_delay: int = 0
    max_nspks: int = 6                 # attractor slots: max_speakers + 2
    pe_max_len: int = 5000
    use_flash_attn: bool = True

    @property
    def conv_kernel_size(self) -> int:
        return 2 * self.conv_delay + 1


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class Encoder(nn.Module):
    def __init__(self, cfg: FSEENDConfig):
        super().__init__()
        self.bn = nn.BatchNorm1d(cfg.in_size)
        self.proj = nn.Linear(cfg.in_size, cfg.n_units)
        self.norm = nn.LayerNorm(cfg.n_units)
        self.layers = nn.ModuleList(
            tnn.TransformerLayer(cfg.n_units, cfg.n_heads, cfg.enc_dim_feedforward)
            for _ in range(cfg.enc_n_layers))


class FusionLayer(nn.Module):
    """Causal time attention per slot, speaker attention per frame, FFN."""

    def __init__(self, cfg: FSEENDConfig):
        super().__init__()
        D = cfg.n_units
        self.time_attn = tnn.MultiheadAttention(D, cfg.n_heads)
        self.spk_attn = tnn.MultiheadAttention(D, cfg.n_heads)
        self.linear1 = nn.Linear(D, cfg.dec_dim_feedforward)
        self.linear2 = nn.Linear(cfg.dec_dim_feedforward, D)
        self.norm11 = nn.LayerNorm(D)
        self.norm12 = nn.LayerNorm(D)        # allocated but unused, like the reference
        self.norm21 = nn.LayerNorm(D)
        self.norm22 = nn.LayerNorm(D)


class Decoder(nn.Module):
    def __init__(self, cfg: FSEENDConfig):
        super().__init__()
        self.convert = nn.Linear(2 * cfg.n_units, cfg.n_units)
        self.layers = nn.ModuleList(FusionLayer(cfg) for _ in range(cfg.dec_n_layers))


class FSEEND(nn.Module):
    def __init__(self, cfg: FSEENDConfig):
        super().__init__()
        self.cfg = cfg
        self.enc = Encoder(cfg)
        self.cnn = nn.Conv1d(cfg.n_units, cfg.n_units, cfg.conv_kernel_size)
        self.dec = Decoder(cfg)


def empty_fs_eend(cfg: FSEENDConfig, device) -> FSEEND:
    """An FSEEND with uninitialized storage on `device` (built on the meta
    device: no random numbers are drawn from the global generator)."""
    with torch.device("meta"):
        model = FSEEND(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_fs_eend(cfg: FSEENDConfig, generator: torch.Generator | None = None,
                 device=None) -> FSEEND:
    """Randomly initialized model, drawn on the CPU from `generator`, then
    moved to `device` (the card unless the caller names another).  The
    initializers follow the JAX package's: U(+-0.1) input projection with a
    zero bias, xavier attention in-projections with zero biases,
    torch-default linears and cnn, unit layer norms, fresh BatchNorm."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = empty_fs_eend(cfg, "cpu")

    def uniform_(t, bound):
        t.uniform_(-bound, bound, generator=generator)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = m.weight.shape[1] ** -0.5
            uniform_(m.weight, bound)
            uniform_(m.bias, bound)
        elif isinstance(m, nn.Conv1d):
            bound = (m.weight.shape[1] * m.weight.shape[2]) ** -0.5
            uniform_(m.weight, bound)
            uniform_(m.bias, bound)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(m, nn.BatchNorm1d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        if isinstance(m, tnn.MultiheadAttention):
            uniform_(m.in_proj.weight, (6.0 / (2 * cfg.n_units)) ** 0.5)
            m.in_proj.bias.zero_()
    uniform_(model.enc.proj.weight, 0.1)
    model.enc.proj.bias.zero_()
    return model.to(device)


# ---------------------------------------------------------------------------
# batch (masked) mode
# ---------------------------------------------------------------------------


def _ln(m: nn.LayerNorm, x):
    return tnn.layer_norm(x, m.weight, m.bias)


def _lin(m: nn.Linear, x):
    return tnn.linear(x, m.weight, m.bias)


def _check_dtype(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: {x.dtype}; the port runs float32 only")


def fusion_layer(p: FusionLayer, x: torch.Tensor, t_mask: torch.Tensor, rate: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """x (B, T, C, D): causal attention over T per slot, full attention over
    C per frame, shared FFN, post-norm.  In training, dropout on both
    attentions' weights and outputs; the FFN has none, as in the JAX
    `fusion_layer` (its `ff_block` gets no key)."""
    xt = x.transpose(1, 2)                                      # (B, C, T, D)
    a = tnn.mha(p.time_attn, xt, xt, xt, rate, generator, mask=t_mask)
    xt = _ln(p.norm11, xt + tnn.dropout(a, rate, generator))
    x = xt.transpose(1, 2)
    a = tnn.mha(p.spk_attn, x, x, x, rate, generator)
    x = _ln(p.norm21, x + tnn.dropout(a, rate, generator))
    return _ln(p.norm22, x + tnn.ff_block(x, p.linear1, p.linear2))


def _enc_in(model: FSEEND, xs: torch.Tensor) -> torch.Tensor:
    """Eval BatchNorm, input projection and layer norm."""
    h = tnn.batch_norm(xs, model.enc.bn)
    return _ln(model.enc.norm, _lin(model.enc.proj, h))


def encode(model: FSEEND, xs: torch.Tensor, lens: torch.Tensor, train: bool = False,
           generator: torch.Generator | None = None):
    """xs (B, T, in_size) padded, lens (B,) -> (emb (B, T, D), BatchNorm
    state {"bn": {"mean", "var"}}).  The BatchNorm sees pad value -1 (in
    training its batch statistics count the padded frames, as the reference
    does) and the output is re-padded with 0 before the cnn."""
    cfg = model.cfg
    T = xs.shape[1]
    len_mask = (torch.arange(T, device=xs.device)[None, :] < lens[:, None])[..., None]
    xs = torch.where(len_mask, xs, xs.new_tensor(-1.0))
    bn = model.enc.bn
    if train:
        h, bn_state = tnn.batch_norm_train(xs, bn)
    else:
        h, bn_state = tnn.batch_norm(xs, bn), {"mean": bn.running_mean, "var": bn.running_var}
    h = _ln(model.enc.norm, _lin(model.enc.proj, h))
    rate = cfg.dropout if train else 0.0
    t_mask = tnn.causal_mask(T, cfg.mask_delay, xs.device)
    for lp in model.enc.layers:
        h = tnn.transformer_layer(lp, h, t_mask, rate, generator)
    return torch.where(len_mask, h, h.new_zeros(())), {"bn": bn_state}


def _slot_queries(model: FSEEND, emb: torch.Tensor, n_slots: int) -> torch.Tensor:
    """emb (B, T, D) beside each slot's positional code, through `convert`:
    (B, T, C, D)."""
    B, T, D = emb.shape
    pe = tnn.sinusoidal_table(n_slots, D, device=emb.device).to(emb.dtype)
    x = torch.cat([emb[:, :, None, :].expand(B, T, n_slots, D),
                   pe[None, None].expand(B, T, n_slots, D)], dim=-1)
    return _lin(model.dec.convert, x)


def decode(model: FSEEND, emb: torch.Tensor, n_slots: int, train: bool = False,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """emb (B, T, D) -> attractors (B, T, n_slots, D), before the l2 norm."""
    x = _slot_queries(model, emb, n_slots)
    t_mask = tnn.causal_mask(emb.shape[1], model.cfg.mask_delay, emb.device)
    rate = model.cfg.dropout if train else 0.0
    for lp in model.dec.layers:
        x = fusion_layer(lp, x, t_mask, rate, generator)
    return x


def fs_forward(model: FSEEND, xs, lens, n_slots: int, *, train: bool = False,
               generator: torch.Generator | None = None) -> dict:
    """Full batch pass on the device that holds `model`.  Returns logits
    (B, T, n_slots), emb (B, T, D) after the cnn and the l2 norm,
    attractors (B, T, n_slots, D) after the l2 norm, and "state", the
    BatchNorm running statistics {"bn": {"mean", "var"}}, updated from this
    batch in training.

    train=True is the training pass (differentiable; dropout from
    `generator`, which lives on the model's device, none without one);
    otherwise the pass runs without autograd."""
    with contextlib.nullcontext() if train else torch.no_grad():
        cfg = model.cfg
        device = model.cnn.weight.device
        xs = torch.as_tensor(xs).to(device)
        _check_dtype(xs, "fs_forward")
        lens = torch.as_tensor(lens).to(device)
        h, state = encode(model, xs, lens, train, generator)
        emb = tnn.l2_normalize(tnn.lookahead_conv(h, model.cnn.weight, model.cnn.bias,
                                                  cfg.conv_delay))
        attractors = tnn.l2_normalize(decode(model, emb, n_slots, train, generator))
        logits = torch.einsum("btd,btcd->btc", emb, attractors)
        return {"logits": logits, "emb": emb, "attractors": attractors, "state": state}


def fs_test(model: FSEEND, xs, lens, max_nspks: int | None = None) -> dict:
    """Inference entry (the reference's `model.test`): max_speakers + 2
    slots; the caller drops slot 0 (silence) and applies the sigmoid."""
    n_slots = max_nspks if max_nspks is not None else model.cfg.max_nspks
    return fs_forward(model, xs, lens, n_slots)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def fs_stream_init(cfg: FSEENDConfig, batch: int, capacity: int,
                   n_slots: int | None = None, dtype=torch.float32, device=None) -> dict:
    """Fresh per-frame state for `batch` lanes with caches of `capacity`
    positions (the most frames a stream may push, flush included), on the
    card unless the caller names another device."""
    device = resolve_device(device)
    if dtype != torch.float32:
        raise NotImplementedError("the port serves float32 only so far (ROADMAP: bf16)")
    H, D = cfg.n_heads, cfg.n_units
    hd = D // H
    C = n_slots if n_slots is not None else cfg.max_nspks
    Le, Ld = cfg.enc_n_layers, cfg.dec_n_layers

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "t": torch.zeros(batch, dtype=torch.int32, device=device),
        "emitted": torch.zeros(batch, dtype=torch.int32, device=device),
        "enc_k": z(Le, batch, H, capacity, hd),
        "enc_v": z(Le, batch, H, capacity, hd),
        "conv_buf": z(batch, cfg.conv_kernel_size, D),
        "dec_k": z(Ld, batch, C, H, capacity, hd),
        "dec_v": z(Ld, batch, C, H, capacity, hd),
    }


def _write_perlane(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """cache (B, ..., cap, hd)[b, ..., pos[b, i]] = new (B, ..., K, hd)[b, ..., i],
    in place."""
    B, cap, hd = cache.shape[0], cache.shape[-2], cache.shape[-1]
    K = new.shape[-2]
    c = cache.view(B, -1, cap, hd)
    n = new.reshape(B, -1, K, hd)
    c.scatter_(2, pos.long()[:, None, :, None].expand(B, c.shape[1], K, hd), n)


def _gather_perlane(cache: torch.Tensor, pos: torch.Tensor, like: torch.Tensor):
    B, cap, hd = cache.shape[0], cache.shape[-2], cache.shape[-1]
    K = pos.shape[1]
    c = cache.view(B, -1, cap, hd)
    old = c.gather(2, pos.long()[:, None, :, None].expand(B, c.shape[1], K, hd))
    return old.reshape(like.shape)


def _clamped_start(start: torch.Tensor, K: int, cap: int) -> torch.Tensor:
    """Where a K-position write at `start` lands: clamped to [0, cap - K],
    as `jax.lax.dynamic_update_slice` clamps."""
    return start.clamp(0, cap - K)


# ---------------------------------------------------------------------------
# per-frame streaming (the oracle)
# ---------------------------------------------------------------------------


def _cached_attention(attn: tnn.MultiheadAttention, x_q: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor, idx: torch.Tensor, keep_old: torch.Tensor):
    """One query per lane against its cache.  x_q (B, ..., D); ck, cv
    (B, ..., H, cap, hd).  Lane b writes its k/v at idx[b] and reads
    positions [0, idx[b]]; afterwards lanes with keep_old[b] get their old
    cache entry back (the JAX `lane_keep`).  Returns out (B, ..., D)."""
    q, k, v = tnn.mha_project_qkv(attn, x_q[..., None, :], x_q[..., None, :],
                                  x_q[..., None, :])           # (B, ..., H, 1, hd)
    cap = ck.shape[-2]
    pos = _clamped_start(idx, 1, cap)[:, None]                 # (B, 1)
    old_k, old_v = _gather_perlane(ck, pos, k), _gather_perlane(cv, pos, v)
    _write_perlane(ck, k, pos)
    _write_perlane(cv, v, pos)
    zero = torch.zeros((), device=x_q.device)
    mask = torch.where(torch.arange(cap, device=x_q.device)[None, :] <= idx[:, None],
                       zero, float("-inf"))                    # (B, cap)
    mask = mask.reshape((mask.shape[0],) + (1,) * (q.ndim - 2) + (cap,))
    out = tnn.mha_core(q, ck, cv, mask)
    keep = keep_old.reshape((-1,) + (1,) * (k.ndim - 1))
    _write_perlane(ck, torch.where(keep, old_k, k), pos)
    _write_perlane(cv, torch.where(keep, old_v, v), pos)
    out = tnn.merge_heads(out)[..., 0, :]
    return _lin(attn.out_proj, out)


@torch.no_grad()
def fs_stream_step(model: FSEEND, state: dict, x_t: torch.Tensor, n_slots: int,
                   flush=False):
    """One streaming step for every lane.  x_t (B, in_size) is the frame at
    each lane's clock.  After a stream's last frame, `conv_delay` flush steps
    (scalar or per lane) push zeros into the cnn without running the
    encoder's cache writes.  Caches are updated in place.  Returns
    (new_state, {"logits" (B, n_slots), "emb" (B, D), "valid" (B,)});
    valid is False during a lane's first conv_delay steps."""
    cfg = model.cfg
    _check_dtype(x_t, "fs_stream_step")
    t = state["t"]
    B = x_t.shape[0]
    flush = torch.as_tensor(flush, dtype=torch.bool, device=x_t.device).expand(B)
    h = _enc_in(model, x_t)
    for l, lp in enumerate(model.enc.layers):
        a = _cached_attention(lp.self_attn, h, state["enc_k"][l], state["enc_v"][l], t, flush)
        h = _ln(lp.norm1, h + a)
        h = _ln(lp.norm2, h + tnn.ff_block(h, lp.linear1, lp.linear2))
    h = torch.where(flush[:, None], h.new_zeros(()), h)
    conv_buf = torch.cat([state["conv_buf"][:, 1:], h[:, None, :]], dim=1)
    y = torch.einsum("bkd,odk->bo", conv_buf, model.cnn.weight) + model.cnn.bias
    valid = t >= cfg.conv_delay
    emb = tnn.l2_normalize(y)
    u = state["emitted"]
    x = _slot_queries(model, emb[:, None], n_slots)[:, 0]      # (B, C, D)
    for l, lp in enumerate(model.dec.layers):
        a = _cached_attention(lp.time_attn, x, state["dec_k"][l], state["dec_v"][l], u, ~valid)
        x = _ln(lp.norm11, x + a)
        x = _ln(lp.norm21, x + tnn.mha(lp.spk_attn, x, x, x))
        x = _ln(lp.norm22, x + tnn.ff_block(x, lp.linear1, lp.linear2))
    logits = torch.einsum("bd,bcd->bc", emb, tnn.l2_normalize(x))
    # the clock counts steps, flush included: a flush step still slides the
    # cnn window, so `valid` keeps advancing
    new_state = dict(state, t=t + 1, emitted=torch.where(valid, u + 1, u), conv_buf=conv_buf)
    return new_state, {"logits": logits, "emb": emb, "valid": valid}


def fs_stream_scan(model: FSEEND, state: dict, xs: torch.Tensor, n_slots: int):
    """A whole (B, T, F) clip frame by frame plus conv_delay flush steps;
    time-aligned (logits (B, T, n_slots), emb (B, T, D))."""
    cfg = model.cfg
    B, T, Fin = xs.shape
    seq = torch.cat([xs, xs.new_zeros(B, cfg.conv_delay, Fin)], dim=1)
    logits, embs = [], []
    for i in range(T + cfg.conv_delay):
        state, out = fs_stream_step(model, state, seq[:, i], n_slots, flush=i >= T)
        logits.append(out["logits"])
        embs.append(out["emb"])
    d = cfg.conv_delay
    return torch.stack(logits[d:], dim=1), torch.stack(embs[d:], dim=1)


# ---------------------------------------------------------------------------
# per-frame-exact fast block
# ---------------------------------------------------------------------------
#
# Masked attention does not depend on the order of evaluation, so a block of
# K frames is advanced in one pass that reads the history prefix once and
# handles the causality inside the block with a (K, cap) mask, while every
# output frame still depends only on inputs up to its own stream time.
# Contract (held by real streams, checked nowhere): per lane, flush frames
# are a suffix of the stream, so the encoder cache writes of flush frames
# land where no real query reads; stream length + conv_delay <= capacity.


def _cached_attention_block_perlane(attn: tnn.MultiheadAttention, x_q: torch.Tensor,
                                    ck: torch.Tensor, cv: torch.Tensor,
                                    start: torch.Tensor, min_pos: int, flash: bool):
    """K queries per lane against its cache: x_q (B, ..., K, D); ck, cv
    (B, ..., H, cap, hd); start (B,).  Lane b writes its block's k/v at
    [start[b], start[b] + K) (clamped) and query i reads positions p with
    (min_pos <= p <= start[b] + i) or p == start[b] + i."""
    q, k, v = tnn.mha_project_qkv(attn, x_q, x_q, x_q)       # (B, ..., H, K, hd)
    B, K = x_q.shape[0], x_q.shape[-2]
    cap, hd = ck.shape[-2], ck.shape[-1]
    pos = _clamped_start(start, K, cap)[:, None] + torch.arange(K, device=start.device)
    _write_perlane(ck, k, pos)
    _write_perlane(cv, v, pos)
    R = q.numel() // (K * hd)
    fn = CA.cached_attention_perlane if flash else CA.cached_attention_perlane_plain
    out = fn(q.reshape(R, K, hd), ck.view(R, cap, hd), cv.view(R, cap, hd), start,
             R // B, min_pos).reshape(q.shape)
    return _lin(attn.out_proj, tnn.merge_heads(out))


@torch.no_grad()
def fs_framestream_block(model: FSEEND, state: dict, xs: torch.Tensor, n_slots: int,
                         flush: torch.Tensor):
    """Advance the `fs_stream_init` state by K frames with the outputs of K
    `fs_stream_step` calls: output i is frame start + i - conv_delay, gated
    by `valid` as there.  xs (B, K, in_size); flush (B, K) bool, a suffix of
    each lane's stream.  Caches are written in place.  Returns
    (new_state, (logits (B, K, n_slots), valid (B, K)))."""
    cfg = model.cfg
    _check_dtype(xs, "fs_framestream_block")
    B, K, _ = xs.shape
    t = state["t"]
    flush = torch.as_tensor(flush, dtype=torch.bool, device=xs.device).expand(B, K)
    h = _enc_in(model, xs)
    for l, lp in enumerate(model.enc.layers):
        a = _cached_attention_block_perlane(lp.self_attn, h, state["enc_k"][l],
                                            state["enc_v"][l], t, 0, cfg.use_flash_attn)
        h = _ln(lp.norm1, h + a)
        h = _ln(lp.norm2, h + tnn.ff_block(h, lp.linear1, lp.linear2))
    # flush frames push zeros into the cnn (their cache writes are never read)
    h = torch.where(flush[..., None], h.new_zeros(()), h)
    window = torch.cat([state["conv_buf"][:, 1:], h], dim=1)   # (B, k-1+K, D)
    emb = tnn.l2_normalize(tnn.conv1d(window, model.cnn.weight, model.cnn.bias))
    valid = (t[:, None] + torch.arange(K, device=xs.device)[None, :]) >= cfg.conv_delay
    x = _slot_queries(model, emb, n_slots)                     # (B, K, C, D)
    for l, lp in enumerate(model.dec.layers):
        xt = x.transpose(1, 2)                                 # (B, C, K, D)
        a = _cached_attention_block_perlane(lp.time_attn, xt, state["dec_k"][l],
                                            state["dec_v"][l], t, cfg.conv_delay,
                                            cfg.use_flash_attn)
        x = _ln(lp.norm11, xt + a).transpose(1, 2)
        x = _ln(lp.norm21, x + tnn.mha(lp.spk_attn, x, x, x))
        x = _ln(lp.norm22, x + tnn.ff_block(x, lp.linear1, lp.linear2))
    logits = torch.einsum("bkd,bkcd->bkc", emb, tnn.l2_normalize(x))
    new_state = dict(state, t=t + K,
                     emitted=(t + K - cfg.conv_delay).clamp(min=0).to(torch.int32),
                     conv_buf=window[:, -cfg.conv_kernel_size:])
    return new_state, (logits, valid)


# ---------------------------------------------------------------------------
# blockwise streaming: K queries per step, one shared clock
# ---------------------------------------------------------------------------
#
# Attending a block of K queries against the growing cache is exact against
# both the per-frame path and the batch pass.  The look-ahead cnn uses the
# one-block lag of the LS blockwise mode: the emitted block is the previous
# one, whose +delay context is the new block's head.  Requires K >= conv_delay.


def fs_blockstream_init(cfg: FSEENDConfig, batch: int, capacity: int,
                        n_slots: int | None = None, block: int = 100,
                        dtype=torch.float32, device=None) -> dict:
    """Fresh blockwise state: the per-frame caches with shared 0-dim clocks
    (the K-query write is one contiguous slice; all lanes advance
    together), on the card unless the caller names another device."""
    if block < cfg.conv_delay:
        raise ValueError(f"block={block} must be >= conv_delay={cfg.conv_delay}")
    device = resolve_device(device)
    st = fs_stream_init(cfg, batch, capacity, n_slots, dtype, device)
    del st["conv_buf"]
    scalar = torch.zeros((), dtype=torch.int32, device=device)
    st.update(t=scalar, emitted=scalar.clone(), m=scalar.clone(),
              h_prev=torch.zeros(batch, block, cfg.n_units, dtype=dtype, device=device),
              h_tail2=torch.zeros(batch, cfg.conv_delay, cfg.n_units, dtype=dtype,
                                  device=device))
    return st


def _cached_attention_block(attn: tnn.MultiheadAttention, x_q: torch.Tensor,
                            ck: torch.Tensor, cv: torch.Tensor, start: torch.Tensor,
                            flash: bool, keep_old: torch.Tensor | None = None):
    """K queries against the cache with one shared head: x_q (..., K, D);
    ck, cv (..., H, cap, hd).  Writes the block's k/v at [start, start + K)
    (clamped) and query i reads positions <= start + i; afterwards, where
    `keep_old` (a 0-dim bool) holds, the old entries are written back."""
    q, k, v = tnn.mha_project_qkv(attn, x_q, x_q, x_q)       # (..., H, K, hd)
    K = x_q.shape[-2]
    cap, hd = ck.shape[-2], ck.shape[-1]
    pos = _clamped_start(start, K, cap) + torch.arange(K, device=start.device)
    old = None
    if keep_old is not None:
        old = (ck.index_select(-2, pos), cv.index_select(-2, pos))
    ck.index_copy_(ck.ndim - 2, pos, k)
    cv.index_copy_(cv.ndim - 2, pos, v)
    if flash:
        R = q.numel() // (K * hd)
        out = CA.cached_attention(q.reshape(R, K, hd), ck.reshape(R, cap, hd),
                                  cv.reshape(R, cap, hd), start).reshape(q.shape)
    else:
        out = CA.cached_attention_plain(q, ck, cv, start)
    if old is not None:
        ck.index_copy_(ck.ndim - 2, pos, torch.where(keep_old, old[0], k))
        cv.index_copy_(cv.ndim - 2, pos, torch.where(keep_old, old[1], v))
    return _lin(attn.out_proj, tnn.merge_heads(out))


@torch.no_grad()
def fs_blockstream_step(model: FSEEND, state: dict, xs: torch.Tensor, n_slots: int,
                        enc_bypass: bool = False, h_mask: torch.Tensor | None = None):
    """Consume block m (B, K, in_size), emit logits (B, K, n_slots) of block
    m-1 (the first call's output is warm-up garbage).  enc_bypass=True
    drains the last block with zero embeddings (the stream-end flush): the
    encoder is not run and its caches and clock are kept.  h_mask, (K,) for
    all lanes or (B, K) per lane, zeroes this block's embeddings frame by
    frame (a zero-padded final block).  Caches are written in place."""
    cfg = model.cfg
    _check_dtype(xs, "fs_blockstream_step")
    B, K, _ = xs.shape
    D = cfg.n_units
    t = state["t"]
    if enc_bypass:
        h = xs.new_zeros(B, K, D)
    else:
        h = _enc_in(model, xs)
        for l, lp in enumerate(model.enc.layers):
            a = _cached_attention_block(lp.self_attn, h, state["enc_k"][l],
                                        state["enc_v"][l], t, cfg.use_flash_attn)
            h = _ln(lp.norm1, h + a)
            h = _ln(lp.norm2, h + tnn.ff_block(h, lp.linear1, lp.linear2))
        if h_mask is not None:
            h = h * torch.as_tensor(h_mask, device=h.device).to(h.dtype).reshape(-1, K, 1)
    window = torch.cat([state["h_tail2"], state["h_prev"], h[:, :cfg.conv_delay]], dim=1)
    emb = tnn.l2_normalize(tnn.conv1d(window, model.cnn.weight, model.cnn.bias))
    u = state["emitted"]
    first = state["m"] == 0
    x = _slot_queries(model, emb, n_slots)                     # (B, K, C, D)
    for l, lp in enumerate(model.dec.layers):
        xt = x.transpose(1, 2)                                 # (B, C, K, D)
        # the decoder stays on the plain masked path, as in the JAX package
        a = _cached_attention_block(lp.time_attn, xt, state["dec_k"][l], state["dec_v"][l],
                                    u, False, keep_old=first)
        x = _ln(lp.norm11, xt + a).transpose(1, 2)
        x = _ln(lp.norm21, x + tnn.mha(lp.spk_attn, x, x, x))
        x = _ln(lp.norm22, x + tnn.ff_block(x, lp.linear1, lp.linear2))
    logits = torch.einsum("bkd,bkcd->bkc", emb, tnn.l2_normalize(x))
    new_state = dict(state, t=t if enc_bypass else t + K,
                     emitted=torch.where(first, u, u + K), h_prev=h,
                     h_tail2=state["h_prev"][:, -cfg.conv_delay:], m=state["m"] + 1)
    return new_state, logits


def fs_blockstream_run(model: FSEEND, xs: torch.Tensor, n_slots: int, block: int):
    """Whole-clip blockwise streaming, time-aligned logits (B, T, n_slots);
    equals `fs_forward` on the same clip."""
    B, T, Fin = xs.shape
    padT = (-T) % block
    state = fs_blockstream_init(model.cfg, B, T + padT, n_slots, block, xs.dtype, xs.device)
    xs_p = torch.nn.functional.pad(xs, (0, 0, 0, padT))
    outs = []
    for st_i in range(0, T + padT, block):
        h_mask = torch.arange(st_i, st_i + block, device=xs.device) < T
        state, logits = fs_blockstream_step(model, state, xs_p[:, st_i:st_i + block],
                                            n_slots, h_mask=h_mask)
        outs.append(logits)
    state, logits = fs_blockstream_step(model, state, xs.new_zeros(B, block, Fin), n_slots,
                                        enc_bypass=True)
    outs.append(logits)
    return torch.cat(outs[1:], dim=1)[:, :T]
