"""Sequence parallelism (SP): the time axis of the O(T^2) and O(T)
activation ops sharded over the "data" ranks of a mesh.  Port of
`fseend_tpu/parallel/sp.py`.

Each rank holds T/n frames.  The functions take the global input (every
rank has it, as the JAX `shard_map`s take the global array) and run on
their rank's frames:

  * `sp_causal_mha`, `sp_retention_parallel`: queries stay local, keys and
    values are all-gathered, the causal mask uses global positions; they
    return the gathered output, equal to the single-process op.
  * `fs_forward_sp`: the whole FS-EEND eval pass (the long-form scoring
    path); returns the gathered logits.
  * `fs_forward_sp_train`, `ls_forward_sp_train`: the train passes.  They
    return the rank's shard of logits, emb and attractors and the updated
    BatchNorm statistics (global, so equal on every rank).  BatchNorm takes
    two psum'd passes over the global (batch, time) axes, padded frames
    counted; dropout draws from the caller's generator, one stream per rank
    (the JAX package folds the shard index into its key): equality with one
    process holds at dropout 0.
  * `make_fs_train_step_sp`, `make_ls_train_step_sp`: the trainer's step
    around them.  The logits and emb are all-gathered and every rank
    computes the global batch's loss, backpropagated divided by the number
    of ranks (the collectives' backward sums over ranks); the gradients are
    summed over the ranks.

LS retention: γ = 1 (the reference) makes the cross-chunk carry a prefix
sum of the chunks' kv summaries, so each rank seeds its chunkwise scan with
the sum over the earlier ranks (`kv0`, one all-gather; its scale `s0` the
clamp of that sum, no gradient) and runs it through its existing route:
the "fused" retention layer (`kernels/retention_layer.py`, B4), the
chunkwise core (`kernels/chunk_retention.py`, B5) or the plain core.  The
gradient of `kv0` flows back through the all-gather to the earlier ranks'
chunk sums.  The decoder is the unfused fusion layer even under
`use_fused_dec`, as the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fseend_tpu_torch.models import fs_eend, ls_eend
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.ops import retention as R
from fseend_tpu_torch.parallel import collectives as C
from fseend_tpu_torch.train import trainer as trainer_lib


def _group(mesh, axis: str):
    """The process group of the mesh axis SP runs over ("data" or "model")."""
    if axis not in ("data", "model"):
        raise ValueError(f"axis {axis!r}: a mesh has the axes \"data\" and \"model\"")
    trainer_lib.check_mesh(mesh)
    return mesh.group if axis == "data" else mesh.model_group


def _local(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The rank's equal share of `x` along `dim`."""
    n = C.axis_size(group)
    T = x.shape[dim]
    if T % n:
        raise ValueError(f"T={T} must divide over the {n} ranks")
    return x.narrow(dim, C.axis_index(group) * (T // n), T // n)


def _global_pos(Tl: int, group, device) -> torch.Tensor:
    return C.axis_index(group) * Tl + torch.arange(Tl, device=device)


def _causal_rows(Tl: int, T: int, group, mask_delay: int, device) -> torch.Tensor:
    """(Tl, T) additive mask of the rank's query rows at global positions."""
    q = _global_pos(Tl, group, device)[:, None]
    k = torch.arange(T, device=device)[None, :]
    return torch.where(k <= q + mask_delay, torch.zeros((), device=device), float("-inf"))


def _sp_attn(p: tnn.MultiheadAttention, x: torch.Tensor, mask: torch.Tensor, group,
             rate: float = 0.0, generator=None) -> torch.Tensor:
    """Self-attention over the time axis (the second to last of x) with the
    keys and values gathered from every rank."""
    q, k, v = tnn.mha_project_qkv(p, x, x, x)
    k_all = C.all_gather(k, group, dim=-2)
    v_all = C.all_gather(v, group, dim=-2)
    out = tnn.merge_heads(tnn.mha_core(q, k_all, v_all, mask, rate, generator))
    return tnn.linear(out, p.out_proj.weight, p.out_proj.bias)


def sp_causal_mha(p: tnn.MultiheadAttention, x: torch.Tensor, mesh, axis: str = "data",
                  mask_delay: int = 0) -> torch.Tensor:
    """Causal MHA of x (B, T, D) with the time axis sharded: equals
    `tnn.mha(p, x, x, x, mask=causal_mask(T))`."""
    group = _group(mesh, axis)
    xl = _local(x, group)
    mask = _causal_rows(xl.shape[1], x.shape[1], group, mask_delay, x.device)
    return C.all_gather(_sp_attn(p, xl, mask, group), group, dim=1)


def sp_retention_parallel(p: R.Retention, x: torch.Tensor, cfg: R.RetentionConfig, mesh,
                          axis: str = "data") -> torch.Tensor:
    """γ = 1 parallel retention of x (B, T, D) with the time axis sharded:
    row i's decay normalization and its clamped row sum depend on row-local
    quantities only, so each rank computes its rows exactly."""
    if cfg.use_decay or cfg.use_xpos:
        raise ValueError("sequence-parallel retention implements γ = 1 without xpos "
                         "(use_decay=False, use_xpos=False)")
    group = _group(mesh, axis)
    xl = _local(x, group)
    Tl = xl.shape[1]
    q, k, v, g = R._project_qkv(p, xl, cfg)               # (B, H, Tl, d*)
    k_all = C.all_gather(k, group, dim=2)
    v_all = C.all_gather(v, group, dim=2)
    qpos = _global_pos(Tl, group, x.device)[:, None]
    tri = torch.arange(x.shape[1], device=x.device)[None, :] <= qpos
    mask = torch.where(tri, 1.0, 0.0) / torch.sqrt(qpos.float() + 1.0)
    qk = (q @ k_all.transpose(-1, -2)) * mask
    qk = qk / qk.detach().sum(-1, keepdim=True).abs().clamp(min=1.0)
    return C.all_gather(R._finish(p, qk @ v_all, g, cfg), group, dim=1)


def _halo_causal_conv(weight: torch.Tensor, h: torch.Tensor, group) -> torch.Tensor:
    """Causal depthwise conv of the rank's (B, Tl, D) frames: the k-1
    history frames come from the left neighbour (zeros at the global
    start), `tnn.causal_depthwise_conv` with that history."""
    k = weight.shape[-1]
    return tnn.causal_depthwise_conv(h, weight, C.shift(h[:, -(k - 1):], 1, group))


def _sp_batch_norm_train(x: torch.Tensor, bn, group, momentum: float = 0.1):
    """`tnn.batch_norm_train` with the (batch, time) statistics over every
    rank's frames (two psum'd passes)."""
    with C.data_parallel(group):
        return tnn.batch_norm_train(x, bn, momentum)


def _sp_retention_chunkwise(p: R.Retention, x: torch.Tensor, cfg: R.RetentionConfig,
                            group) -> torch.Tensor:
    """γ = 1 chunkwise retention of the rank's frames x (B, Tl, D), Tl a
    multiple of the chunk: the rank's chunk kv summaries are summed, one
    all-gather shares the sums, and the rank's scan starts from the sum over
    the earlier ranks (module docstring) on the route `cfg.kernel` picks."""
    if cfg.use_decay or cfg.use_xpos:
        raise ValueError("sequence-parallel chunkwise retention needs γ = 1 without xpos "
                         "(use_decay=False, use_xpos=False): the prefix-sum carry holds "
                         "only there, as the JAX package asserts")
    B, Tl, _ = x.shape
    L = cfg.chunk_size
    if Tl % L:
        raise ValueError(f"local T={Tl} must hold whole chunks of {L}")
    H, dk, dv = cfg.num_heads, cfg.key_dim, cfg.head_dim
    _, k, v, _ = R._project_qkv(p, x, cfg)                              # (B, H, Tl, d*)
    last = R._decay_mask(L, R.decay_gammas(cfg, x.device))[0][:, -1]     # (H, L)
    kc = k.reshape(B, H, Tl // L, L, dk)
    vc = v.reshape(B, H, Tl // L, L, dv)
    own = (kc.transpose(-1, -2) @ (vc * last[:, None, :, None])).sum(2)  # (B, H, dk, dv)
    sums = C.all_gather(own[None], group)                                # (n, B, H, dk, dv)
    earlier = torch.arange(sums.shape[0], device=x.device) < C.axis_index(group)
    kv0 = torch.where(earlier[:, None, None, None, None], sums, 0.0).sum(0)
    s0 = kv0.detach().abs().sum(-2, keepdim=True).amax(-1, keepdim=True).clamp(min=1.0)
    return R.retention_chunkwise_stateful(p, x, {"kv": kv0, "scale": s0}, cfg)[0]


def fs_forward_sp_train(model: fs_eend.FSEEND, xs, lens, mesh, n_slots: int,
                        axis: str = "data", *, train: bool = True, generator=None) -> dict:
    """The FS-EEND train pass with the time axis sharded (module
    docstring): this rank's logits (B, Tl, C), emb (B, Tl, D), attractors
    (B, Tl, C, D) and "state", the BatchNorm statistics {"bn": ...}.  The
    encoder's attention and the decoder's time attention gather their keys
    and values, the look-ahead cnn takes a ±conv_delay halo."""
    group = _group(mesh, axis)
    cfg = model.cfg
    B, T, _ = xs.shape
    xl = _local(xs, group)
    Tl = xl.shape[1]
    rate = cfg.dropout if train else 0.0
    gen = generator if train else None
    pos = _global_pos(Tl, group, xs.device)
    len_mask = (pos[None, :] < lens[:, None])[..., None]
    x_in = torch.where(len_mask, xl, xl.new_tensor(-1.0))
    bn = model.enc.bn
    if train:
        h, bn_state = _sp_batch_norm_train(x_in, bn, group)
    else:
        h, bn_state = tnn.batch_norm(x_in, bn), {"mean": bn.running_mean, "var": bn.running_var}
    h = fs_eend._ln(model.enc.norm, fs_eend._lin(model.enc.proj, h))
    mask = _causal_rows(Tl, T, group, cfg.mask_delay, xs.device)
    for lp in model.enc.layers:
        # tnn.transformer_layer with the attention over the gathered frames
        a = _sp_attn(lp.self_attn, h, mask, group, rate, gen)
        h = fs_eend._ln(lp.norm1, h + tnn.dropout(a, rate, gen))
        h = fs_eend._ln(lp.norm2, h + tnn.ff_block(h, lp.linear1, lp.linear2, rate, gen))
    h = torch.where(len_mask, h, h.new_zeros(()))
    window = C.halo_exchange(h, cfg.conv_delay, group)
    emb = tnn.l2_normalize(tnn.conv1d(window, model.cnn.weight, model.cnn.bias))
    x = fs_eend._slot_queries(model, emb, n_slots)
    for lp in model.dec.layers:
        # fs_eend.fusion_layer with the time attention over the gathered frames
        xt = x.transpose(1, 2)
        a = _sp_attn(lp.time_attn, xt, mask, group, rate, gen)
        x = fs_eend._ln(lp.norm11, xt + tnn.dropout(a, rate, gen)).transpose(1, 2)
        a = tnn.mha(lp.spk_attn, x, x, x, rate, gen)
        x = fs_eend._ln(lp.norm21, x + tnn.dropout(a, rate, gen))
        x = fs_eend._ln(lp.norm22, x + tnn.ff_block(x, lp.linear1, lp.linear2))
    attractors = tnn.l2_normalize(x)
    logits = torch.einsum("btd,btcd->btc", emb.float(), attractors.float())
    return {"logits": logits, "emb": emb, "attractors": attractors, "state": {"bn": bn_state}}


@torch.no_grad()
def fs_forward_sp(model: fs_eend.FSEEND, xs, mesh, n_slots: int,
                  axis: str = "data") -> torch.Tensor:
    """The FS-EEND eval pass over whole recordings xs (B, T, F) with the
    time axis sharded, the long-form scoring path: the gathered logits
    (B, T, n_slots), equal to `fs_forward`'s on full-length input."""
    group = _group(mesh, axis)
    lens = torch.full((xs.shape[0],), xs.shape[1], device=xs.device)
    out = fs_forward_sp_train(model, xs, lens, mesh, n_slots, axis, train=False)
    return C.all_gather(out["logits"], group, dim=1)


def ls_forward_sp_train(model: ls_eend.LSEEND, xs, lens, mesh, n_slots: int,
                        axis: str = "data", *, train: bool = True, generator=None) -> dict:
    """The LS-EEND train pass with the time axis sharded (module
    docstring): xs is padded to a multiple of (ranks x chunk_size), and
    this rank's shard of the padded logits, emb and attractors comes back
    with "state", the conformer BatchNorm statistics {"conv_bn": [...]}
    (the padded frames counted, as the reference does).  Per pass: one kv
    all-gather per retention layer, one (k-1)-frame halo per conformer conv,
    a ±conv_delay halo for the cnn and the psum'd BatchNorm statistics."""
    group = _group(mesh, axis)
    cfg = model.cfg
    rc = cfg.ret_cfg
    xs = ls_eend.pad_to_chunk(xs, C.axis_size(group) * cfg.chunk_size)
    xl = _local(xs, group)
    B, Tl, _ = xl.shape
    rate = cfg.dropout if train else 0.0
    gen = generator if train else None
    len_mask = (_global_pos(Tl, group, xs.device)[None, :] < lens[:, None])[..., None]
    zero = xl.new_zeros(())
    h = ls_eend._ln(model.enc.norm, ls_eend._lin(model.enc.proj, torch.where(len_mask, xl, zero)))
    conv_bn = []
    for bp in model.enc.blocks:
        # ls_eend._block with the retention and the conv module's conv and
        # BatchNorm across the ranks
        h = h + cfg.ff_factor * ls_eend._ff(bp.ff1, h, rate, gen)
        r = _sp_retention_chunkwise(bp.ret, ls_eend._ln(bp.ret_norm, h), rc, group)
        h = h + tnn.dropout(r, rate, gen)
        c = ls_eend._lin(bp.conv.pw1, ls_eend._ln(bp.conv.norm, h))
        a, b = c.chunk(2, dim=-1)
        c = _halo_causal_conv(bp.conv.dw.weight, a * torch.sigmoid(b), group)
        if train:
            c, st = _sp_batch_norm_train(c, bp.conv.bn, group)
        else:
            c, st = tnn.batch_norm(c, bp.conv.bn), {"mean": bp.conv.bn.running_mean,
                                                    "var": bp.conv.bn.running_var}
        h = h + tnn.dropout(ls_eend._lin(bp.conv.pw2, F.silu(c)), rate, gen)
        h = h + cfg.ff_factor * ls_eend._ff(bp.ff2, h, rate, gen)
        h = ls_eend._ln(bp.final_norm, h)
        conv_bn.append(st)
    h = torch.where(len_mask, h, zero)
    window = C.halo_exchange(h, cfg.conv_delay, group)
    emb = tnn.l2_normalize(tnn.conv1d(window, model.cnn.weight, model.cnn.bias))
    x = ls_eend._slot_queries(model, emb, n_slots)                      # (B, Tl, C, D)
    D = x.shape[-1]
    for lp in model.dec.layers:
        # ls_eend.fusion_layer (unfused) with the time retention across the ranks
        xt = x.transpose(1, 2).reshape(B * n_slots, Tl, D)
        a = _sp_retention_chunkwise(lp.time_ret, xt, rc, group)
        xt = ls_eend._ln(lp.norm11, xt + tnn.dropout(a, rate, gen))
        x = xt.reshape(B, n_slots, Tl, D).transpose(1, 2)
        a = tnn.dropout(tnn.mha(lp.spk_attn, x, x, x, rate, gen), rate, gen)
        x = ls_eend._ln(lp.norm21, x + a)
        x = ls_eend._ln(lp.norm22, x + tnn.ff_block(x, lp.linear1, lp.linear2, rate, gen))
    attractors = tnn.l2_normalize(x)
    logits = torch.einsum("btd,btcd->btc", emb.float(), attractors.float())
    return {"logits": logits, "emb": emb, "attractors": attractors,
            "state": {"conv_bn": conv_bn}}


def _make_train_step_sp(task, cfg, tx, mesh, axis: str, forward, device):
    group = _group(mesh, axis)
    n = C.axis_size(group)

    def forward_fn(model, feats, lens, n_slots, train, generator):
        # every rank computes the loss on the gathered (unpadded) frames
        out = forward(model, feats, lens, mesh, n_slots, axis, train=train, generator=generator)
        T = feats.shape[1]
        return {"logits": C.all_gather(out["logits"], group, dim=1)[:, :T],
                "emb": C.all_gather(out["emb"], group, dim=1)[:, :T], "state": out["state"]}

    def forward_backward(model, batch, gen):
        loss, (bn_state, metrics) = trainer_lib.compute_loss(
            task, ls_eend.with_cfg(model, cfg), batch, gen, train=True, forward_fn=forward_fn)
        (loss / n).backward()
        return bn_state, metrics

    return trainer_lib.optimizer_step(forward_backward, tx, device, mesh, axis)


def make_fs_train_step_sp(task, cfg, tx, mesh, axis: str = "data", device=None):
    """The FS train step (label protocol -> SP forward -> PIT and embedding
    losses -> gradients -> optimizer) with the time axis of every O(T^2) op
    sharded: step(state, batch, seed) -> (state, metrics), the batch whole
    on every rank, the metrics those of the global batch."""
    if task.model != "fs":
        raise ValueError("make_fs_train_step_sp trains FS-EEND; make_ls_train_step_sp LS-EEND")
    return _make_train_step_sp(task, cfg, tx, mesh, axis, fs_forward_sp_train, device)


def make_ls_train_step_sp(task, cfg, tx, mesh, axis: str = "data", device=None):
    """The LS train step with the time axis of every O(T)-activation op
    sharded (each rank holds T/n frames of the (B, T, C, D) slot grid);
    `make_fs_train_step_sp`'s contract.  The decoder is the unfused layer
    whatever `use_fused_dec` says."""
    if task.model != "ls":
        raise ValueError("make_ls_train_step_sp trains LS-EEND; make_fs_train_step_sp FS-EEND")
    return _make_train_step_sp(task, cfg, tx, mesh, axis, ls_forward_sp_train, device)
