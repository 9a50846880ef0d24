"""Diarization losses and frame-level DER counters on fixed-shape batches.

Port of `fseend_tpu/train/losses.py`.  Batches are padded tensors with
frame and slot masks:

  * `standard_bce_loss`, `standard_mask_loss`, `standard_loss_sep`
  * `batch_pit_loss`: the rolled-cost PIT with the permutation table and
    per-sample speaker-count masking, on the device
  * `hungarian_pit_permute`: the logsigmoid cost built on the device, the
    assignment solved on the host (scipy), no gradient through it
  * `emb_consistency_loss` (plain and masked) and `emb_consistency_loss_ls`
  * `attractor_existence_loss` (EEND-EDA)
  * `diarization_error_counters`, `der_from_counters`

All functions take logits (pre-sigmoid) unless noted.  Inside
`parallel/collectives.py:data_parallel` every loss divides its local
numerator by a count summed over the ranks (no gradient through it), as
the JAX package's one program over the global batch does; the ranks' losses
then add up to the global batch's loss.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from fseend_tpu_torch.parallel import collectives as C


def bce_with_logits(logits, targets):
    """Elementwise binary cross entropy on logits (stable form)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _delay_shift(logits, labels, label_delay: int):
    """pred[t] scored against label[t - delay]."""
    if label_delay:
        logits = logits[:, label_delay:]
        labels = labels[:, : labels.shape[1] - label_delay]
    return logits, labels


def _frame_mask(lens, T: int, label_delay: int, dtype):
    t = torch.arange(T, device=lens.device)[None]
    return (t < (lens[:, None] - label_delay)).to(dtype)


def _masked_per_sample_mean(cell, frame_mask, slot_mask):
    m = frame_mask[:, :, None] * slot_mask[:, None, :].to(cell.dtype)
    return (cell * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp(min=1)


def _combine(per_sample_mean, lens, label_delay: int):
    """sum_b mean_b (T_b - delay) / sum_b (T_b - delay)."""
    w = (lens - label_delay).clamp(min=0).to(per_sample_mean.dtype)
    return (per_sample_mean * w).sum() / C.batch_sum(w.sum()).clamp(min=1)


def standard_bce_loss(logits, labels, lens, slot_mask, label_delay: int = 0):
    """logits, labels (B, T, S); lens (B,); slot_mask (B, S)."""
    logits, labels = _delay_shift(logits, labels, label_delay)
    fm = _frame_mask(lens, logits.shape[1], label_delay, logits.dtype)
    cell = bce_with_logits(logits, labels)
    return _combine(_masked_per_sample_mean(cell, fm, slot_mask), lens, label_delay)


def standard_mask_loss(logits, labels, lens, slot_mask, label_delay: int = 0):
    """BCE with the cells where label == 0 and logit < 0 zeroed."""
    logits, labels = _delay_shift(logits, labels, label_delay)
    fm = _frame_mask(lens, logits.shape[1], label_delay, logits.dtype)
    cell = bce_with_logits(logits, labels)
    cell = torch.where((labels == 0) & (logits < 0), 0.0, cell)
    return _combine(_masked_per_sample_mean(cell, fm, slot_mask), lens, label_delay)


def standard_loss_sep(logits, labels, lens, slot_mask, label_delay: int = 0):
    """Asymmetric loss: BCE with logits on active cells, -log(1 - |logit|)
    (|logit| clipped below 1) on inactive ones."""
    logits, labels = _delay_shift(logits, labels, label_delay)
    fm = _frame_mask(lens, logits.shape[1], label_delay, logits.dtype)
    active = bce_with_logits(logits, labels)
    inactive = -torch.log1p(-logits.abs().clamp(0.0, 1.0 - 1e-7))
    cell = torch.where(labels == 1, active, inactive)
    return _combine(_masked_per_sample_mean(cell, fm, slot_mask), lens, label_delay)


# ---------------------------------------------------------------------------
# rolled-cost PIT (static permutation table)
# ---------------------------------------------------------------------------


def _perm_table(S: int, device):
    perms = np.array(list(itertools.permutations(range(S))), dtype=np.int64)
    t_inds = np.mod(perms - np.arange(S), S)        # (P, S): roll of each output column
    valid = np.zeros((S + 1, len(perms)), dtype=bool)
    for n in range(S + 1):                          # perm p's first n entries permute range(n)
        valid[n] = [sorted(p[:n]) == list(range(n)) for p in perms]
    return (torch.as_tensor(perms, device=device), torch.as_tensor(t_inds, device=device),
            torch.as_tensor(valid, device=device))


def batch_pit_loss(logits, labels, lens, n_speakers, label_delay: int = 0,
                   from_logits: bool = True):
    """PIT over the speaker columns with an O(S^2) cost and the S! table,
    invalid permutations (past each sample's speaker count) masked.
    from_logits=False scores probabilities.  Returns (loss, labels permuted
    (B, T, S), the permutation (B, S))."""
    B, T, S = logits.shape
    perms, t_inds, valid = _perm_table(S, logits.device)
    logits_d, labels_d = _delay_shift(logits, labels, label_delay)
    fm = _frame_mask(lens, logits_d.shape[1], label_delay, logits.dtype)
    # cost[b, i, j] = summed BCE of logit column i against label column (i + j) % S
    rolled = torch.stack([torch.roll(labels_d, -j, dims=2) for j in range(S)], dim=3)
    if from_logits:
        cell = bce_with_logits(logits_d[..., None], rolled)
    else:
        p = logits_d[..., None].clamp(1e-7, 1 - 1e-7)
        cell = -(rolled * torch.log(p) + (1 - rolled) * torch.log1p(-p))
    costs = (cell * fm[:, :, None, None]).sum(dim=1)                   # (B, S, S)
    idx = t_inds[None].expand(B, -1, -1)                               # (B, P, S)
    per = torch.gather(costs[:, None].expand(B, len(perms), S, S), 3,
                       idx[..., None])[..., 0].mean(dim=2)             # (B, P)
    per = torch.where(~valid[n_speakers.long()], torch.inf, per)
    best = per.argmin(dim=1)
    loss = (per.gather(1, best[:, None]).sum()
            / C.batch_sum((lens - label_delay).sum()).clamp(min=1))
    perm = perms[best]
    return loss, torch.gather(labels, 2, perm[:, None, :].expand(B, T, S)), perm


# ---------------------------------------------------------------------------
# Hungarian PIT (assignment on the host)
# ---------------------------------------------------------------------------


def _hungarian_host(cost: np.ndarray, n_speakers: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment

    B, S, _ = cost.shape
    out = np.zeros((B, S), dtype=np.int64)
    for i in range(B):
        c = cost[i].copy()
        n = int(n_speakers[i])
        if n < S:
            big = np.abs(c).sum()
            c[n:, :] = big
            c[:, n:] = big
        out[i] = linear_sum_assignment(c)[1]
    return out


@torch.no_grad()
def hungarian_pit_permute(logits, labels, lens, n_speakers):
    """Labels permuted to best match the logits' columns: the logsigmoid
    cost matrix on the device, the assignment on the host.  Returns
    (labels permuted, the assignment (B, S))."""
    B, T, S = logits.shape
    fm = (torch.arange(T, device=logits.device)[None] < lens[:, None]).to(logits.dtype)
    lg = logits * fm[..., None]
    lb = labels * fm[..., None]
    cost = (-torch.einsum("bts,btc->bsc", F.logsigmoid(lg), lb)
            - torch.einsum("bts,btc->bsc", F.logsigmoid(-lg), (1 - lb) * fm[..., None]))
    ref = torch.as_tensor(_hungarian_host(cost.cpu().numpy(), n_speakers.cpu().numpy()),
                          device=labels.device)
    return torch.gather(labels, 2, ref[:, None, :].expand(B, T, S)), ref


# ---------------------------------------------------------------------------
# embedding-consistency loss
# ---------------------------------------------------------------------------


def _cos_map(x, eps: float = 1e-6):
    """Cosine-similarity map (B, T, T); a zero row has norm 0 and gradient
    0 (no NaN from the square root at 0)."""
    m = x @ x.transpose(1, 2)
    sq = x.square().sum(-1)
    pos = sq > 0
    n = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    return m / (n[:, :, None] * n[:, None, :] + eps)


def emb_consistency_loss(emb, slot_labels, lens=None, masked: bool = False):
    """MSE between the embeddings' cosine map and the labels' co-activity
    map: over the whole (B, T, T) map, or (masked) over valid frame pairs
    normalized by sum(len_b^2)."""
    attn_map = _cos_map(emb)
    label_map = _cos_map(slot_labels)
    if not masked:
        return C.batch_mean((attn_map - label_map).square())
    fm = (torch.arange(emb.shape[1], device=emb.device)[None] < lens[:, None]).to(emb.dtype)
    pair = fm[:, :, None] * fm[:, None, :]
    sq = (attn_map - label_map).square() * pair
    return sq.sum() / C.batch_sum(lens.to(emb.dtype).square().sum()).clamp(min=1)


def emb_consistency_loss_ls(emb, slot_labels, lens):
    """LS form: the embeddings are zeroed past each length before the map,
    then the summed squared error over the whole map / sum(len_b^2)."""
    fm = (torch.arange(emb.shape[1], device=emb.device)[None] < lens[:, None]).to(emb.dtype)
    sq = (_cos_map(emb * fm[..., None]) - _cos_map(slot_labels)).square()
    return sq.sum() / C.batch_sum(lens.to(emb.dtype).square().sum()).clamp(min=1)


# ---------------------------------------------------------------------------
# attractor existence loss (EEND-EDA)
# ---------------------------------------------------------------------------


def attractor_existence_loss(exist_logits, n_speakers):
    """exist_logits (B, C) from the EDA counter: BCE over each sample's
    first n_spk + 1 attractors, labels 1 for the first n_spk and 0 for
    attractor n_spk, the rest ignored (the reference's
    offl_tfm_enc_lstm_enc_dec.py:109-127)."""
    idx = torch.arange(exist_logits.shape[1], device=exist_logits.device)[None, :]
    n = n_speakers.to(exist_logits.device)[:, None]
    labels = (idx < n).to(exist_logits.dtype)
    mask = (idx <= n).to(exist_logits.dtype)
    cell = bce_with_logits(exist_logits, labels) * mask
    return cell.sum() / C.batch_sum(mask.sum()).clamp(min=1)


# ---------------------------------------------------------------------------
# frame-level DER counters
# ---------------------------------------------------------------------------


@torch.no_grad()
def diarization_error_counters(logits, labels, lens, slot_mask, label_delay: int = 0,
                               from_logits: bool = True) -> dict:
    """Scalar counters of a batch (sum them across steps)."""
    logits, labels = _delay_shift(logits, labels, label_delay)
    T = logits.shape[1]
    fm = torch.arange(T, device=lens.device)[None] < (lens[:, None] - label_delay)
    sm = slot_mask[:, None, :]
    probs = torch.sigmoid(logits) if from_logits else logits
    decisions = (probs > 0.5) & sm & fm[..., None]
    labels_b = (labels > 0.5) & sm & fm[..., None]
    n_ref = labels_b.sum(-1)
    n_sys = decisions.sum(-1)
    fm_i = fm.long()
    res = {
        "speech_scored": ((n_ref > 0) & fm).sum(),
        "speech_miss": ((n_ref > 0) & (n_sys == 0) & fm).sum(),
        "speech_falarm": ((n_ref == 0) & (n_sys > 0) & fm).sum(),
        "speaker_scored": (n_ref * fm_i).sum(),
        "speaker_miss": ((n_ref - n_sys).clamp(min=0) * fm_i).sum(),
        "speaker_falarm": ((n_sys - n_ref).clamp(min=0) * fm_i).sum(),
    }
    n_map = (labels_b & decisions).sum(-1)
    res["speaker_error"] = ((torch.minimum(n_ref, n_sys) - n_map) * fm_i).sum()
    res["correct"] = ((labels_b == decisions).all(-1) & fm).sum()
    res["diarization_error"] = res["speaker_miss"] + res["speaker_falarm"] + res["speaker_error"]
    res["frames"] = fm.sum()
    return res


def der_from_counters(c: dict):
    scored = c["speaker_scored"]
    return c["diarization_error"] / (scored.clamp(min=1) if torch.is_tensor(scored)
                                     else max(scored, 1))
