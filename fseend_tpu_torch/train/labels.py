"""Label protocol: speakers ordered by first activity, plus a silence slot
and an empty "none" slot.

Port of `fseend_tpu/train/labels.py`.  Labels come in as a fixed (B, T,
S_max) block with per-sample `n_spk` and `lens`; out go (B, T, S_max + 2)
slot labels and a (B, S_max + 2) slot mask.  The model always runs S_max + 2
slots and the loss is masked per sample.
"""

from __future__ import annotations

import torch


def sort_by_first_activity(labels: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """labels (B, T, S) 0/1 -> the columns stably sorted by their first
    active frame; inactive columns go last.  Frames past `lens` are
    ignored."""
    B, T, S = labels.shape
    frame = torch.arange(1, T + 1, device=labels.device, dtype=torch.float32)[None, :, None]
    valid = torch.arange(T, device=labels.device)[None, :, None] < lens[:, None, None]
    first = torch.where((labels > 0) & valid, frame, torch.inf).amin(dim=1)    # (B, S)
    order = torch.argsort(first, dim=1, stable=True)
    return torch.gather(labels, 2, order[:, None, :].expand(B, T, S))


def add_silence_none_slots(labels: torch.Tensor) -> torch.Tensor:
    """(B, T, S) -> (B, T, S + 2): [silence, speakers..., none]."""
    silence = 1.0 - labels.amax(dim=-1, keepdim=True)
    return torch.cat([silence, labels, torch.zeros_like(silence)], dim=-1)


def prepare_labels(labels: torch.Tensor, lens: torch.Tensor, n_spk: torch.Tensor):
    """The whole protocol -> (slot_labels (B, T, S+2) float32, slot_mask
    (B, S+2) bool).  The mask marks each sample's n_spk + 2 loss columns;
    frames past `lens` are all zero, the silence slot included."""
    B, T, S = labels.shape
    slot = add_silence_none_slots(sort_by_first_activity(labels, lens))
    frame_mask = torch.arange(T, device=labels.device)[None, :] < lens[:, None]
    slot = slot * frame_mask[..., None]
    slot_mask = torch.arange(S + 2, device=labels.device)[None, :] < (n_spk[:, None] + 2)
    return slot.to(torch.float32), slot_mask


def pin_silence_none(slot_labels: torch.Tensor):
    """(silence, speakers, none) views of protocol labels: the speaker PIT
    permutes the speakers and keeps silence and none in place."""
    return slot_labels[..., :1], slot_labels[..., 1:-1], slot_labels[..., -1:]
