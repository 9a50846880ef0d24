"""Auxiliary training and inference utilities: the port's copy of
`fseend_tpu/train/aux_utils.py` (numpy only; the reference's
FS-EEND/train/utils/utils.py and LS-EEND/train/utils/utils.py).  They run
on the host between model calls:
  * the variable-chunk curriculum (split_inp / resize_chunk, utils.py:12-29)
  * the FIFO buffer (LS utils.py:175-184)
  * the enrollment-segment helpers of enrollment-conditioned fine-tuning
    (LS utils.py:14-95)
  * the instance / dataset scaler (TorchScaler, utils.py:125-237)
"""

from __future__ import annotations

import numpy as np

from fseend_tpu_torch.utils.rttm import activity_to_segments

VAR_CHUNKS = np.array([50, 100, 200, 500, 1000])


def resize_chunk(T: int, rng: np.random.Generator) -> int:
    """With p = 0.5 a random smaller chunk size (the curriculum over chunk
    lengths, utils.py:24-29)."""
    if rng.random() >= 0.5:
        return int(min(rng.choice(VAR_CHUNKS), T))
    return T


def split_inp(feats: list[np.ndarray], labels: list[np.ndarray], t_prime: int):
    """A list of (T, D) / (T, S) pairs re-chunked into t_prime-frame pieces
    (utils.py:12-21)."""
    out_f, out_l = [], []
    for f, l in zip(feats, labels):
        for st in range(0, len(f), t_prime):
            out_f.append(f[st:st + t_prime])
            out_l.append(l[st:st + t_prime])
    return out_f, out_l


def update_buffer_fifo(x_buf, x_i, y_buf, y_i, buf_size: int):
    """The most recent buf_size frames (LS utils.py:175-184)."""
    x_cat = np.concatenate([x_buf, x_i], axis=0)
    y_cat = np.concatenate([y_buf, y_i], axis=0)
    return x_cat[-buf_size:], y_cat[-buf_size:]


def find_enroll_segment(decisions: np.ndarray, utt_floor: int):
    """Each speaker's first segment of at least utt_floor frames (LS
    utils.py:62-75).  Returns (frame indices, speaker ids, count)."""
    enroll_idx, enroll_spkid = [], []
    for spkid in range(decisions.shape[1]):
        for s, e in activity_to_segments(decisions[:, spkid]):
            if e - s >= utt_floor:
                enroll_idx += list(range(s, e))
                enroll_spkid.append(spkid)
                break
    return enroll_idx, enroll_spkid, len(enroll_spkid)


def find_enroll_single_spk_frames(feats, preds, decisions, utt_floor: int):
    """An enrollment sequence: per speaker, the longest single-speaker
    stretch of at least utt_floor frames, interleaved with silence (LS
    utils.py:14-59).  decisions: (T, S + 2) with column 0 = silence."""
    single = decisions.sum(axis=1) == 1
    d_s, f_s, p_s = decisions[single], feats[single], preds[single]
    silen_x = silen_y = None
    spk_x, spk_y = [], []
    for spkid in range(d_s.shape[1]):
        segs = [(s, e) for s, e in activity_to_segments(d_s[:, spkid])
                if e - s >= utt_floor]
        if not segs:
            continue
        s, e = max(segs, key=lambda se: se[1] - se[0])
        if spkid == 0:
            silen_x, silen_y = f_s[s:e], p_s[s:e]
        else:
            spk_x.append(f_s[s:e])
            spk_y.append(p_s[s:e])
    if silen_x is None:
        raise ValueError("no silence segment >= utt_floor found")
    xs, ys = [silen_x], [silen_y]
    for x, y in zip(spk_x, spk_y):
        xs += [x, silen_x]
        ys += [y, silen_y]
    return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


def select_single_spk_frames(decisions: np.ndarray, enroll_idx: list,
                             mod_frame: int) -> list:
    """Frame indices outside the enrollment, at most mod_frame per speaker
    (LS utils.py:78-95)."""
    resi = decisions.copy()
    if enroll_idx:
        resi[np.asarray(enroll_idx)] = 0
    out: set[int] = set()
    for spkid in range(resi.shape[1]):
        idx = np.nonzero(resi[:, spkid] > 0)[0].tolist()
        out.update(idx[:mod_frame])
    return sorted(out)


class Scaler:
    """Instance or dataset-statistic normalizer (TorchScaler,
    utils.py:125-237): normtype minmax, standard or mean over the given
    axes."""

    def __init__(self, statistic: str = "instance", normtype: str = "standard",
                 dims=(0,), eps: float = 1e-8):
        if statistic not in ("instance", "dataset"):
            raise ValueError(f"statistic {statistic!r}")
        if normtype not in ("minmax", "standard", "mean"):
            raise ValueError(f"normtype {normtype!r}")
        self.statistic, self.normtype, self.dims, self.eps = (
            statistic, normtype, tuple(dims), eps)
        self.mean_ = None
        self.scale_ = None

    def fit(self, iterable):
        """Dataset statistics over an iterable of arrays."""
        acc, acc2, n = 0.0, 0.0, 0
        for x in iterable:
            acc = acc + x.sum(axis=self.dims, keepdims=True)
            acc2 = acc2 + (x ** 2).sum(axis=self.dims, keepdims=True)
            n += np.prod([x.shape[d] for d in self.dims])
        self.mean_ = acc / n
        self.scale_ = np.sqrt(np.maximum(acc2 / n - self.mean_ ** 2, 0.0))
        return self

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if self.statistic == "dataset":
            mean, std = self.mean_, self.scale_
        else:
            mean = x.mean(axis=self.dims, keepdims=True)
            std = x.std(axis=self.dims, keepdims=True)
        if self.normtype == "mean":
            return x - mean
        if self.normtype == "standard":
            return (x - mean) / (std + self.eps)
        mn = x.min(axis=self.dims, keepdims=True)
        mx = x.max(axis=self.dims, keepdims=True)
        return (x - mn) / (mx - mn + self.eps)
