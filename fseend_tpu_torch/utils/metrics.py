"""Diarization error rate with a collar: the port's copy of
`fseend_tpu/utils/metrics.py` (numpy and scipy only), a self-contained
NIST-style scorer in place of the reference's pyannote
(FS-EEND/metrics.py:70-103, LS-EEND/metrics.py:107).

Definition (pyannote's DiarizationErrorRate):
  * a collar of ``collar/2`` time units around every REFERENCE segment
    boundary is removed; scoring covers the rest;
  * reference and hypothesis speakers are matched by the Hungarian
    algorithm, maximizing the total overlap (the optimal mapping);
  * DER = (miss + false alarm + confusion) / total reference speech,
    summed over elementary intervals where miss = max(0, Nref - Nhyp),
    fa = max(0, Nhyp - Nref), conf = min(Nref, Nhyp) - Ncorrect.

Annotations are lists of (speaker, start, end) in any one time unit; the
reference scores in 100 Hz frames with collar=50 (250 ms).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.optimize import linear_sum_assignment

from fseend_tpu_torch.utils.rttm import activity_to_segments, pred_to_segments

Turn = tuple[str, float, float]


@dataclasses.dataclass
class DERComponents:
    total: float = 0.0
    miss: float = 0.0
    falarm: float = 0.0
    confusion: float = 0.0

    @property
    def der(self) -> float:
        return ((self.miss + self.falarm + self.confusion) / self.total
                if self.total > 0 else 0.0)

    def __iadd__(self, other: "DERComponents"):
        self.total += other.total
        self.miss += other.miss
        self.falarm += other.falarm
        self.confusion += other.confusion
        return self


def _collar_support(reference: list[Turn], collar: float):
    """Intervals to EXCLUDE: [b - collar/2, b + collar/2] around every
    reference boundary, merged."""
    if collar <= 0:
        return []
    points = sorted({t for _, s, e in reference for t in (s, e)})
    half = collar / 2.0
    merged: list[list[float]] = []
    for b in points:
        lo, hi = b - half, b + half
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def _crop(turns: list[Turn], excluded) -> list[Turn]:
    """Remove the excluded intervals from every turn."""
    out = []
    for spk, s, e in turns:
        pieces = [(s, e)]
        for lo, hi in excluded:
            nxt = []
            for ps, pe in pieces:
                if hi <= ps or lo >= pe:
                    nxt.append((ps, pe))
                    continue
                if ps < lo:
                    nxt.append((ps, lo))
                if hi < pe:
                    nxt.append((hi, pe))
            pieces = nxt
            if not pieces:
                break
        out.extend((spk, ps, pe) for ps, pe in pieces if pe > ps)
    return out


def _overlap_matrix(ref: list[Turn], hyp: list[Turn]):
    rspk = sorted({s for s, *_ in ref})
    hspk = sorted({s for s, *_ in hyp})
    M = np.zeros((len(rspk), len(hspk)))
    for i, rs in enumerate(rspk):
        rsegs = [(s, e) for spk, s, e in ref if spk == rs]
        for j, hs in enumerate(hspk):
            hsegs = [(s, e) for spk, s, e in hyp if spk == hs]
            M[i, j] = sum(max(0.0, min(re, he) - max(rb, hb))
                          for rb, re in rsegs for hb, he in hsegs)
    return rspk, hspk, M


def optimal_mapping(ref: list[Turn], hyp: list[Turn]) -> dict[str, str]:
    """Hungarian assignment of hypothesis speakers to reference speakers
    maximizing the total overlap."""
    rspk, hspk, M = _overlap_matrix(ref, hyp)
    if not rspk or not hspk:
        return {}
    ri, hi = linear_sum_assignment(-M)
    return {hspk[j]: rspk[i] for i, j in zip(ri, hi) if M[i, j] > 0}


def der_components(reference: list[Turn], hypothesis: list[Turn],
                   collar: float = 0.0) -> DERComponents:
    excluded = _collar_support(reference, collar)
    ref = _crop(reference, excluded)
    hyp = _crop(hypothesis, excluded)
    mapping = optimal_mapping(ref, hyp)

    bounds = sorted({t for _, s, e in ref + hyp for t in (s, e)})
    out = DERComponents()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        dur = hi - lo
        if dur <= 0:
            continue
        mid = (lo + hi) / 2.0
        r_active = [spk for spk, s, e in ref if s <= mid < e]
        h_active = [spk for spk, s, e in hyp if s <= mid < e]
        n_ref, n_hyp = len(r_active), len(h_active)
        # each matched reference speaker counts once
        matched_refs = {mapping.get(h) for h in h_active if mapping.get(h) in r_active}
        correct = len(matched_refs)
        out.total += n_ref * dur
        out.miss += max(0, n_ref - n_hyp) * dur
        out.falarm += max(0, n_hyp - n_ref) * dur
        out.confusion += (min(n_ref, n_hyp) - correct) * dur
    return out


def score_frames(ref_frames: np.ndarray, hyp_prob: np.ndarray, *,
                 threshold: float = 0.5, median: int = 11,
                 collar_frames: float = 50.0, subsampling: int = 10) -> DERComponents:
    """The reference's protocol (metrics.py:35-77): reference labels at
    100 Hz frames, the hypothesis at the subsampled rate, both as
    frame-unit turns; threshold and median filter on the hypothesis, the
    collar in 100 Hz frames."""
    ref_turns: list[Turn] = []
    for spk in range(ref_frames.shape[1]):
        for s, e in activity_to_segments(ref_frames[:, spk]):
            ref_turns.append((f"r{spk}", float(s), float(e)))
    hyp_turns: list[Turn] = []
    for spk, segs in pred_to_segments(hyp_prob, threshold, median).items():
        for s, e in segs:
            hyp_turns.append((f"h{spk}", float(s * subsampling), float(e * subsampling)))
    return der_components(ref_turns, hyp_turns, collar=collar_frames)
