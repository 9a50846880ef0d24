"""RTTM writing and reading: the port's copy of `fseend_tpu/utils/rttm.py`
(numpy and scipy only; the reference's FS-EEND/train/utils/make_rttm.py:10-28).
The text it writes is the JAX package's byte for byte."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.signal import medfilt


def activity_to_segments(activity: np.ndarray) -> list[tuple[int, int]]:
    """0/1 vector -> [(start_frame, end_frame)) run-length segments."""
    padded = np.pad(activity.astype(np.int8), (1, 1))
    changes = np.where(np.diff(padded) != 0)[0]
    return list(zip(changes[::2], changes[1::2]))


def pred_to_segments(pred: np.ndarray, threshold: float = 0.5,
                     median: int = 11) -> dict[int, list[tuple[int, int]]]:
    """(T, S) probabilities -> per-speaker frame segments after the threshold
    and a median filter over time (make_rttm.py:14-18)."""
    binary = np.where(pred > threshold, 1, 0)
    if median > 1:
        binary = medfilt(binary, (median, 1))
    return {s: activity_to_segments(binary[:, s]) for s in range(binary.shape[1])}


def make_rttm(rec: str, pred: np.ndarray, frame_shift: int = 80,
              subsampling: int = 10, sampling_rate: int = 8000,
              threshold: float = 0.5, median: int = 11,
              out_rttm_file: str | Path | None = None) -> str:
    """(T, S) sigmoid probabilities -> RTTM text, appended to
    `out_rttm_file` when one is given.  Frame t starts at
    t * frame_shift * subsampling / sampling_rate seconds."""
    scale = frame_shift * subsampling / sampling_rate
    lines = []
    for spk, segs in pred_to_segments(pred, threshold, median).items():
        for st, ed in segs:
            lines.append(
                f"SPEAKER {rec} 1 {st * scale:7.2f} {(ed - st) * scale:7.2f} "
                f"<NA> <NA> {rec}_{spk} <NA>")
    text = "\n".join(lines) + ("\n" if lines else "")
    if out_rttm_file is not None:
        Path(out_rttm_file).parent.mkdir(parents=True, exist_ok=True)
        with open(out_rttm_file, "a") as f:
            f.write(text)
    return text


def read_rttm(path: str | Path) -> dict[str, list[tuple[str, float, float]]]:
    """RTTM -> {rec: [(speaker, start_sec, end_sec)]}."""
    out: dict[str, list] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            rec, st, dur, spk = parts[1], float(parts[3]), float(parts[4]), parts[7]
            out.setdefault(rec, []).append((spk, st, st + dur))
    return out
