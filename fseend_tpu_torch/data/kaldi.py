"""Kaldi-style data-directory reader, the port's own copy of
`fseend_tpu/data/kaldi.py` (reference F1:
FS-EEND/datasets/kaldi_data.py:17-177 and the LS extras
kaldi_data.py:109-140), without the soundfile dependency.

A data dir contains: wav.scp, segments, utt2spk, (spk2utt), (reco2dur),
(reco2num_spk), (utt2timestamp).  Piped wav.scp entries ("cmd |") and
stdin ("-") are supported like the reference.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np

from fseend_tpu_torch.ops.features import read_audio


def load_segments_rechash(path):
    if not os.path.exists(path):
        return None
    ret: dict[str, list] = {}
    for line in open(path):
        utt, rec, st, et = line.strip().split()
        ret.setdefault(rec, []).append({"utt": utt, "st": float(st), "et": float(et)})
    return ret


def load_wav_scp(path):
    lines = [line.strip().split(None, 1) for line in open(path)]
    return {x[0]: x[1] for x in lines}


def load_utt2spk(path):
    lines = [line.strip().split(None, 1) for line in open(path)]
    return {x[0]: x[1] for x in lines}


def load_spk2utt(path):
    if not os.path.exists(path):
        return None
    lines = [line.strip().split() for line in open(path)]
    return {x[0]: x[1:] for x in lines}


def load_reco2dur(path):
    if not os.path.exists(path):
        return None
    lines = [line.strip().split(None, 1) for line in open(path)]
    return {x[0]: float(x[1]) for x in lines}


def load_reco2num_spk(path):
    """LS extra (LS kaldi_data.py:109-115)."""
    if not os.path.exists(path):
        return None
    lines = [line.strip().split(None, 1) for line in open(path)]
    return {x[0]: int(x[1]) for x in lines}


def load_utt2timestamp(path):
    """LS extra (LS kaldi_data.py:131-140): {utt: [(st, et), ...]}."""
    if not os.path.exists(path):
        return None
    ret: dict[str, list] = {}
    for line in open(path):
        parts = line.strip().split()
        utt = parts[0]
        ts = [(float(parts[i]), float(parts[i + 1])) for i in range(1, len(parts) - 1, 2)]
        ret[utt] = ts
    return ret


@lru_cache(maxsize=4)
def _load_wav_full(wav_rxfilename: str):
    """Whole-file load, cached (the reference lru_caches per (file, start,
    end) with maxsize=1; caching the whole file serves sequential chunk
    access better)."""
    if wav_rxfilename.endswith("|"):
        p = subprocess.run(wav_rxfilename[:-1], shell=True, capture_output=True,
                           check=True)
        import wave

        with wave.open(io.BytesIO(p.stdout), "rb") as w:
            sr = w.getframerate()
            raw = w.readframes(w.getnframes())
            width = w.getsampwidth()
            nch = w.getnchannels()
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        else:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        if nch > 1:
            data = data.reshape(-1, nch)
        return data, sr
    if wav_rxfilename == "-":
        raise ValueError("stdin wav input is not supported in the cached path")
    return read_audio(wav_rxfilename)


def load_wav(wav_rxfilename: str, start: int = 0, end: int | None = None):
    data, sr = _load_wav_full(wav_rxfilename)
    return data[start:end], sr


class KaldiData:
    """Mirror of the reference KaldiData (kaldi_data.py:153-172)."""

    def __init__(self, data_dir: str | Path):
        self.data_dir = str(data_dir)
        j = lambda f: os.path.join(self.data_dir, f)
        self.segments = load_segments_rechash(j("segments"))
        self.utt2spk = load_utt2spk(j("utt2spk"))
        self.wavs = load_wav_scp(j("wav.scp"))
        self.reco2dur = load_reco2dur(j("reco2dur"))
        self.spk2utt = load_spk2utt(j("spk2utt"))
        self.reco2num_spk = load_reco2num_spk(j("reco2num_spk"))

    def load_wav(self, recid: str, start: int = 0, end: int | None = None):
        return load_wav(self.wavs[recid], start, end)

    def rec_duration_frames(self, rec: str, frame_shift: int, rate: int) -> int:
        if self.reco2dur is not None and rec in self.reco2dur:
            return int(self.reco2dur[rec] * rate / frame_shift)
        data, sr = self.load_wav(rec)
        return int(len(data) / frame_shift)
