"""Chunked diarization datasets (reference F3/F4/L8), the port's own copy
of `fseend_tpu/data/dataset.py` (numpy): items are (feats (T, F), labels
(T, S), recording id), the form `train/loop.py:run_training` batches.

Differences from the reference (by design, SURVEY.md §7):
  * no torch Dataset/DataLoader — plain python objects + a thread-prefetch
    batcher (data/loader.py); features are computed on host in numpy;
  * batches are FIXED SHAPE: (B, chunk, F) features, (B, chunk, S_max)
    labels, plus lens/n_spk vectors — no ragged lists, no recompiles;
  * the on-the-fly variant draws a per-(epoch, item) seeded random chunk
    start exactly like LS (diarization_dataset_on_the_fly.py:87-105).
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from fseend_tpu_torch.data.kaldi import KaldiData
from fseend_tpu_torch.ops import features as F


@dataclasses.dataclass
class FeatureConfig:
    frame_size: int = 200
    frame_shift: int = 80
    context_size: int = 7
    subsampling: int = 10
    rate: int = 8000
    input_transform: str = "logmel23_mn"

    @property
    def input_dim(self) -> int:
        return F.get_input_dim(self.frame_size, self.context_size,
                               self.input_transform)


def count_chunks(data_length: int, size: int, step: int,
                 use_last_samples: bool, label_delay: int = 0):
    """reference _gen_frame_indices (diarization_dataset.py:18-28)."""
    out = []
    i = -1
    for i in range(int((data_length - size + step) / step)):
        out.append((i * step, i * step + size))
    if use_last_samples and i * step + size < data_length:
        if data_length - (i + 1) * step - label_delay > 0:
            out.append(((i + 1) * step, data_length))
    return out


def get_labeled_stft(kaldi: KaldiData, rec: str, start: int, end: int,
                     frame_size: int, frame_shift: int,
                     n_speakers: int | None = None):
    """STFT + frame-aligned 0/1 labels (reference get_labeledSTFT,
    feature.py:225-287). start/end in (unsubsampled) frames."""
    data, rate = kaldi.load_wav(rec, start * frame_shift, end * frame_shift)
    if data.ndim > 1:
        data = data[:, 0]
    Y = F.stft(data, frame_size, frame_shift)
    segments = kaldi.segments[rec]
    speakers = np.unique([kaldi.utt2spk[seg["utt"]] for seg in segments]).tolist()
    if n_speakers is None:
        n_speakers = len(speakers)
    T = np.zeros((Y.shape[0], n_speakers), dtype=np.int32)
    for seg in segments:
        si = speakers.index(kaldi.utt2spk[seg["utt"]])
        sf = int(np.rint(seg["st"] * rate / frame_shift))
        ef = int(np.rint(seg["et"] * rate / frame_shift))
        rel_start = rel_end = None
        if start <= sf < end:
            rel_start = sf - start
        if start < ef <= end:
            rel_end = ef - start
        if rel_start is not None or rel_end is not None:
            T[rel_start:rel_end, si] = 1
    return Y, T


class DiarizationDataset:
    """Map-style chunked dataset (reference KaldiDiarizationDataset,
    diarization_dataset.py:36-127)."""

    def __init__(self, data_dir: str, feat: FeatureConfig, chunk_size: int = 500,
                 chunk_step: int | None = None, use_last_samples: bool = True,
                 label_delay: int = 0, n_speakers: int | None = None):
        self.feat = feat
        self.chunk_size = chunk_size
        self.chunk_step = chunk_step or chunk_size
        self.n_speakers = n_speakers
        self.data = KaldiData(data_dir)
        self.chunk_indices: list[tuple[str, int, int]] = []
        for rec in self.data.wavs:
            data_len = self.data.rec_duration_frames(rec, feat.frame_shift, feat.rate)
            data_len = int(data_len / feat.subsampling)
            for st, ed in count_chunks(data_len, chunk_size, self.chunk_step,
                                       use_last_samples, label_delay):
                self.chunk_indices.append(
                    (rec, st * feat.subsampling, ed * feat.subsampling))

    def __len__(self):
        return len(self.chunk_indices)

    def _extract(self, rec, st, ed):
        Y, T = get_labeled_stft(self.data, rec, st, ed, self.feat.frame_size,
                                self.feat.frame_shift, self.n_speakers)
        Y = F.transform(Y, self.feat.input_transform)
        Y = F.splice(Y, self.feat.context_size)
        Y, T = F.subsample(Y, T, self.feat.subsampling)
        return np.ascontiguousarray(Y, np.float32), np.ascontiguousarray(T, np.float32)

    def __getitem__(self, i):
        rec, st, ed = self.chunk_indices[i]
        Y, T = self._extract(rec, st, ed)
        return Y, T, rec

    def full_labels(self, i):
        """Unsubsampled labels for the whole chunk (scoring path,
        diarization_dataset.py:109-127)."""
        rec, st, ed = self.chunk_indices[i]
        _, T = get_labeled_stft(self.data, rec, st, ed, self.feat.frame_size,
                                self.feat.frame_shift, self.n_speakers)
        return T, rec


class OnTheFlyDiarizationDataset(DiarizationDataset):
    """LS on-the-fly variant: items are (index, seed); each epoch draws a new
    random chunk start per recording (LS diarization_dataset_on_the_fly.py:87-105)."""

    def __init__(self, data_dir: str, feat: FeatureConfig, chunk_size: int = 1000,
                 chunk_step: int | None = None, use_last_samples: bool = True,
                 label_delay: int = 0, n_speakers: int | None = None):
        super().__init__(data_dir, feat, chunk_size, chunk_step, use_last_samples,
                         label_delay, n_speakers)
        # one item per (rec, nominal chunk); the random draw replaces st
        self._rec_len = {
            rec: int(self.data.rec_duration_frames(rec, feat.frame_shift, feat.rate)
                     / feat.subsampling)
            for rec in self.data.wavs
        }

    def get(self, i: int, seed: int):
        rec, st, ed = self.chunk_indices[i]
        length = (ed - st) // self.feat.subsampling
        data_len = self._rec_len[rec]
        if data_len > length:
            rng = np.random.Generator(np.random.PCG64(seed))
            st_ss = int(rng.integers(0, data_len - length + 1))
            st = st_ss * self.feat.subsampling
            ed = st + length * self.feat.subsampling
        Y, T = self._extract(rec, st, ed)
        return Y, T, rec

    def __getitem__(self, item):
        if isinstance(item, tuple):
            return self.get(*item)
        return super().__getitem__(item)


class PredictDataset:
    """wav-glob dataset for label-free inference (reference F4,
    diarization_dataset_predict.py)."""

    def __init__(self, wav_dir: str, feat: FeatureConfig):
        self.feat = feat
        # wav via the stdlib wave module, flac via the native decoder
        # (data/flac.py) — the same two formats the reference globs
        # (diarization_dataset_predict.py:66)
        self.wavs = sorted(glob.glob(os.path.join(wav_dir, "*.wav"))
                           + glob.glob(os.path.join(wav_dir, "*.flac")))

    def __len__(self):
        return len(self.wavs)

    def __getitem__(self, i):
        path = self.wavs[i]
        feats = F.extract_fbank(
            path, context_size=self.feat.context_size,
            frame_size=self.feat.frame_size, frame_shift=self.feat.frame_shift,
            input_transform=self.feat.input_transform,
            subsampling=self.feat.subsampling)
        rec = os.path.splitext(os.path.basename(path))[0]
        return feats, rec
