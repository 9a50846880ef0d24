"""Host-side feature DSP, implemented natively (no librosa/soundfile deps).

The port's own copy of `fseend_tpu/ops/features.py` (numpy and scipy, no
JAX): the same arrays, bit for bit, on the same audio.  Numerically mirrors the reference feature pipeline
(FS-EEND/datasets/feature.py:26-368 and
LS-EEND/datasets/feature.py:26-90) including its quirks:

  * STFT uses librosa conventions: hann window of ``win_length`` zero-padded
    centered to ``n_fft`` (next pow2 of win_length), ``center=True`` with
    constant (zero) padding, and the "last frame omitted" hack when
    ``len(data) % hop == 0`` (reference feature.py:152-161).
  * mel filterbank is the librosa/slaney bank (slaney mel scale + slaney
    area-normalization), sr=8000, n_mels=23 for the ``logmel23*`` family.
  * ``logmel23_mn``: per-recording mean subtraction; ``logmel23_mvn``: mean+var;
    ``logmel23_swn``: 2-means-threshold speech-weighted mean (feature.py:70-86);
    ``logmel23_cummn``: causal cumulative mean (LS feature.py:80-90) — the
    streaming-safe norm used by LS-EEND.
  * splicing stacks +/- context frames (zero padded), subsampling takes
    every ``subsampling``-th frame.

Everything here is numpy on the host: the training datasets featurize with
it, and it is what the device front end (`ops/features_tpu.py`) is held to.
"""

from __future__ import annotations

import functools
import wave
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# audio IO (replaces soundfile.read with stdlib/scipy + a native FLAC codec)
# ---------------------------------------------------------------------------


def read_audio(path: str | Path, start: int = 0, stop: int | None = None):
    """Decode .wav (PCM) or .flac by extension — the formats the reference's
    predict dataset globs (diarization_dataset_predict.py:66, soundfile)."""
    if str(path).lower().endswith(".flac"):
        from fseend_tpu_torch.data.flac import read_flac

        return read_flac(path, start, stop)
    return read_wav(path, start, stop)


def read_wav(path: str | Path, start: int = 0, stop: int | None = None):
    """Read a (mono or multichannel) PCM wav file as float32 in [-1, 1).

    Matches ``soundfile.read(path, dtype='float32')`` scaling for PCM16/PCM32.
    Returns ``(data, sample_rate)`` with ``data`` shaped (n_samples,) for mono
    or (n_samples, n_channels) otherwise.
    """
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        n_frames = w.getnframes()
        if stop is None:
            stop = n_frames
        stop = min(stop, n_frames)
        start = min(start, stop)
        w.setpos(start)
        raw = w.readframes(stop - start)
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:  # 8-bit unsigned PCM
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width: {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return data, sr


# ---------------------------------------------------------------------------
# STFT (librosa conventions, pure numpy)
# ---------------------------------------------------------------------------


def _hann(M: int) -> np.ndarray:
    """Periodic ("fftbins") hann window, == scipy.signal.get_window('hann', M)."""
    if M <= 0:
        return np.zeros(0)
    n = np.arange(M)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / M)


@functools.lru_cache(maxsize=8)
def _stft_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann(win_length) zero-padded centered to n_fft (librosa util.pad_center)."""
    win = _hann(win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(win, (lpad, n_fft - win_length - lpad))


def stft(data: np.ndarray, frame_size: int = 200, frame_shift: int = 80) -> np.ndarray:
    """STFT frames, (n_frames, n_fft//2+1) complex64.

    Mirrors reference stft() (FS-EEND/datasets/feature.py:136-161):
    fft_size = next pow2 of frame_size; librosa.stft(center=True,
    pad_mode='constant'); transposed to (frames, bins); final frame dropped
    when ``len(data) % frame_shift == 0``.
    """
    n_fft = 1 << (int(frame_size) - 1).bit_length()
    x = np.asarray(data)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float32)
    # librosa computes in the input's precision (float32 wavs -> complex64);
    # following it is both a parity point and ~2x faster on the host
    window = _stft_window(frame_size, n_fft).astype(x.dtype)
    # center=True constant padding
    x = np.pad(x, (n_fft // 2, n_fft // 2))
    n_frames = 1 + (len(x) - n_fft) // frame_shift
    # frame with stride tricks: (n_frames, n_fft)
    frames = np.lib.stride_tricks.as_strided(
        x,
        shape=(n_frames, n_fft),
        strides=(x.strides[0] * frame_shift, x.strides[0]),
        writeable=False,
    )
    import scipy.fft

    # scipy.fft computes float32 natively (numpy upcasts to float64)
    out_dtype = np.complex64 if x.dtype == np.float32 else np.complex128
    spec = scipy.fft.rfft(frames * window, axis=-1).astype(out_dtype)
    if len(data) % frame_shift == 0:
        # reference drops librosa's "excessive" final frame in this case
        spec = spec[:-1]
    return spec


# ---------------------------------------------------------------------------
# mel filterbank (librosa slaney conventions, pure numpy)
# ---------------------------------------------------------------------------


def _hz_to_mel_slaney(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, 1+n_fft//2) slaney-normalized triangular mel bank.

    Equivalent to librosa.filters.mel(sr=sr, n_fft=n_fft, n_mels=n_mels)
    with defaults fmin=0, fmax=sr/2, htk=False, norm='slaney'
    (referenced at FS-EEND/datasets/feature.py:58).
    """
    fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min = _hz_to_mel_slaney(0.0)
    mel_max = _hz_to_mel_slaney(fmax)
    mel_f = _mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney area normalization
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    # librosa computes the bank in float64 and returns float32
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# spectral transforms (reference transform(), feature.py:26-100 + LS :80-90)
# ---------------------------------------------------------------------------


def _logmel(Y_abs: np.ndarray, sr: int, n_mels: int) -> np.ndarray:
    n_fft = 2 * (Y_abs.shape[1] - 1)
    mel = mel_filterbank(sr, n_fft, n_mels)
    out = np.dot(Y_abs ** 2, mel.T)  # f32 like the reference
    return np.log10(np.maximum(out, 1e-10))


def transform(Y: np.ndarray, transform_type: str | None = None, dtype=np.float32) -> np.ndarray:
    """Transform complex STFT (n_frames, n_bins) to features.

    Supports the reference's full family: None, 'log', 'logmel' (16 kHz/40),
    'logmel23', 'logmel23_mn', 'logmel23_swn', 'logmel23_mvn', and the LS
    addition 'logmel23_cummn'.
    """
    Y = np.abs(Y)
    if not transform_type:
        out = Y
    elif transform_type == "log":
        out = np.log(np.maximum(Y, 1e-10))
    elif transform_type == "logmel":
        out = _logmel(Y, sr=16000, n_mels=40)
    elif transform_type == "logmel23":
        out = _logmel(Y, sr=8000, n_mels=23)
    elif transform_type == "logmel23_mn":
        out = _logmel(Y, sr=8000, n_mels=23)
        out = out - np.mean(out, axis=0)
    elif transform_type == "logmel23_swn":
        out = _logmel(Y, sr=8000, n_mels=23)
        out = out - speech_weighted_mean(out)
    elif transform_type == "logmel23_mvn":
        out = _logmel(Y, sr=8000, n_mels=23)
        out = out - np.mean(out, axis=0)
        out = out / np.maximum(np.std(out, axis=0), 1e-10)
    elif transform_type == "logmel23_cummn":
        out = _logmel(Y, sr=8000, n_mels=23)
        out = out - cumulative_mean(out)
    else:
        raise ValueError(f"Unknown transform_type: {transform_type}")
    return out.astype(dtype)


def speech_weighted_mean(Y: np.ndarray, n_iters: int = 10) -> np.ndarray:
    """2-means-threshold frame mean over "speech" frames (feature.py:80-86)."""
    powers = np.sum(Y, axis=1)
    th = (np.max(powers) + np.min(powers)) / 2.0
    for _ in range(n_iters):
        hi = powers[powers >= th]
        lo = powers[powers < th]
        # reference relies on both sets being non-empty; guard NaN identically
        th = ((hi.mean() if hi.size else th) + (lo.mean() if lo.size else th)) / 2
    return np.mean(Y[powers > th, :], axis=0)


def cumulative_mean(Y: np.ndarray) -> np.ndarray:
    """Causal per-recording cumulative mean, frame t uses frames [0, t]
    (LS-EEND/datasets/feature.py:80-90). Streaming-compatible."""
    csum = np.cumsum(Y, axis=0)
    counts = np.arange(1, Y.shape[0] + 1, dtype=Y.dtype)[:, None]
    return csum / counts


def forgetting_mean(Y: np.ndarray, window: int = 250) -> np.ndarray:
    """Exponential-forgetting mean (LS-EEND/datasets/feature.py:26-43),
    available-but-unused in the reference transform; provided for parity."""
    from scipy.signal import lfilter

    alpha = (window - 1.0) / (window + 1.0)
    # acc_t = a*acc_{t-1} + (1-a)*Y_t as an IIR filter; norm_t = 1 - a^{t+1}
    acc = lfilter([1.0 - alpha], [1.0, -alpha], Y.astype(np.float64), axis=0)
    norm = 1.0 - alpha ** (np.arange(1, Y.shape[0] + 1, dtype=np.float64))
    return (acc / norm[:, None]).astype(Y.dtype)


# ---------------------------------------------------------------------------
# splice / subsample (feature.py:103-133)
# ---------------------------------------------------------------------------


def splice(Y: np.ndarray, context_size: int = 0) -> np.ndarray:
    """Stack +/- context frames: (T, D) -> (T, D*(2*context+1)), zero padded."""
    if context_size == 0:
        return Y
    Y = np.ascontiguousarray(Y)
    Y_pad = np.pad(Y, [(context_size, context_size), (0, 0)], "constant")
    T, D = Y.shape
    return np.lib.stride_tricks.as_strided(
        Y_pad,
        (T, D * (2 * context_size + 1)),
        (Y.itemsize * D, Y.itemsize),
        writeable=False,
    ).copy()


def subsample(Y: np.ndarray, T: np.ndarray | None = None, subsampling: int = 1):
    if T is None:
        return Y[::subsampling]
    return Y[::subsampling], T[::subsampling]


def count_frames(data_len: int, size: int, shift: int) -> int:
    """Frame count of stft() above for a signal of data_len samples
    (reference _count_frames, feature.py:164-169)."""
    n_frames = 1 + int(data_len / shift)
    if data_len % shift == 0:
        n_frames -= 1
    return n_frames


def get_input_dim(frame_size: int, context_size: int, transform_type: str) -> int:
    if transform_type.startswith("logmel23"):
        base = 23
    elif transform_type == "logmel":
        base = 40
    else:
        fft_size = 1 << (frame_size - 1).bit_length()
        base = fft_size // 2 + 1
    return (2 * context_size + 1) * base


# ---------------------------------------------------------------------------
# end-to-end extraction for raw-wav inference (feature.py:356-368)
# ---------------------------------------------------------------------------


def extract_fbank(
    wav_path: str | Path,
    context_size: int = 7,
    frame_size: int = 200,
    frame_shift: int = 80,
    input_transform: str | None = "logmel23_mn",
    subsampling: int = 10,
) -> np.ndarray:
    """wav/flac file -> (T/subsampling, (2*context+1)*n_mels) float32
    features."""
    data, _rate = read_audio(wav_path)
    if data.ndim > 1:
        data = data[:, 0]
    Y = stft(data, frame_size, frame_shift)
    Y = transform(Y, input_transform)
    Y_spliced = splice(Y, context_size)
    return np.ascontiguousarray(Y_spliced[::subsampling]).astype(np.float32)
