"""PyTorch port, the audio front end: the port's own copy of the host DSP
(`fseend_tpu_torch/ops/features.py`) against the JAX package's
`fseend_tpu/ops/features.py` on the same synthesized audio, every
transform and both hop endings, bit for bit; the device front end
(`ops/features_tpu.py`: `logmel_frontend`, `extract_fbank_batch`,
`StreamingLogmel`) on the CPU against the JAX package's `features_tpu` and
against the host pipeline; the enhancer hook against the JAX package's.

The audio has silent stretches (exact zeros and a 1e-5 floor), where
log10(max(power, 1e-10)) amplifies float32 error.  Tolerance of the device
front end: 2e-4, the JAX package's own (tests/test_features.py:199)."""

import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.data import flac as JFLAC
from fseend_tpu.ops import enhancement as JE
from fseend_tpu.ops import features as JF
from fseend_tpu.ops import features_tpu as JFT
from fseend_tpu_torch.data.dataset import FeatureConfig
from fseend_tpu_torch.ops import enhancement as TE
from fseend_tpu_torch.ops import features as TF
from fseend_tpu_torch.ops import features_tpu as TFT

torch.set_num_threads(1)
ATOL = 2e-4
TRANSFORMS = (None, "log", "logmel", "logmel23", "logmel23_mn", "logmel23_swn",
              "logmel23_mvn", "logmel23_cummn")


def speechlike(rng, B: int, n: int) -> np.ndarray:
    """(B, n) float32 audio in [-1, 1): tones and noise in bursts, exact
    silence and a 1e-5 noise floor between them."""
    t = np.arange(n) / 8000.0
    out = np.empty((B, n), np.float32)
    for b in range(B):
        x = 0.3 * np.sin(2 * np.pi * (200 + 150 * b) * t) + 0.1 * rng.standard_normal(n)
        gate = np.zeros(n)
        for st in rng.integers(0, n, 4):
            gate[st:st + int(rng.integers(400, 2000))] = 1.0
        x = x * gate + 1e-5 * rng.standard_normal(n)
        x[: n // 8] = 0.0                                # a stretch of exact silence
        out[b] = np.clip(x, -1, 1 - 2 ** -15)
    return out


def write_wav(path, x: np.ndarray, sr: int = 8000) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.asarray(x) * 32768).astype("<i2").tobytes())


@pytest.mark.parametrize("n", [8000, 8037])
def test_host_features_equal_jax_bit_for_bit(n, tmp_path):
    """stft, every transform, splice, subsample, the mel bank, the frame
    count, the forgetting mean, and extract_fbank from a wav and a flac
    file: the same arrays as the JAX package's module."""
    rng = np.random.default_rng(n)
    x = speechlike(rng, 1, n)[0]
    Y = TF.stft(x, 200, 80)
    np.testing.assert_array_equal(Y, JF.stft(x, 200, 80))
    assert Y.shape[0] == TF.count_frames(n, 200, 80) == JF.count_frames(n, 200, 80)
    for tf in TRANSFORMS:
        got = TF.transform(Y, tf)
        np.testing.assert_array_equal(got, JF.transform(Y, tf), err_msg=str(tf))
        np.testing.assert_array_equal(TF.subsample(TF.splice(got, 3), subsampling=5),
                                      JF.subsample(JF.splice(got, 3), subsampling=5))
        assert TF.get_input_dim(200, 7, tf or "stft") == JF.get_input_dim(200, 7, tf or "stft")
    np.testing.assert_array_equal(TF.mel_filterbank(16000, 512, 40),
                                  JF.mel_filterbank(16000, 512, 40))
    logmel = TF.transform(Y, "logmel23")
    np.testing.assert_array_equal(TF.forgetting_mean(logmel), JF.forgetting_mean(logmel))
    write_wav(tmp_path / "a.wav", x)
    JFLAC.write_flac(tmp_path / "a.flac", x, 8000)
    for name in ("a.wav", "a.flac"):
        got, sr = TF.read_audio(tmp_path / name, 11, n - 5)
        want, _ = JF.read_audio(tmp_path / name, 11, n - 5)
        assert sr == 8000
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(TF.extract_fbank(tmp_path / name),
                                      JF.extract_fbank(tmp_path / name))


@pytest.mark.parametrize("n", [8000, 8037])
def test_logmel_frontend_matches_jax_and_the_host(n):
    """Every device transform, both hop endings: the port's front end on
    the CPU against the host pipeline row by row, and (the ragged ending)
    against the JAX package's `logmel_frontend`."""
    audio = speechlike(np.random.default_rng(n + 1), 2, n)
    for tf in ("logmel23", "logmel23_mn", "logmel23_mvn", "logmel23_cummn"):
        kw = dict(frame_size=200, frame_shift=80, context_size=3, subsampling=5,
                  input_transform=tf)
        got = TFT.logmel_frontend(torch.as_tensor(audio), device="cpu", **kw).numpy()
        if n % 80:
            np.testing.assert_allclose(
                got, np.asarray(JFT.logmel_frontend(jnp.asarray(audio), **kw)), atol=ATOL,
                err_msg=tf)
        for b in range(2):
            host = TF.subsample(TF.splice(TF.transform(TF.stft(audio[b], 200, 80), tf), 3),
                                subsampling=5)
            assert got[b].shape == host.shape
            np.testing.assert_allclose(got[b], host, atol=ATOL, err_msg=f"{tf} row {b}")
    with pytest.raises(ValueError, match="on-device"):
        TFT.logmel_frontend(audio, input_transform="logmel23_swn", device="cpu")


def test_extract_fbank_batch_matches_extract_fbank(tmp_path):
    feat = FeatureConfig(input_transform="logmel23_mn")
    audio = speechlike(np.random.default_rng(3), 2, 12_345)
    got = TFT.extract_fbank_batch(audio, feat, device="cpu").numpy()
    for b in range(2):
        write_wav(tmp_path / f"{b}.wav", audio[b])
        # the wav holds the audio rounded to 16 bits: featurize that
        want = TF.extract_fbank(tmp_path / f"{b}.wav", context_size=feat.context_size,
                                input_transform=feat.input_transform)
        rounded, _ = TF.read_wav(tmp_path / f"{b}.wav")
        again = TFT.extract_fbank_batch(rounded[None], feat, device="cpu").numpy()[0]
        np.testing.assert_allclose(again, want, atol=ATOL)
        assert got[b].shape == want.shape


@pytest.mark.parametrize("tf", ["logmel23", "logmel23_cummn"])
@pytest.mark.parametrize("extra", [0, 3])
def test_streaming_logmel_equals_offline_and_jax(tf, extra):
    """StreamingLogmel over fixed blocks plus a flush with the ragged
    remainder: the offline host pipeline on the whole stream, and (cumulative
    mean, ragged end) block by block the JAX package's StreamingLogmel (the
    same emission counts)."""
    S, n_blocks = 800, 7
    audio = speechlike(np.random.default_rng(extra), 2, S * n_blocks + extra)
    kw = dict(frame_size=200, frame_shift=80, context_size=7, subsampling=10,
              input_transform=tf)
    sl = TFT.StreamingLogmel(2, S, device="cpu", **kw)
    outs = [sl.process_block(torch.as_tensor(audio[:, i * S:(i + 1) * S]))
            for i in range(n_blocks)]
    outs.append(sl.flush(torch.as_tensor(audio[:, S * n_blocks:]) if extra else None))
    if tf == "logmel23_cummn" and extra:
        jsl = JFT.StreamingLogmel(2, S, **kw)
        want = [jsl.process_block(audio[:, i * S:(i + 1) * S]) for i in range(n_blocks)]
        want.append(jsl.flush(audio[:, S * n_blocks:] if extra else None))
        for i, (g, w) in enumerate(zip(outs, want)):
            assert g.shape == w.shape, i
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=f"block {i}")
    got = torch.cat(outs, dim=1).numpy()
    for b in range(2):
        ref = TF.subsample(TF.splice(TF.transform(TF.stft(audio[b], 200, 80), tf), 7),
                           subsampling=10)
        assert got[b].shape == ref.shape
        np.testing.assert_allclose(got[b], ref, atol=ATOL, err_msg=f"{tf} extra={extra}")
    with pytest.raises(ValueError, match="causal"):
        TFT.StreamingLogmel(2, S, input_transform="logmel23_mn", device="cpu")


def test_enhancement_hook_matches_jax():
    rng = np.random.default_rng(5)
    logmel = rng.standard_normal((40, 23)).astype(np.float32) - 5.0
    assert TE.enhance_features(logmel, None) is logmel
    np.testing.assert_array_equal(TE.enhance_features(logmel, TE.IdentityEnhancer()), logmel)
    got = TE.SpectralSubtractionEnhancer(alpha=0.99)(logmel)
    np.testing.assert_array_equal(got, JE.SpectralSubtractionEnhancer(alpha=0.99)(logmel))
    later = logmel.copy()
    later[30:] += 50                                     # causal: the past is unchanged
    np.testing.assert_array_equal(TE.SpectralSubtractionEnhancer(alpha=0.99)(later)[:30],
                                  got[:30])
