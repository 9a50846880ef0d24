"""PyTorch port, the data layer: the port's own copies of the Kaldi reader
(`fseend_tpu_torch/data/kaldi.py`) and the datasets (`data/dataset.py`:
`DiarizationDataset`, `OnTheFlyDiarizationDataset`, `PredictDataset`)
against the JAX package's on a synthesized Kaldi directory (a piped
wav.scp entry, segments, utt2spk, spk2utt, reco2dur, reco2num_spk): equal
items, bit for bit.  The FLAC decoder (`data/flac.py`) on files written by
the JAX package's encoder, equal to the JAX package's decode; its native
hot path (`data/_native.py`, built into the repository's build/) equal to
its pure-Python path.  FS `run_training` on the directory, on the fly."""

import wave

import numpy as np
import pytest

from fseend_tpu.data import dataset as JD
from fseend_tpu.data import flac as JFLAC
from fseend_tpu.data import kaldi as JK
from fseend_tpu_torch.data import _native as NAT
from fseend_tpu_torch.data import dataset as TD
from fseend_tpu_torch.data import flac as TFLAC
from fseend_tpu_torch.data import kaldi as TK
from fseend_tpu_torch.kernels._build import BUILD_DIR

SR = 8000


def write_wav(path, x: np.ndarray) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def make_kaldi_dir(path, seed: int, n_recs: int = 3, dur: float = 6.0):
    """A Kaldi data directory of `n_recs` mixtures of 2-3 harmonic
    "speakers" in on/off turns over a noise floor; the second recording's
    wav.scp entry is a pipe."""
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    n = int(SR * dur)
    t = np.arange(n) / SR
    files = {k: [] for k in ("wav.scp", "segments", "utt2spk", "reco2dur", "reco2num_spk")}
    spk2utt = {}
    for r in range(n_recs):
        rec = f"rec{r}"
        k = 2 + r % 2
        audio = 0.02 * rng.standard_normal(n)
        for s in range(k):
            f0 = 120.0 * (1.6 ** (s + r))
            voice = sum(a * np.sin(2 * np.pi * f0 * h * t) for h, a in ((1, 1.0), (2, 0.5)))
            st = float(rng.uniform(0, 1.0))
            ui = 0
            while st < dur - 0.5:
                ed = min(dur, st + float(rng.uniform(0.5, 2.0)))
                i0, i1 = int(st * SR), int(ed * SR)
                audio[i0:i1] += 0.2 * voice[i0:i1]
                utt = f"{rec}_s{s}_{ui:02d}"
                files["segments"].append(f"{utt} {rec} {st:.2f} {ed:.2f}")
                files["utt2spk"].append(f"{utt} {rec}_s{s}")
                spk2utt.setdefault(f"{rec}_s{s}", []).append(utt)
                st, ui = ed + float(rng.uniform(0.3, 1.5)), ui + 1
        wav = path / f"{rec}.wav"
        write_wav(wav, audio / max(1.0, np.abs(audio).max()))
        files["wav.scp"].append(f"{rec} cat {wav} |" if r == 1 else f"{rec} {wav}")
        files["reco2dur"].append(f"{rec} {dur}")
        files["reco2num_spk"].append(f"{rec} {k}")
    files["spk2utt"] = [f"{s} {' '.join(u)}" for s, u in spk2utt.items()]
    for name, lines in files.items():
        (path / name).write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def kaldi_dir(tmp_path_factory):
    return make_kaldi_dir(tmp_path_factory.mktemp("kaldi"), 0)


def _equal_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_kaldi_data_equals_jax(kaldi_dir):
    got, want = TK.KaldiData(kaldi_dir), JK.KaldiData(kaldi_dir)
    for attr in ("segments", "utt2spk", "wavs", "reco2dur", "spk2utt", "reco2num_spk"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for rec in want.wavs:                                # the piped entry included
        for start, end in ((0, None), (1234, 20_000)):
            _equal_items(got.load_wav(rec, start, end), want.load_wav(rec, start, end))
        assert got.rec_duration_frames(rec, 80, SR) == want.rec_duration_frames(rec, 80, SR)


@pytest.mark.parametrize("transform", ["logmel23_mn", "logmel23_cummn"])
def test_diarization_dataset_items_equal_jax(kaldi_dir, transform):
    """Chunks of 20 subsampled frames with the last partial chunk: the
    same chunk table, items (feats, labels, recording) and full labels."""
    kw = dict(chunk_size=20, use_last_samples=True)
    got = TD.DiarizationDataset(str(kaldi_dir), TD.FeatureConfig(input_transform=transform),
                                **kw)
    want = JD.DiarizationDataset(str(kaldi_dir), JD.FeatureConfig(input_transform=transform),
                                 **kw)
    assert got.chunk_indices == want.chunk_indices and len(got) > 3
    assert got.feat.input_dim == want.feat.input_dim == 345
    for i in range(len(want)):
        _equal_items(got[i], want[i])
    _equal_items(got.full_labels(1), want.full_labels(1))


def test_on_the_fly_items_equal_jax(kaldi_dir):
    feat_t, feat_j = TD.FeatureConfig(), JD.FeatureConfig()
    got = TD.OnTheFlyDiarizationDataset(str(kaldi_dir), feat_t, chunk_size=30, n_speakers=3)
    want = JD.OnTheFlyDiarizationDataset(str(kaldi_dir), feat_j, chunk_size=30, n_speakers=3)
    assert len(got) == len(want)
    for i, seed in ((0, 11), (1, 12), (len(want) - 1, 13)):
        _equal_items(got.get(i, seed), want.get(i, seed))
        _equal_items(got[(i, seed)], want[(i, seed)])
    _equal_items(got[0], want[0])


def test_predict_dataset_equals_jax(kaldi_dir, tmp_path):
    for r in range(2):
        data, _ = TK.load_wav(str(kaldi_dir / f"rec{r}.wav"))
        if r:
            JFLAC.write_flac(tmp_path / f"rec{r}.flac", data, SR)
        else:
            write_wav(tmp_path / f"rec{r}.wav", data)
    got = TD.PredictDataset(str(tmp_path), TD.FeatureConfig())
    want = JD.PredictDataset(str(tmp_path), JD.FeatureConfig())
    assert len(got) == len(want) == 2
    for i in range(2):
        _equal_items(got[i], want[i])


def _mixed_signal():
    """Stereo: a tone with noise (FIXED subframes) beside constant,
    noise-like (VERBATIM) and tonal stretches."""
    rng = np.random.default_rng(3)
    t = np.arange(30000) / SR
    return np.stack([
        0.4 * np.sin(2 * np.pi * 180 * t) + 0.2 * rng.standard_normal(len(t)),
        np.concatenate([np.zeros(10000), rng.standard_normal(10000) * 0.9,
                        0.3 * np.sin(2 * np.pi * 90 * t[:10000])]),
    ], axis=1).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2])
def test_read_flac_equals_jax_decode(tmp_path, channels):
    x = _mixed_signal()[:, :channels].squeeze(1) if channels == 1 else _mixed_signal()
    path = tmp_path / "mix.flac"
    JFLAC.write_flac(path, x, SR)
    got, sr = TFLAC.read_flac(path, 100, 25_000)
    want, _ = JFLAC.read_flac(path, 100, 25_000)
    assert sr == SR
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not a FLAC"):
        bad = tmp_path / "bad.flac"
        bad.write_bytes(b"RIFF0000")
        TFLAC.read_flac(bad)


def test_native_decoder_builds_into_build_and_equals_python(tmp_path, monkeypatch):
    """The C hot path is compiled into the repository's build/ and decodes
    bit for bit as the pure-Python path; both reject a malformed residual
    partition."""
    assert NAT.load() is not None, "no working C compiler"
    assert NAT.lib_path().parent == BUILD_DIR and NAT.lib_path().exists()
    path = tmp_path / "mix.flac"
    JFLAC.write_flac(path, _mixed_signal(), SR)
    y_nat, _ = TFLAC.read_flac(path)
    payload = bytes([0b0011_0000] + [0] * 64)          # a first partition shorter than the order
    with pytest.raises(IndexError, match="overrun"):
        TFLAC._rice_residual(TFLAC._Bits(payload), 16, 8, 4)
    monkeypatch.setattr(TFLAC, "_nat", None)
    y_py, _ = TFLAC.read_flac(path)
    np.testing.assert_array_equal(y_nat, y_py)
    with pytest.raises(ValueError, match="overruns"):
        TFLAC._rice_residual(TFLAC._Bits(payload), 16, 8, 4)


def test_run_training_on_the_fly_over_a_kaldi_dir(kaldi_dir, tmp_path):
    """run_training for FS on the Kaldi directory: OnTheFlyDiarizationDataset
    for training (`on_the_fly=True`: every item fetched as (index, seed)),
    DiarizationDataset for validation; finite losses and validation DER."""
    import json

    from fseend_tpu_torch.models import fs_eend
    from fseend_tpu_torch.train import loop as LOOP
    from fseend_tpu_torch.train import optim
    from fseend_tpu_torch.train import trainer as TRN

    keys = []

    class Recorded(TD.OnTheFlyDiarizationDataset):
        def __getitem__(self, item):
            keys.append(item)
            return super().__getitem__(item)

    feat = TD.FeatureConfig(input_transform="logmel23")
    train = Recorded(str(kaldi_dir), feat, chunk_size=30)
    val = TD.DiarizationDataset(str(kaldi_dir), feat, chunk_size=30)
    cfg = fs_eend.FSEENDConfig(in_size=feat.input_dim, n_units=16, n_heads=2, enc_n_layers=1,
                               dec_n_layers=1, enc_dim_feedforward=16, dec_dim_feedforward=16,
                               conv_delay=2, max_nspks=5)
    logger = LOOP.MetricsLogger(str(tmp_path), "otf")
    try:
        state, run_dir = LOOP.run_training(
            task=TRN.TaskConfig(model="fs"), model_cfg=cfg, train_dataset=train,
            val_dataset=val, tx=optim.build_optimizer("noam", 1.0, d_model=16, warmup_steps=10),
            logger=logger, batch_size=2, chunk_size=30, max_speakers=3,
            input_dim=feat.input_dim, max_epochs=1, seed=3, on_the_fly=True, log_every=1,
            device="cpu")
    finally:
        logger.close()
    assert state.step == len(train) // 2 and len(keys) == 2 * state.step
    assert all(isinstance(k, tuple) and len(k) == 2 for k in keys)
    recs = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    vals = [r[k] for r in recs for k in ("train/tot_loss", "val/DER") if k in r]
    assert len(vals) == state.step + 1 and np.isfinite(vals).all()
