"""PyTorch port, scoring and host utilities: the port's copies of
`utils/{rttm,metrics,postprocess,config}.py` and `train/aux_utils.py`
against the JAX package's on the same inputs.  All numpy, so the RTTM
text, the h5 file's contents, the configs and every auxiliary function are
held exactly; the DER components at 1e-12 (float64 sums in the same
order)."""

import pathlib

import numpy as np
import pytest

from fseend_tpu.train import aux_utils as JA
from fseend_tpu.utils import config as JC
from fseend_tpu.utils import metrics as JM
from fseend_tpu.utils import postprocess as JP
from fseend_tpu.utils import rttm as JR
from fseend_tpu_torch.train import aux_utils as TA
from fseend_tpu_torch.utils import config as TC
from fseend_tpu_torch.utils import metrics as TM
from fseend_tpu_torch.utils import postprocess as TP
from fseend_tpu_torch.utils import rttm as TR

CONFIGS = sorted((pathlib.Path(__file__).parent.parent / "configs").glob("*.yaml"))


def _turns(rng, speakers, prefix, span=60.0):
    """Each speaker's turns in sequence (a speaker never overlaps itself),
    the speakers overlapping one another."""
    out = []
    for s in range(speakers):
        st = float(rng.uniform(0, 5))
        while st < span:
            ed = st + float(rng.uniform(0.2, 8))
            out.append((f"{prefix}{s}", st, ed))
            st = ed + float(rng.uniform(0.1, 6))
    return out


def _activity(rng, T, S):
    y = rng.uniform(size=(T, S))
    y[rng.uniform(size=T) < 0.3] *= 0.3                  # some silence
    return y.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("collar", [0.0, 0.25, 1.0])
def test_der_components_equal_jax(seed, collar):
    """Random overlapping turns (more hypothesis speakers than reference
    ones, some unmatched): the optimal mapping and every DER component."""
    rng = np.random.default_rng(seed)
    ref = _turns(rng, 3, "r")
    hyp = _turns(rng, 4, "h")
    assert TM.optimal_mapping(ref, hyp) == JM.optimal_mapping(ref, hyp)
    got, want = TM.der_components(ref, hyp, collar), JM.der_components(ref, hyp, collar)
    for k in ("total", "miss", "falarm", "confusion", "der"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    assert got.der > 0
    acc = TM.DERComponents()
    acc += got
    acc += got
    np.testing.assert_allclose(acc.der, got.der, rtol=1e-12)
    assert TM.der_components(ref, ref, collar).der == 0.0


@pytest.mark.parametrize("median", [1, 11])
def test_score_frames_equals_jax(median):
    """The reference protocol on 100 Hz labels and 10 Hz probabilities."""
    rng = np.random.default_rng(median)
    T, S = 300, 3
    ref = np.zeros((T * 10, S), np.int32)
    for s in range(S):
        for st in rng.integers(0, T * 10, 4):
            ref[st:st + rng.integers(50, 400), s] = 1
    prob = _activity(rng, T, S)
    got = TM.score_frames(ref, prob, median=median)
    want = JM.score_frames(ref, prob, median=median)
    for k in ("total", "miss", "falarm", "confusion"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-12, atol=1e-12)


def test_rttm_text_and_reading_equal_jax(tmp_path):
    """make_rttm's text byte for byte (with and without the median
    filter), the same file appended twice, and read_rttm's turns."""
    rng = np.random.default_rng(3)
    pred = _activity(rng, 400, 3)
    for median in (1, 11):
        assert TR.make_rttm("recA", pred, median=median) == JR.make_rttm("recA", pred,
                                                                           median=median)
    assert TR.make_rttm("empty", np.zeros((20, 2))) == ""
    t_file, j_file = tmp_path / "t" / "out.rttm", tmp_path / "j" / "out.rttm"
    for rec in ("recA", "recB"):
        TR.make_rttm(rec, pred, out_rttm_file=t_file)
        JR.make_rttm(rec, pred, out_rttm_file=j_file)
    assert t_file.read_bytes() == j_file.read_bytes()
    got = TR.read_rttm(t_file)
    assert got == JR.read_rttm(j_file) and set(got) == {"recA", "recB"}
    assert TR.activity_to_segments(np.array([0, 1, 1, 0, 1])) == [(1, 3), (4, 5)]
    assert TR.pred_to_segments(pred, 0.4, 5) == JR.pred_to_segments(pred, 0.4, 5)


def test_h5_round_trip_and_oracle_sad_equal_jax(tmp_path):
    """The h5 file each package writes is read back the same by both
    (float32 "T_hat"); logits -> h5 through the sigmoid; oracle-SAD
    rescoring exactly the JAX package's."""
    rng = np.random.default_rng(4)
    probs = rng.uniform(size=(50, 3))
    TP.save_h5_probs(tmp_path / "a" / "t.h5", probs)
    got = JP.load_h5_probs(tmp_path / "a" / "t.h5")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, probs.astype(np.float32))
    np.testing.assert_array_equal(TP.load_h5_probs(tmp_path / "a" / "t.h5"), got)
    logits = rng.standard_normal((20, 2)).astype(np.float32)
    np.save(tmp_path / "l.npy", logits)
    TP.logits_npy_to_h5(tmp_path / "l.npy", tmp_path / "t2.h5")
    JP.logits_npy_to_h5(tmp_path / "l.npy", tmp_path / "j2.h5")
    np.testing.assert_array_equal(TP.load_h5_probs(tmp_path / "t2.h5"),
                                  JP.load_h5_probs(tmp_path / "j2.h5"))
    probs[10:20] = 0.1                                   # speech frames no speaker claims
    speech = rng.uniform(size=50) > 0.3
    speech[10:20] = True
    for thr in (0.5, 0.3):
        np.testing.assert_array_equal(TP.oracle_sad_rescore(probs, speech, thr),
                                      JP.oracle_sad_rescore(probs, speech, thr))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_equals_jax(path, tmp_path):
    """Every config in configs/ loads to the same dict (references
    resolved), with and without a dotted override, and dumps to the same
    file."""
    assert TC.load_config(path) == JC.load_config(path)
    over = {"training.batch_size": 3, "data.extra.depth": 2}
    got = TC.load_config(path, over)
    assert got == JC.load_config(path, over) and got["training"]["batch_size"] == 3
    TC.dump_config(got, tmp_path / "t.yaml")
    JC.dump_config(got, tmp_path / "j.yaml")
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()


def test_config_refs_and_arithmetic(tmp_path):
    text = ("data: {chunk_size: 500, sizes: [1, 2]}\n"
            "model:\n"
            "  max_seqlen: !ref <data[chunk_size]>\n"
            "  twice: !ref <data[chunk_size]> * 2\n"
            "  second: !ref <data[sizes][1]>\n"
            "  obj: !new:torch.nn.Linear\n")
    (tmp_path / "c.yaml").write_text(text)
    got = TC.load_config(tmp_path / "c.yaml")
    assert got == JC.load_config(tmp_path / "c.yaml")
    assert got["model"] == {"max_seqlen": 500, "twice": 1000, "second": 2,
                            "obj": "!new:torch.nn.Linear"}


def test_aux_utils_equal_jax():
    """Every function of train/aux_utils.py on the same inputs: the chunk
    curriculum from one seed, the re-chunking, the FIFO buffer, the
    enrollment helpers and the scaler in each mode."""
    t_rng, j_rng = np.random.default_rng(5), np.random.default_rng(5)
    for T in (30, 120, 5000):
        for _ in range(5):
            assert TA.resize_chunk(T, t_rng) == JA.resize_chunk(T, j_rng)
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((n, 4)) for n in (23, 7, 40)]
    labels = [rng.uniform(size=(n, 2)) for n in (23, 7, 40)]
    for a, b in zip(TA.split_inp(feats, labels, 10), JA.split_inp(feats, labels, 10)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    got = TA.update_buffer_fifo(feats[0], feats[2], labels[0], labels[2], 30)
    for x, y in zip(got, JA.update_buffer_fifo(feats[0], feats[2], labels[0], labels[2], 30)):
        np.testing.assert_array_equal(x, y)

    T, S = 200, 4                        # column 0 = silence, as the LS decisions
    decisions = np.zeros((T, S), np.int64)
    decisions[:30, 0] = 1
    decisions[30:80, 1] = 1
    decisions[70:120, 2] = 1
    decisions[120:160, 0] = 1
    decisions[160:200, 3] = 1
    x = rng.standard_normal((T, 5))
    p = rng.uniform(size=(T, S))
    assert TA.find_enroll_segment(decisions, 20) == JA.find_enroll_segment(decisions, 20)
    for a, b in zip(TA.find_enroll_single_spk_frames(x, p, decisions, 15),
                    JA.find_enroll_single_spk_frames(x, p, decisions, 15)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="silence"):
        TA.find_enroll_single_spk_frames(x, p, decisions * (np.arange(S) > 0), 15)
    idx, _, _ = TA.find_enroll_segment(decisions, 20)
    assert TA.select_single_spk_frames(decisions, idx, 7) == \
        JA.select_single_spk_frames(decisions, idx, 7)

    data = [rng.standard_normal((n, 3)) * 2 + 1 for n in (10, 25)]
    for stat in ("instance", "dataset"):
        for norm in ("minmax", "standard", "mean"):
            ts = TA.Scaler(stat, norm, dims=(0,))
            js = JA.Scaler(stat, norm, dims=(0,))
            if stat == "dataset":
                ts.fit(data)
                js.fit(data)
            np.testing.assert_array_equal(ts(data[1]), js(data[1]), err_msg=f"{stat} {norm}")
