"""PyTorch port, the entry points (`fseend_tpu_torch/cli/`) that run a
model: infer, streaming_infer, serve, `train --test_from_folder`, score and
stb_eval, each against the JAX package's root `cli/` script on the same
yaml config, the same Kaldi directory and the same checkpoint, on the CPU
(`--device cpu`).  `test_torch_port_cli_build.py` holds the rest
(build_model, the loaders, convert, train) on this file's world; this file
keeps 10 tests so that pytest-xdist starts it after `tests/test_sp.py`
(files with more tests go first).

The models are the reference's tiny LS-EEND and FS-EEND of
`tests/goldens/{ls,fs}_model_ref.npz` (their torch state dicts written as
.ckpt files and converted once to .npz) and a seeded EEND-EDA; the audio is
a synthesized two-speaker Kaldi directory.  Probabilities are read where
both packages hand them to `make_rttm` (or from the h5 files they write)
and held within 1e-5 (float32, another summation order); the RTTM texts
must be equal unless a probability lies within 1e-5 of the threshold.
The JAX models are loaded once (`load_model` cached): the JAX side's first
call of a shape is the slow part.
"""

import contextlib
import io
import json
import pathlib
import sys
import wave

import numpy as np
import pytest
import torch
import yaml

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))   # the JAX package's root cli/

import cli.infer as JI  # noqa: E402
import cli.sad_postprocess as JSAD  # noqa: E402
import cli.score as JSCORE  # noqa: E402
import cli.serve as JSERVE  # noqa: E402
import cli.stb_eval as JSTB  # noqa: E402
import cli.streaming_infer as JSI  # noqa: E402
import cli.train as JT  # noqa: E402
from fseend_tpu.utils import rttm as JR  # noqa: E402
from fseend_tpu_torch.cli import convert as TCONV  # noqa: E402
from fseend_tpu_torch.cli.common import feature_config  # noqa: E402
from fseend_tpu_torch.cli import infer as TI  # noqa: E402
from fseend_tpu_torch.cli import sad_postprocess as TSAD  # noqa: E402
from fseend_tpu_torch.cli import score as TSCORE  # noqa: E402
from fseend_tpu_torch.cli import serve as TSERVE  # noqa: E402
from fseend_tpu_torch.cli import stb_eval as TSTB  # noqa: E402
from fseend_tpu_torch.cli import streaming_infer as TSI  # noqa: E402
from fseend_tpu_torch.cli import train as TT  # noqa: E402
from fseend_tpu_torch.utils import checkpoint as TCK  # noqa: E402
from fseend_tpu_torch.utils import convert as TCV  # noqa: E402
from fseend_tpu_torch.utils import rttm as TR  # noqa: E402
from fseend_tpu_torch.utils import torch_convert as TTC  # noqa: E402

torch.set_num_threads(1)
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))
ATOL = 1e-5
FEAT = {"sample_rate": 8000, "win_length": 200, "n_fft": 1024, "hop_length": 80,
        "n_mels": 23}


def _write_wav(path, x, sr=8000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _kaldi_dir(d, rng, n_recs=2, dur=6.0, sr=8000):
    """Two speakers (a low and a high tone over noise) per recording."""
    d.mkdir(parents=True)
    n = int(sr * dur)
    t = np.arange(n) / sr
    files = {k: [] for k in ("wav.scp", "segments", "utt2spk", "reco2dur")}
    for r in range(n_recs):
        rec = f"rec{r}"
        audio = 0.01 * rng.standard_normal(n)
        for s, (f0, st, ed) in enumerate(((220.0, 0.5 + r, 3.5 + r), (1400.0, 2.5, 5.5))):
            audio += ((t >= st) & (t < ed)) * 0.3 * np.sin(2 * np.pi * f0 * t)
            files["segments"].append(f"{rec}_s{s} {rec} {st:.2f} {ed:.2f}")
            files["utt2spk"].append(f"{rec}_s{s} {rec}_spk{s}")
        _write_wav(d / f"{rec}.wav", audio)
        files["wav.scp"].append(f"{rec} {d / f'{rec}.wav'}")
        files["reco2dur"].append(f"{rec} {dur}")
    for k, lines in files.items():
        (d / k).write_text("\n".join(lines) + "\n")
    return d


def _configs(root, kd):
    """Tiny yaml configs: LS and FS at the goldens' sizes, EEND-EDA."""
    data = {"max_speakers": 2, "context_recp": 0, "label_delay": 0, "chunk_size": 40,
            "subsampling": 10, "use_last_samples": True, "feat": FEAT,
            "train_data_dir": str(kd), "val_data_dir": str(kd)}
    train = {"batch_size": 2, "max_epochs": 1, "opt": "noam", "lr": 1.0,
             "warm_steps": 10, "grad_clip": 5, "seed": 777}

    def log(name):
        return {"model_name": name, "log_dir": str(root / "logs" / name)}

    ls = {"log": log("ls_tiny"), "training": train,
          "model": {"arch": "ls_eend_conformer_retention", "params": {
              "n_units": 32, "n_heads": 4, "enc_n_layers": 2, "dec_n_layers": 2,
              "feed_forward_expansion_factor": 2, "dec_dim_feedforward": 64,
              "conv_kernel_size": 5, "recurrent_chunk_size": 8, "dropout": 0.0,
              "conv_delay": 3, "use_fused_ret": True, "use_fused_dec": True,
              "fused_dec_chunk": 8}},
          "data": dict(data, feat_type="logmel23_cummn"), "task": {"label_mode": "fixed"},
          "debug": {"limit_train_batches": 2, "limit_val_batches": 1}}
    fs = {"log": log("fs_tiny"), "training": train,
          "model": {"arch": "fs_eend", "params": {
              "n_units": 32, "n_heads": 4, "enc_n_layers": 2, "dec_n_layers": 2,
              "enc_dim_feedforward": 2048, "dec_dim_feedforward": 64, "dropout": 0.0,
              "conv_delay": 9}},
          "data": dict(data, feat_type="logmel23"), "task": {"label_mode": "fixed"}}
    eda = {"log": log("eda_tiny"), "training": train,
           "model": {"arch": "eend_eda_offline", "params": {
               "n_units": 32, "n_heads": 4, "enc_n_layers": 2, "dropout": 0.0}},
           "data": dict(data, feat_type="logmel23", buffer_size=30, block_size=12,
                        buffer_weights="v1"), "task": {"label_mode": "pit"}}
    out = {}
    for name, c in (("ls", ls), ("fs", fs), ("eda", eda)):
        out[name] = root / f"{name}.yaml"
        out[name].write_text(yaml.safe_dump(c))
    return out


def _golden_sd(name):
    g = np.load(REPO / "tests" / "goldens" / name)
    return {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    kd = _kaldi_dir(root / "kaldi", np.random.default_rng(0))
    cfgs = _configs(root, kd)
    w = {"root": root, "kaldi": kd, **cfgs}
    for fam in ("ls", "fs"):
        sd = _golden_sd(f"{fam}_model_ref.npz")
        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, root / f"{fam}.ckpt")
        with contextlib.redirect_stdout(io.StringIO()):
            TCONV.main(["--configs", str(cfgs[fam]), "--ckpt", str(root / f"{fam}.ckpt"),
                        "--out", str(root / f"{fam}.npz")])
        w[f"{fam}.ckpt"], w[f"{fam}.npz"] = root / f"{fam}.ckpt", root / f"{fam}.npz"
    from fseend_tpu_torch.models import eend_eda

    ecfg, _, _ = TT.build_model(_load(cfgs["eda"]))
    eda = eend_eda.init_eend_eda(ecfg, torch.Generator().manual_seed(3), device="cpu")
    params, _ = TCV.eda_params_to_jax(eda)
    TCK.save_pytree(root / "eda.npz", {"params": params})
    w["eda.npz"] = root / "eda.npz"

    # the JAX models are built once: JAX's load_model initializes a model
    # eagerly before it loads the weights, seconds per call on the CPU
    cache = {}

    def cached_load_model(configs, ckpt_path, _orig=JI.load_model):
        key = (json.dumps(configs, sort_keys=True, default=str), ckpt_path)
        if key not in cache:
            cache[key] = _orig(configs, ckpt_path)
        return cache[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(JI, "load_model", cached_load_model)
    yield w
    mp.undo()


def _load(path):
    from fseend_tpu_torch.utils.config import load_config

    return load_config(path)


def _jax_main(module, args, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + [str(a) for a in args])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        module.main()
    return out.getvalue()


def _port_main(module, args, device=True):
    """module.main(args) on the CPU (`--device cpu` where the twin takes
    it); its printed output."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        module.main([str(a) for a in args] + (["--device", "cpu"] if device else []))
    return out.getvalue()


@pytest.fixture
def rttm_probs(monkeypatch):
    """Every make_rttm call's (recording, probabilities), per package."""
    got = {"jax": [], "port": []}
    for key, mod in (("jax", JR), ("port", TR)):
        def record(rec, pred, *a, _orig=mod.make_rttm, _key=key, **kw):
            got[_key].append((rec, np.asarray(pred)))
            return _orig(rec, pred, *a, **kw)

        monkeypatch.setattr(mod, "make_rttm", record)
    return got


def _assert_probs_and_rttm(got, jax_text, port_text, threshold=0.5):
    assert [r for r, _ in got["port"]] == [r for r, _ in got["jax"]]
    near = False
    for (_, p), (_, j) in zip(got["port"], got["jax"]):
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, atol=ATOL)
        near |= bool(np.abs(j - threshold).min() < ATOL)
    if not near:
        assert port_text == jax_text


# ---------------------------------------------------------------------------
# inference, streaming, serving
# ---------------------------------------------------------------------------


def test_infer_equals_jax(world, rttm_probs, monkeypatch):
    """LS over the directory from the .npz (the "fused" route, through the
    retention-layer op), FS on one wav from the reference .ckpt."""
    root, kd = world["root"], world["kaldi"]
    for fam, src, ckpt in (("ls", ["--wav_dir", kd], world["ls.npz"]),
                           ("fs", ["--wav", kd / "rec1.wav"], world["fs.ckpt"])):
        rttm_probs["jax"].clear()
        rttm_probs["port"].clear()
        jout, tout = root / f"infer_{fam}_jax.rttm", root / f"infer_{fam}_port.rttm"
        _jax_main(JI, ["--configs", world[fam], *src, "--ckpt", ckpt, "--out", jout],
                  monkeypatch)
        _port_main(TI, ["--configs", world[fam], *src, "--ckpt", ckpt, "--out", tout])
        assert len(rttm_probs["port"]) == (2 if fam == "ls" else 1)
        _assert_probs_and_rttm(rttm_probs, jout.read_text(), tout.read_text())


@pytest.mark.parametrize("fam,mode,against_jax", [
    ("ls", ["--frame_kernel"], True), ("fs", ["--block", "32"], True),
    ("ls", ["--block", "8"], False), ("fs", [], False)],
    ids=["ls-frame_kernel", "fs-block", "ls-block", "fs-frames"])
def test_streaming_infer_equals_jax(world, rttm_probs, monkeypatch, fam, mode, against_jax):
    """LS per frame (both frame scans; JAX: its per-frame XLA scan) and FS
    blockwise against the JAX CLI in the same mode.  LS blockwise (the
    retention-layer op) at block = the config's chunk, and FS per frame,
    through --check alone: within 1e-5 of the port's batch pass, which
    test_infer_equals_jax holds to JAX's (the JAX side's first calls of
    these two modes cost tens of seconds on one core)."""
    wav = world["kaldi"] / "rec0.wav"
    args = ["--wav_path", wav, "--test_from_file", world[f"{fam}.npz"], "--check"]
    ttext = _port_main(TSI, ["--configs", world[fam]] + args + mode)
    assert ttext.splitlines()[1].endswith("-> OK")
    if against_jax:
        jmode = [] if mode == ["--frame_kernel"] else mode
        jtext = _jax_main(JSI, ["--configs", world[fam]] + args + jmode, monkeypatch)
        _assert_probs_and_rttm(rttm_probs, jtext.split("\n", 2)[2], ttext.split("\n", 2)[2])
    else:
        assert float(ttext.splitlines()[1].split("max diff ")[1].split()[0]) < ATOL


SERVE_ARGS = ["--lanes", 2, "--block", 20, "--capacity", 128]


@pytest.fixture(scope="module")
def jax_served(world):
    """The JAX cli.serve over both recordings, per family: ({rec: the
    probabilities it gave make_rttm}, the RTTM files' text, its output)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for fam in ("ls", "fs"):
            got = {}

            def record(rec, pred, *a, _orig=JR.make_rttm, **kw):
                got[rec] = np.asarray(pred)
                return _orig(rec, pred, *a, **kw)

            mp.setattr(JR, "make_rttm", record)
            d = world["root"] / f"serve_{fam}_jax"
            text = _jax_main(JSERVE, ["--configs", world[fam], "--ckpt", world[f"{fam}.npz"],
                                      "--wav_dir", world["kaldi"], *SERVE_ARGS, "--out_dir", d],
                             mp)
            out[fam] = (got, "".join((d / f"rec{i}.rttm").read_text() for i in range(2)), text)
    return out


def test_serve_equals_jax(world, jax_served, rttm_probs):
    """Both recordings over 2 lanes: LS on the frame-scan kernels' route
    (JAX: its per-frame XLA scan), FS on the fast block; one RTTM each,
    an old one unlinked first."""
    for fam in ("ls", "fs"):
        rttm_probs["port"].clear()
        tdir = world["root"] / f"serve_{fam}_port"
        tdir.mkdir()
        (tdir / "rec0.rttm").write_text("stale\n")
        ttext = _port_main(TSERVE, ["--configs", world[fam], "--ckpt", world[f"{fam}.npz"],
                                    "--wav_dir", world["kaldi"], *SERVE_ARGS, "--out_dir", tdir])
        jprobs, jrttm, jtext = jax_served[fam]
        for text in (ttext, jtext):
            assert text.startswith("served 2 recordings (120 frames) over 2 lanes in ")
        rttm_probs["jax"] = sorted(jprobs.items())
        rttm_probs["port"].sort(key=lambda r: r[0])
        _assert_probs_and_rttm(rttm_probs, jrttm,
                               "".join((tdir / f"rec{i}.rttm").read_text() for i in range(2)))


def test_streaming_server_frame_kernel_enc_equals_jax(world, jax_served):
    """frame_kernel_enc=False runs the plain per-frame encoder beside the
    decoder's frame scan: with either setting a server driven by the
    ContinuousBatcher as cli.serve drives it gives the JAX CLI's
    probabilities."""
    from fseend_tpu_torch.data.dataset import PredictDataset
    from fseend_tpu_torch.serving.runtime import StreamingServer
    from fseend_tpu_torch.serving.scheduler import ContinuousBatcher

    configs = _load(world["ls"])
    cfg, _, model = TI.load_model(configs, str(world["ls.npz"]), "cpu")
    ds = PredictDataset(str(world["kaldi"]), feature_config(configs["data"]))
    for enc in (True, False):
        srv = StreamingServer(kind="ls", cfg=cfg, model=model, n_lanes=2, n_slots=4,
                              frame_kernel_enc=enc, device="cpu")
        cb = ContinuousBatcher(srv, block=20)
        for i in range(len(ds)):
            feats, rec = ds[i]
            cb.submit(rec, feats)
        got = cb.run()
        assert got.keys() == jax_served["ls"][0].keys()
        for rec, want in jax_served["ls"][0].items():
            np.testing.assert_allclose(got[rec], want, atol=ATOL)


# ---------------------------------------------------------------------------
# training, evaluation, scoring, FLEX-STB
# ---------------------------------------------------------------------------


def _h5(path):
    from fseend_tpu_torch.utils.postprocess import load_h5_probs

    return load_h5_probs(path)


@pytest.fixture(scope="module")
def folder(world):
    """Two epoch checkpoints of the FS model (the second nudged), averaged
    by both packages' --test_from_folder."""
    sd = _golden_sd("fs_model_ref.npz")
    cfg, _, _ = TT.build_model(_load(world["fs"]))
    d = world["root"] / "fs_ckpts"
    for ep, scale in ((0, 1.0), (1, 0.9)):
        params, mstate = TTC.fs_tree_from_state_dict(
            {k: v * np.float32(scale) if v.dtype == np.float32 and "running" not in k
             else v for k, v in sd.items()}, cfg)
        TCK.save_pytree(d / f"ckpt_epoch={ep}.npz", {"params": params, "model_state": mstate})
    return d


def test_evaluate_folder_equals_jax(world, folder):
    configs = _load(world["fs"])
    configs["training"]["val_batch_size"] = 4
    with contextlib.redirect_stdout(io.StringIO()):
        want = JT.evaluate_folder(configs, str(folder))
    jh5 = {p.name: _h5(p) for p in (folder / "preds_h5").glob("*.h5")}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = TT.evaluate_folder(configs, str(folder), "cpu")
    assert "averaged 2 checkpoints from" in out.getvalue()
    th5 = {p.name: _h5(p) for p in (folder / "preds_h5").glob("*.h5")}
    assert th5.keys() == jh5.keys() == {"rec0.h5", "rec1.h5"}
    for k in jh5:
        np.testing.assert_allclose(th5[k], jh5[k], atol=ATOL)
    for k in ("DER", "speaker_scored", "diarization_error"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6)


def test_score_and_sad_postprocess_equal_jax(world, folder, monkeypatch):
    """h5 scoring, the RTTM pair scoring and oracle-SAD rescoring: the same
    printed numbers and the same files."""
    hyp = folder / "preds_h5"
    if not hyp.exists():
        with contextlib.redirect_stdout(io.StringIO()):
            TT.evaluate_folder(_load(world["fs"]), str(folder), "cpu")
    args = ["--configs", world["fs"], "--hyp_dir", hyp]
    assert _port_main(TSCORE, args, device=False) == _jax_main(JSCORE, args, monkeypatch)
    ref = world["root"] / "ref.rttm"
    lines = [ln.split() for ln in (world["kaldi"] / "segments").read_text().split("\n") if ln]
    ref.write_text("".join(f"SPEAKER {rec} 1 {float(st):.2f} {float(ed) - float(st):.2f} "
                           f"<NA> <NA> {utt[-2:]} <NA>\n" for utt, rec, st, ed in lines))
    hyp_rttm = world["root"] / "hyp.rttm"
    with contextlib.redirect_stdout(io.StringIO()):
        TI.main(["--configs", str(world["fs"]), "--wav_dir", str(world["kaldi"]),
                 "--ckpt", str(world["fs.npz"]), "--out", str(hyp_rttm), "--device", "cpu"])
    for h in (hyp_rttm, ref):
        args = ["--ref_rttm", ref, "--hyp_rttm", h, "--collar", 0.25]
        text = _port_main(TSCORE, args, device=False)
        assert text == _jax_main(JSCORE, args, monkeypatch)
    assert "overall DER: 0.0000" in text
    jout, tout = world["root"] / "sad_jax", world["root"] / "sad_port"
    args = ["--configs", world["fs"], "--hyp_dir", hyp]
    assert (_jax_main(JSAD, args + ["--out_dir", jout], monkeypatch)
            == _port_main(TSAD, args + ["--out_dir", tout], device=False))
    for p in jout.glob("*.h5"):
        np.testing.assert_array_equal(_h5(tout / p.name), _h5(p))


def test_stb_eval_equals_jax(world, monkeypatch):
    """FLEX-STB ("v1" buffer) over the directory's recordings."""
    root = world["root"]
    args = ["--configs", world["eda"], "--ckpt", world["eda.npz"]]
    jtext = _jax_main(JSTB, args + ["--out_dir", root / "stb_jax"], monkeypatch)
    ttext = _port_main(TSTB, args + ["--out_dir", root / "stb_port"])
    assert [ln.split(":")[0] for ln in ttext.splitlines()] == \
        [ln.split(":")[0] for ln in jtext.splitlines()] == ["rec0", "rec1"]
    for p in (root / "stb_jax").glob("*.h5"):
        np.testing.assert_allclose(_h5(root / "stb_port" / p.name), _h5(p), atol=ATOL)
