"""PyTorch port, the entry points (`fseend_tpu_torch/cli/`), their cheap
half: `build_model` field by field against the JAX CLI's for every
`configs/*.yaml`, the routes the yaml picks, `precision: bf16` and the
`mesh:` block, the bf16 default of `cli.export` for FS-EEND, the
reference-checkpoint loaders and `cli.convert` bit for bit against the JAX
package's, the keyword arguments both `cli.train` hand `run_training` and
`build_optimizer`, a real two-step training run on the CPU, both
`--device_frontend` paths and `utils/profiling.StepTimer`.

The tiny world (configs, Kaldi directory, checkpoints) is
`test_torch_port_cli.py`'s.  The JAX-heavy half (infer, streaming, serve,
evaluate, score, FLEX-STB against the JAX CLIs) stays there, in a file of
10 tests: pytest-xdist's `--dist loadfile` hands out files with more tests
first, so that file starts after `tests/test_sp.py`, the suite's longest,
instead of delaying it.
"""

import contextlib
import dataclasses
import io
import pathlib

import numpy as np
import pytest
import torch
import yaml

import cli.convert as JCONV
import cli.train as JT
from fseend_tpu.utils import checkpoint as JCK
from fseend_tpu.utils import profiling as JPROF
from fseend_tpu.utils import torch_convert as JTC
from fseend_tpu_torch.cli import convert as TCONV
from fseend_tpu_torch.cli import export as TEXP
from fseend_tpu_torch.cli import infer as TI
from fseend_tpu_torch.cli import streaming_infer as TSI
from fseend_tpu_torch.cli import train as TT
from fseend_tpu_torch.utils import convert as TCV
from fseend_tpu_torch.utils import profiling as TPROF
from fseend_tpu_torch.utils import torch_convert as TTC
from test_torch_port_cli import (REPO, _golden_sd, _jax_main, _load,  # noqa: F401
                                 _port_main, rttm_probs, world)

torch.set_num_threads(1)
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_build_model_equals_jax(path):
    """Every field of the model config and the task the JAX CLI builds, and
    the route its kernel flags name."""
    configs = _load(path)
    jcfg, _, jtask = JT.build_model(configs)
    tcfg, make_model, ttask = TT.build_model(configs)
    assert type(tcfg).__name__ == type(jcfg).__name__
    jf, tf = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    for k in jf.keys() & tf.keys():
        assert tf[k] == jf[k], k
    if "kernel" in tf:
        want = ("fused" if jcfg.use_fused_ret else "core" if jcfg.use_pallas else "plain")
        assert tcfg.kernel == want
    assert dataclasses.asdict(ttask) == {k: v for k, v in dataclasses.asdict(jtask).items()
                                         if k in dataclasses.asdict(ttask)}
    assert callable(make_model)


def test_routes_follow_the_yaml_not_the_port_defaults():
    configs = _load(REPO / "configs" / "ls_simu.yaml")
    p = configs["model"]["params"]
    for flags, route in (({}, "plain"), ({"use_pallas": True}, "core"),
                         ({"use_fused_ret": True}, "fused"),
                         ({"use_fused_ret": True, "use_pallas": True}, "fused")):
        configs["model"]["params"] = dict(p, **{"use_pallas": False, **flags})
        assert TT.build_model(configs)[0].kernel == route
    fs = _load(REPO / "configs" / "fs_infer.yaml")
    assert TT.build_model(fs)[0].use_flash_attn is False
    fs["model"]["params"]["use_flash_attn"] = True
    assert TT.build_model(fs)[0].use_flash_attn is True


def test_bf16_and_multi_gpu_raise(world, monkeypatch, capsys):
    # bf16 trains in mixed precision (tests/test_torch_port_bf16_train.py)
    for fam in ("ls", "fs"):
        configs = _load(world[fam])
        configs["training"]["precision"] = "bf16"
        assert TT.build_model(configs)[2].compute_dtype == "bf16"
    # serving exports in bf16 by default, FS-EEND too (LS: tests/test_torch_port_aot.py):
    # the artifact serves what its live bf16 server serves
    from fseend_tpu_torch.serving.aot import AotBlockServer
    out = world["root"] / "fs_bf16.npz"
    srv = TEXP.main(["--configs", str(world["fs"]), "--out", str(out), "--lanes", "2",
                     "--block", "12", "--capacity", "24", "--device", "cpu"])
    aot = AotBlockServer(str(out))
    assert srv.dtype == aot.dtype == torch.bfloat16 and aot.meta["dtype"] == "bfloat16"
    frames = np.random.default_rng(0).standard_normal((2, 12, srv.cfg.in_size))
    for _ in range(2):
        np.testing.assert_array_equal(aot.process_block(frames).numpy(),
                                      srv.process_block(frames).numpy())

    class Stop(Exception):
        pass

    def stop(**kw):
        raise Stop

    monkeypatch.setattr("fseend_tpu_torch.train.loop.run_training", stop)
    configs = yaml.safe_load(world["ls"].read_text())
    configs["training"]["dist_strategy"] = "ddp"
    ddp = world["root"] / "ls_ddp.yaml"
    ddp.write_text(yaml.safe_dump(configs))
    with pytest.raises(Stop):
        TT.main(["--configs", str(ddp), "--device", "cpu"])
    assert "dist requested but only 1 device visible; single-chip run" in capsys.readouterr().out
    # two processes train data parallel (tests/test_torch_port_parallel.py),
    # and with `mesh: {model: 2}` on a 1 x 2 grid (tests/test_torch_port_tp.py):
    # the block asks make_mesh for it, n_data the process count over n_model
    from fseend_tpu_torch.parallel import mesh as PM

    asked, make_mesh = [], PM.make_mesh

    def grid(**kw):
        asked.append(kw)
        return make_mesh(n_data=kw["n_data"], n_model=kw["n_model"],
                            devices=["cpu"] * (kw["n_data"] * kw["n_model"]))

    monkeypatch.setattr(TT, "_n_devices", lambda: 2)
    monkeypatch.setattr(PM, "make_mesh", grid)
    configs["training"]["mesh"] = {"model": 2}
    ddp.write_text(yaml.safe_dump(configs))
    with pytest.raises(Stop):
        TT.main(["--configs", str(ddp), "--device", "cpu"])
    assert asked == [{"n_data": 1, "n_model": 2, "device": torch.device("cpu")}]
    assert "mesh: 1 data x 2 model (2 processes)" in capsys.readouterr().out


def test_load_torch_ckpt_and_average_equal_jax(tmp_path):
    """The Lightning wrapping, the "model." prefix, the legacy decoder keys;
    the float64 average cast back."""
    sd = _golden_sd("ls_model_ref.npz")
    wrapped = {"state_dict": {"model." + k.replace("dec.layers.", "dec.attractor_decoder.layers."):
                              torch.from_numpy(v.copy()) for k, v in sd.items()}}
    torch.save(wrapped, tmp_path / "w.ckpt")
    got, want = TTC.load_torch_ckpt(str(tmp_path / "w.ckpt")), JTC.load_torch_ckpt(
        str(tmp_path / "w.ckpt"))
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(got[k], want[k])
    other = {k: v * np.float32(1.5) + np.float32(0.25) for k, v in got.items()}
    a, b = TTC.average_state_dicts([got, other]), JTC.average_state_dicts([got, other])
    for k in sd:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_convert_bit_for_bit_equals_jax(world, monkeypatch):
    """Two LS checkpoints averaged, one FS checkpoint: the same npz keys
    and bits as the JAX cli.convert, loadable by both packages."""
    root = world["root"]
    sd = _golden_sd("ls_model_ref.npz")
    torch.save({k: torch.from_numpy(np.asarray(v * np.float32(0.5))) for k, v in sd.items()},
               root / "ls_half.ckpt")
    for fam, ckpts in (("ls", [world["ls.ckpt"], root / "ls_half.ckpt"]),
                       ("fs", [world["fs.ckpt"]])):
        jout, tout = root / f"conv_{fam}_jax.npz", root / f"conv_{fam}_port.npz"
        jtext = _jax_main(JCONV, ["--configs", world[fam], "--ckpt", *ckpts, "--out", jout],
                          monkeypatch)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            TCONV.main([str(a) for a in ["--configs", world[fam], "--ckpt", *ckpts,
                                         "--out", tout]])
        assert out.getvalue().replace(str(tout), "") == jtext.replace(str(jout), "")
        j, t = np.load(jout), np.load(tout)
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        _, _, model = TI.load_model(_load(world[fam]), str(tout), "cpu")
        assert sum(p.numel() for p in model.parameters()) == int(
            jtext.split("(")[-1].split()[0].replace(",", ""))



def test_infer_device_frontend_follows_the_host_features(world, rttm_probs):
    """--device_frontend featurizes on the device: the same probabilities as
    the host front end within the front ends' own agreement."""
    args = ["--configs", world["fs"], "--wav", world["kaldi"] / "rec0.wav",
            "--ckpt", world["fs.npz"]]
    _port_main(TI, args)
    _port_main(TI, args + ["--device_frontend"])
    (_, host), (_, dev) = rttm_probs["port"]
    np.testing.assert_allclose(dev, host, atol=1e-3)



def test_streaming_infer_device_frontend_checks_against_the_batch_pass(world, rttm_probs):
    """Raw audio through the device front end into the FS blockwise server:
    within the CLI's FS check (1e-4) of the batch pass on host features."""
    text = _port_main(TSI, ["--configs", world["fs"], "--wav_path",
                            world["kaldi"] / "rec1.wav", "--test_from_file", world["fs.npz"],
                            "--check", "--block", 32, "--device_frontend"])
    assert text.splitlines()[1].endswith("-> OK"), text.splitlines()[1]
    assert rttm_probs["port"][0][1].shape == (60, 3)



def test_train_reaches_run_training_and_the_optimizer_as_jax(world, monkeypatch):
    """The keyword arguments both CLIs give run_training and
    build_optimizer (both monkeypatched; the datasets by their chunks)."""
    import fseend_tpu.train.loop as JL
    import fseend_tpu.train.optim as JO
    import fseend_tpu_torch.train.loop as TL
    import fseend_tpu_torch.train.optim as TO

    class Stop(Exception):
        pass

    seen = {}
    for key, loop_mod, optim_mod in (("jax", JL, JO), ("port", TL, TO)):
        def run(_key=key, **kw):
            seen[_key]["run"] = kw
            raise Stop

        def opt(*a, _key=key, **kw):
            seen[_key] = {"opt": (a, kw)}
            return None

        monkeypatch.setattr(loop_mod, "run_training", run)
        monkeypatch.setattr(optim_mod, "build_optimizer", opt)
    with pytest.raises(Stop):
        _jax_main(JT, ["--configs", world["ls"], "--max_epochs", 3], monkeypatch)
    with pytest.raises(Stop):
        TT.main(["--configs", str(world["ls"]), "--max_epochs", "3", "--device", "cpu"])
    assert seen["port"]["opt"] == seen["jax"]["opt"]
    jr, tr = seen["jax"]["run"], seen["port"]["run"]
    assert set(jr) - set(tr) == {"init_fn"} and set(tr) - set(jr) == {"device"}
    assert jr["mesh"] is None and tr["mesh"] is None and tr["device"] == torch.device("cpu")
    for k in jr.keys() & tr.keys():
        if k in ("train_dataset", "val_dataset"):
            assert type(tr[k]).__name__ == type(jr[k]).__name__
            assert tr[k].chunk_indices == jr[k].chunk_indices
        elif k == "task":
            jt, tt = dataclasses.asdict(jr[k]), dataclasses.asdict(tr[k])
            assert {f: tt[f] for f in jt.keys() & tt.keys()} == \
                {f: jt[f] for f in jt.keys() & tt.keys()}
        elif k == "model_cfg":
            assert tr[k].kernel == "fused" and jr[k].use_fused_ret
        elif k == "logger":
            assert tr[k].dir.parent == jr[k].dir.parent
        elif k != "tx":
            assert tr[k] == jr[k], k


def test_train_two_steps_on_the_cpu(world):
    """A real run: 2 steps of the fused decoder's plain route, an epoch
    checkpoint and avg_model.npz, which the JAX package's load_pytree
    reads into its own model."""
    text = _port_main(TT, ["--configs", world["ls"]])
    assert "epoch 0: 2 steps in " in text
    avg = pathlib.Path(text.strip().splitlines()[-1].split(" -> ")[-1])
    assert avg.name == "avg_model.npz" and (avg.parent / "ckpt_epoch=0.npz").exists()
    # the JAX model's tree from the reference weights (JAX's load_model
    # would first initialize a model eagerly, seconds on one core)
    params, mstate = JTC.ls_from_state_dict(_golden_sd("ls_model_ref.npz"),
                                            JT.build_model(_load(world["ls"]))[0])
    loaded = JCK.load_pytree(str(avg), {"params": params, "model_state": mstate})
    _, _, model = TI.load_model(_load(world["ls"]), str(avg), "cpu")
    tparams, _ = TCV.ls_params_to_jax(model)
    np.testing.assert_array_equal(np.asarray(loaded["params"]["dec"]["convert"]["kernel"]),
                                  tparams["dec"]["convert"]["kernel"])



def test_step_timer_report_equals_jax():
    samples = list(np.random.default_rng(2).uniform(0.001, 0.01, 37))
    got, want = TPROF.StepTimer(max_samples=30), JPROF.StepTimer(max_samples=30)
    for s in samples:
        for t in (got, want):
            t.samples.append(s)
            t.samples = t.samples[-t.max_samples:]
    assert got.report() == want.report()
    assert got.report(frames_per_step=1280) == want.report(frames_per_step=1280)
    assert TPROF.FRAME_RATE_HZ == JPROF.FRAME_RATE_HZ
    with got:
        with TPROF.annotate("x"):
            pass
    assert len(got.samples) == 30


def test_the_twins_that_run_a_model_default_to_the_card(world, monkeypatch):
    """Without --device they ask for `cuda`, and raise where there is none
    (score, sad_postprocess and convert are host code)."""
    from fseend_tpu_torch.cli import serve as TSERVE
    from fseend_tpu_torch.cli import stb_eval as TSTB

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kd, root = world["kaldi"], world["root"]
    for module, args in (
            (TT, ["--configs", world["ls"]]),
            (TI, ["--configs", world["ls"], "--wav", kd / "rec0.wav"]),
            (TSI, ["--configs", world["ls"], "--wav_path", kd / "rec0.wav"]),
            (TSERVE, ["--configs", world["ls"], "--wav_dir", kd, "--out_dir", root / "x"]),
            (TEXP, ["--configs", world["ls"], "--out", root / "x.npz"]),
            (TSTB, ["--configs", world["eda"], "--out_dir", root / "x"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main([str(a) for a in args])
