"""PyTorch port, multi-GPU part 2: tensor parallelism over the "model" axis
(`fseend_tpu_torch/parallel/mesh.py`, `parallel/collectives.py`), checked
on gloo grids on the CPU: 4 ranks spawned once for the file run a 2 x 2
grid, then the first two a 1 x 2 grid (`tests/torch_port_ranks.py`),
against the JAX package and the port's one process.

* the grid: global rank r = d * n_model + m (the JAX package's
  `devices.reshape(n_data, n_model)`), one "model" group per row and one
  "data" group per column, a model group's ranks on the same rows of the
  batch; `param_partition` equal to the JAX package's `param_shardings` on
  every parameter of the three families, at n_model 2 and at 3 (where only
  the packed in_proj divides); the FS sequence-parallel step over the
  "model" axis against one process;
* the TP train step (SGD at lr 1, so the update is the gradient) against
  JAX's single-device `make_train_step` on the same weights and global
  batch: LS on the "plain" and "core" retention routes and on "fused" with
  the fused decoder (B4's and B3's plain versions here; JAX runs its plain
  route: the same function), FS under spk_pit, EEND-EDA.  The losses and the
  global norm within rtol 1e-5 (`tests/test_trainer.py`'s bound), the
  counters equal, the parameters within 1e-4 (`tests/test_trainer.py:
  142-145`), the BatchNorm statistics within 1e-5, every rank's gathered
  parameters equal;
* Adam with an active clip, two steps: the port's one process within 1e-6
  (the clip's norm counts each split parameter once);
* the row-parallel output's transposes: Megatron's *f* / *g* give the
  one-process gradients (1e-6); a psum there (whose backward sums the
  replicated cotangents over the ranks) doubles them;
* FS `run_training` on 2 x 2 (Adam, 2 epochs) and a resume from its first
  checkpoint to a third, against one process at `tests/test_loop_mesh.py`'s
  tolerances (losses rtol 2e-4 atol 1e-6, parameters 1e-4); the
  checkpoints written under TP hold the one-process keys and shapes, load
  in the JAX package's `load_pytree`, and agree within 1e-4;
* `cli.train` with `mesh: {model: 2}` on the 1 x 2 grid against one
  process on the same config (its checkpoint within 1e-4).

The JAX programs and the ranks are the cost: about 30 s wall unpinned, 76
s pinned to one core with its four ranks (CHANGES.md)."""

import copy
import json

import jax
import numpy as np
import pytest
import torch
import yaml

import test_torch_port_parallel as PAR
import torch_port_ranks as K
from fseend_tpu.models import fs_eend as JF
from fseend_tpu.parallel import mesh as JM
from fseend_tpu.utils import checkpoint as JCK
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.parallel import mesh as pmesh
from fseend_tpu_torch.train import optim as TO
from fseend_tpu_torch.train import trainer as TRN
from fseend_tpu_torch.utils import checkpoint as CK
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
GRAD_REL = 1e-5
GRIDS = [f"{nd}x{nm}" for nd, nm in K.GRIDS]


def _write_tp_config(out) -> None:
    """`write_cli_world`'s LS config with `mesh: {model: 2}` instead of
    `dist_strategy: ddp`, as ls_tp.yaml."""
    configs = yaml.safe_load(K.write_cli_world(out).read_text())
    del configs["training"]["dist_strategy"]
    configs["training"]["mesh"] = {"model": 2}
    configs["log"] = {"model_name": "ls_tp", "log_dir": str(out / "logs" / "ls_tp")}
    (out / "ls_tp.yaml").write_text(yaml.safe_dump(configs))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX parameters of the three families (random BatchNorm
    statistics) and the port's models on them; while the ranks run, the
    JAX steps and the one-process FS `run_training`."""
    out = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(7)
    jax_params, models = {}, {}
    for i, (fam, init) in enumerate((("ls", PAR.JL.init_ls_eend), ("fs", JF.init_fs_eend),
                                     ("eda", PAR.JE.init_eend_eda))):
        params, mstate = init(jax.random.PRNGKey(i), PAR.JCFGS[fam])
        mstate = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.0, 0.5, a.shape)
                              .astype(np.float32), mstate)
        jax_params[fam] = (params, mstate)
        np_params = jax.tree.map(np.asarray, params)
        models[fam] = (PAR.CV.eda_params_from_jax(np_params, K.EDA, "cpu") if fam == "eda" else
                       getattr(PAR.CV, f"{fam}_params_from_jax")(np_params, mstate,
                                                                 K.CFGS[fam], "cpu"))
    torch.save(models, out / "models.pt")
    _write_tp_config(out)
    procs = K.start_grid_ranks(K.TP_PHASES, out)
    steps = {fam: PAR._jax_step(jax_params, fam, K.tp_cases()[name][2], K.batch())
             for fam, name in (("ls", "ls_plain"), ("fs", "fs"), ("eda", "eda"))}
    tx = TO.Optimizer(**{**K.ADAM_CLIP, "grad_clip": 5.0})
    one = out / "one"
    final, ckpt_dir = K.run_training(None, one / "fs", 2, family="fs", tx=tx)
    resumed, _ = K.run_training(None, one / "fs_resumed", 3, family="fs", tx=tx,
                                resume_from=str(ckpt_dir / "ckpt_epoch=0.npz"))
    return {"out": out, "jax": jax_params, "jax_steps": steps, "models": models,
            "one": {"final": final, "resumed": resumed, "dir": ckpt_dir},
            "ranks": K.join_ranks(procs, out, timeout=300)}


def _results(world, grid: str, case: str) -> list:
    """Each rank's results of `case` on `grid` (the ranks that grid holds)."""
    nd, nm = map(int, grid.split("x"))
    return K.result(world["ranks"][:nd * nm], f"{grid}/{case}")


def test_grid_partition_and_sp_over_the_model_axis(world):
    """The grids' coordinates, groups and rows; `param_partition` against
    JAX's `param_shardings`; the FS SP step over "model" on 1 x 2 against
    one process."""
    b = K.batch()
    for grid in GRIDS:
        nd, nm = map(int, grid.split("x"))
        for r, got in enumerate(_results(world, grid, "grid_case")):
            d, m = divmod(r, nm)
            assert (got["shape"], got["d"], got["m"], got["global"], got["main"]) == \
                ((nd, nm), d, m, r, r == 0)
            assert got["model"] == [d * nm + j for j in range(nm)]
            assert got["data"] == [i * nm + m for i in range(nd)]
            rows = len(b["lens"]) // nd
            np.testing.assert_array_equal(got["lens"], b["lens"][d * rows:(d + 1) * rows])
            split = sum(v is not None for p in got["partition"].values() for v in p.values())
            assert split == 51 + 21 + 12, split            # LS, FS, EDA
    # the JAX package's shardings on the same trees, at 2 and at 3 (no split)
    for n_model in (2, 3):
        jmesh = JM.make_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
        port = pmesh.make_mesh(n_model=n_model, devices=["cpu"] * n_model)
        for fam, model in world["models"].items():
            params = world["jax"][fam][0]
            want = {JM._path_str(path): tuple(s.spec) for path, s in
                    jax.tree_util.tree_flatten_with_path(JM.param_shardings(params, jmesh))[0]}
            layout = CV.jax_param_layout(model)
            got = pmesh.param_partition(model, port)
            assert len(got) == len(list(model.parameters()))
            for name, dim in got.items():
                jname, axes = layout[name]
                spec = want[jname]
                jdim = [axes[a] for a, ax in enumerate(spec) if ax == "model"]
                assert (jdim[0] if jdim else None) == dim, (fam, n_model, name, spec)
            # at 3 only the packed in_proj (3 D outputs) divides
            split = {n for n, v in got.items() if v is not None}
            assert split and (n_model == 2 or all("in_proj" in n for n in split))
    want = K.train_step(None, copy.deepcopy(world["models"]["fs"]), K.FS,
                        TRN.TaskConfig(model="fs"), b)
    for got in _results(world, "1x2", "sp_model_axis_case"):
        np.testing.assert_allclose(got["metrics"][0]["tot_loss"], want["metrics"][0]["tot_loss"],
                                   rtol=LOSS_RTOL)
        PAR._close_tree(got["grads"], want["grads"], "SP over model", rel=GRAD_REL)


@pytest.mark.parametrize("name", list(K.tp_cases()))
def test_tp_step_matches_jax_single_device(world, name):
    """One SGD step at lr 1 on both grids, every rank, against JAX's
    single-device step on the global batch."""
    fam = K.tp_cases()[name][0]
    grads, metrics, mstate = world["jax_steps"][fam]
    for grid in GRIDS:
        ranks = _results(world, grid, "tp_step_case")
        for r, got in enumerate(ranks):
            got = got[name]
            assert got["split"] > 0
            label = f"{name} {grid} rank {r}"
            for k in ("pit_loss", "emb_loss", "tot_loss", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][0][k], metrics[k], rtol=LOSS_RTOL,
                                           atol=1e-7, err_msg=f"{label} {k}")
            for k in ("speaker_scored", "diarization_error", "frames", "correct"):
                assert got["metrics"][0][k] == metrics[k], (label, k)
            PAR._close_tree(got["grads"], grads, f"{label} gradients", rel=GRAD_REL)
            PAR._close_tree(got["after"][1], mstate, f"{label} BatchNorm statistics")
            PAR._close_tree(got["after"], ranks[0][name]["after"], f"{label} ranks", atol=0.0)


def test_adam_with_an_active_clip_counts_each_shard_once(world):
    """Two Adam steps with the clip at 0.05 (the global norm is far above
    it): the port's one process, the norms and the parameters."""
    fam, cfg, task = K.tp_cases()["ls_plain"]
    one = K.train_step(None, copy.deepcopy(world["models"][fam]), cfg, task, K.batch(), 2,
                       opt=TO.Optimizer(**K.ADAM_CLIP))
    norms = [m["grad_norm"] for m in one["metrics"]]
    assert min(norms) > 10 * K.ADAM_CLIP["grad_clip"]
    for grid in GRIDS:
        for r, got in enumerate(_results(world, grid, "tp_step_case")):
            got = got["adam_clip"]
            np.testing.assert_allclose([m["grad_norm"] for m in got["metrics"]], norms,
                                       rtol=LOSS_RTOL, err_msg=f"{grid} rank {r}")
            PAR._close_tree(got["after"], one["after"], f"{grid} rank {r}", atol=1e-6)


def test_row_parallel_output_needs_the_model_axis_transposes(world):
    """The FFN pair on shards (1 x 2): Megatron's transposes give the
    one-process gradients; a psum at the row-parallel output (its backward
    a psum, right only where each rank's cotangent is its own share)
    doubles every gradient upstream of it."""
    layer, x, w = K.ffn_pair(K.models(world["out"]))
    x = x.clone().requires_grad_()
    (tnn.ff_block(x, layer.linear1, layer.linear2) * w).sum().backward()
    want = [x.grad] + [p.grad for p in (layer.linear1.weight, layer.linear1.bias,
                                        layer.linear2.weight)]
    for got in _results(world, "1x2", "tp_transpose_case"):
        for name, factor in (("megatron", 1.0), ("psum", 2.0)):
            g = got[name]
            np.testing.assert_allclose(g["y"], got["megatron"]["y"], atol=0)
            for a, b in zip([g["x"]] + g["params"][:3], want):
                np.testing.assert_allclose(a, factor * b, rtol=1e-5, atol=1e-6, err_msg=name)
        # linear2's bias sits after the all-reduce: the same either way
        np.testing.assert_allclose(got["psum"]["params"][3], layer.linear2.bias.grad,
                                   atol=1e-6)


def _losses(d):
    lines = [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
    return [x["train/tot_loss"] for x in lines if "train/tot_loss" in x]


def test_run_training_2x2_and_its_resume_equal_one_process(world):
    """FS `run_training` on the 2 x 2 grid: the logged losses, the final
    and the resumed parameters, the checkpoints key for key."""
    ranks = _results(world, "2x2", "tp_training_case")
    one = world["one"]
    assert ranks[0]["dir"] is not None and all(r["dir"] is None for r in ranks[1:])
    for r, got in enumerate(ranks):
        PAR._close_tree(got["final"], one["final"], f"rank {r} final", atol=PARAM_ATOL)
        PAR._close_tree(got["resumed"], one["resumed"], f"rank {r} resumed", atol=PARAM_ATOL)
    tp_dir = K.Path(ranks[0]["dir"])
    np.testing.assert_allclose(_losses(tp_dir), _losses(one["dir"]), rtol=2e-4, atol=1e-6)
    names = sorted(p.name for p in one["dir"].glob("ckpt_epoch=*.npz"))
    assert sorted(p.name for p in tp_dir.glob("ckpt_epoch=*.npz")) == names == \
        ["ckpt_epoch=0.npz", "ckpt_epoch=1.npz"]
    params, mstate = JF.init_fs_eend(jax.random.PRNGKey(0), PAR.JCFGS["fs"])
    template = {"params": params, "model_state": mstate}
    for name in names:
        tp, ref = CK.load_flat(tp_dir / name), CK.load_flat(one["dir"] / name)
        assert tp.keys() == ref.keys()
        for k in ref:
            assert tp[k].shape == ref[k].shape and tp[k].dtype == ref[k].dtype, k
            if not k.startswith("__extra__/"):
                np.testing.assert_allclose(tp[k], ref[k], atol=PARAM_ATOL, err_msg=k)
        loaded = JCK.load_pytree(tp_dir / name, template)
        PAR._close_tree(loaded, JCK.load_pytree(one["dir"] / name, template), name,
                        atol=PARAM_ATOL)


def test_cli_train_on_a_model_axis_equals_one_process(world):
    """`cli.train` with `mesh: {model: 2}` on the 1 x 2 grid, then the same
    config in one process (the one-chip line; its run is version_1)."""
    from fseend_tpu_torch.cli import train as TT

    out = _results(world, "1x2", "tp_cli_case")
    assert "mesh: 1 data x 2 model (2 processes)" in out[0]["stdout"]
    assert "epoch 0:" in out[0]["stdout"] and out[1]["stdout"] == ""
    TT.main(["--configs", str(world["out"] / "ls_tp.yaml"), "--device", "cpu"])
    runs = world["out"] / "logs" / "ls_tp"
    assert (runs / "version_0" / "avg_model.npz").exists()
    assert not (runs / "version_2").exists()
    PAR._close_tree(CK.load_pytree(runs / "version_0" / "ckpt_epoch=0.npz", "params"),
                    CK.load_pytree(runs / "version_1" / "ckpt_epoch=0.npz", "params"),
                    "cli.train", atol=PARAM_ATOL)
