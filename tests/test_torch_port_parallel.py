"""PyTorch port, multi-GPU part 1 (`fseend_tpu_torch/parallel/`): the
collectives, the mesh, lane-sharded serving and data-parallel training,
checked on a 2-rank gloo group on the CPU (spawned once for the file,
`tests/torch_port_ranks.py`) against the JAX package and the port's
single-process functions.

* the collectives' forward and backward against the same objective on one
  process (the sum over ranks of what each rank backpropagates), exact
  forward, gradients to 1e-6;
* `param_pspec` equal to the JAX package's on every parameter name of the
  three families;
* lane-sharded servers (a one-process mesh over two CPU devices): float32
  the unsharded port server to 1e-6 (a shard's matmuls have fewer rows, so
  the CPU's BLAS may sum in another order: not bit for bit) and the JAX
  unsharded server to 1e-5 (`tests/test_serving.py`'s bound for JAX's
  sharded server); bf16 by the drift rule of the repo's bf16 tests (max |sharded
  bf16 - float32| <= 3 max |unsharded bf16 - float32| + 1e-3): a bf16
  server's output depends on its lane count at bf16 rounding, sharded or
  not;
* the data-parallel step, rows split 2 + 2 with unequal lengths, against
  the JAX package's `trainer.make_train_step` (SGD at lr 1, so the update
  is the gradient) on the global batch: LS on both decoder routes, FS
  under spk_pit, EEND-EDA; the loss and the counters to 1e-5, each
  gradient to 1e-5 of its largest element (`tests/test_sp.py`'s rule) plus
  1e-7 (two packages' float32 summation orders on leaves whose largest
  element is a few 1e-3), the BatchNorm statistics to 1e-5; the two ranks' parameters equal.  The
  fused decoder is held to JAX's unfused step: the same function.  bf16
  (FS): the loss by the drift rule and the gradient's cosine with JAX's
  bf16 gradient at least JAX's own bf16-vs-float32 cosine less 0.01
  (`tests/test_torch_port_bf16_train.py`'s rule);
* `run_training` over two ranks against one process (SGD, 2 epochs, a
  resume to a third): parameters to 1e-5, the logged losses to 1e-5; and
  `cli.train` with `dist_strategy: ddp` over the two ranks against one
  process on the same config: its checkpoint to 1e-5, rank 0 alone
  printing and writing.

The JAX programs are the cost: about 30 s of the file on one core."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_ranks as K
from fseend_tpu.models import eend_eda as JE
from fseend_tpu.models import fs_eend as JF
from fseend_tpu.models import ls_eend as JL
from fseend_tpu.parallel import mesh as JM
from fseend_tpu.serving import runtime as JRT
from fseend_tpu.train import trainer as JTRN
from fseend_tpu_torch.parallel import mesh as pmesh
from fseend_tpu_torch.serving import runtime as RT
from fseend_tpu_torch.train import optim as TO
from fseend_tpu_torch.train import trainer as TRN
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
ATOL = 1e-5
GRAD_FLOOR = 1e-7
SHARD_ATOL = 1e-6     # a shard's matmuls have fewer rows: another float32 summation order
# XLA's older CPU fusion path compiles these programs in a fraction of the
# time (tests/test_torch_port_bf16_train.py)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}


def _jcfg(jcls, cfg):
    names = {f.name for f in dataclasses.fields(jcls)}
    return jcls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                   if f.name in names and f.name != "use_flash_attn"})


JCFGS = {"ls": _jcfg(JL.LSEENDConfig, K.LS), "fs": _jcfg(JF.FSEENDConfig, K.FS),
         "eda": _jcfg(JE.EDAConfig, K.EDA)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX parameters of the three families (random BatchNorm
    statistics), the port's models on them, and the ranks' results."""
    out = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(7)
    jax_params, models = {}, {}
    for i, (fam, init) in enumerate((("ls", JL.init_ls_eend), ("fs", JF.init_fs_eend),
                                     ("eda", JE.init_eend_eda))):
        params, mstate = init(jax.random.PRNGKey(i), JCFGS[fam])
        mstate = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.0, 0.5, a.shape)
                              .astype(np.float32), mstate)
        jax_params[fam] = (params, mstate)
        np_params = jax.tree.map(np.asarray, params)
        models[fam] = (CV.eda_params_from_jax(np_params, K.EDA, "cpu") if fam == "eda" else
                       getattr(CV, f"{fam}_params_from_jax")(np_params, mstate, K.CFGS[fam],
                                                             "cpu"))
    torch.save(models, out / "models.pt")
    K.write_cli_world(out)
    procs = K.start_ranks(K.PARALLEL_CASES, out)
    steps = {name: _jax_step(jax_params, fam, task, K.batch(), task.compute_dtype)
             for name, (fam, _, task) in K.dp_cases().items() if name != "ls_fused"}
    return {"out": out, "jax": jax_params, "jax_steps": steps,
            "ranks": K.join_ranks(procs, out)}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close_tree(got, want, label, rel=None, atol=ATOL):
    """Each leaf within atol, or within rel of the leaf's largest element
    plus GRAD_FLOOR."""
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want), strict=True)):
        tol = rel * float(np.abs(b).max()) + GRAD_FLOOR if rel else atol
        err = float(np.abs(a - b).max())
        assert err <= tol, f"{label}: leaf {i} differs by {err:.3e} > {tol:.3e}"


def test_collectives_match_their_single_process_identities(world):
    r0, r1 = K.result(world["ranks"], "collectives_case")
    xs = [r["x"].clone().requires_grad_() for r in (r0, r1)]
    zeros = torch.zeros(K.SHAPE)

    def expected(r):
        left = xs[r - 1][:, -2:] if r else zeros[:, :2]
        right = xs[r + 1][:, :2] if r == 0 else zeros[:, :2]
        return {"psum": xs[0] + xs[1], "gather": torch.cat(xs, dim=1),
                "shift_right": xs[0] if r else zeros, "shift_left": zeros if r else xs[1],
                "halo": torch.cat([left, xs[r], right], dim=1)}

    total = 0.0
    for r, got in enumerate((r0, r1)):
        want = expected(r)
        for k in K.COLLECTIVES:
            assert torch.equal(got["outs"][k], want[k].detach()), (r, k)
            total = total + (want[k] * got["w"][k]).sum()
        assert (got["index"], got["size"]) == (r, 2)
    total.backward()
    # batch_mean: the rank's share of the global mean (numerators stay local)
    both = torch.cat([r0["x"][:1], r1["x"][:2]])           # rank r holds rows [: r + 1]
    np.testing.assert_allclose(float(r0["helpers"]["batch_mean"] + r1["helpers"]["batch_mean"]),
                               float(both.mean()), rtol=1e-6)
    for r, got in enumerate((r0, r1)):
        np.testing.assert_allclose(got["grad"], xs[r].grad, atol=1e-6)
        h = got["helpers"]
        assert float(h["batch_sum"]) == 3.0 and float(got["outside"]) == r + 1
        mean, var, n = h["moments"]
        assert n == 3 * K.SHAPE[1]
        np.testing.assert_allclose(mean, both.mean((0, 1)), atol=1e-6)
        np.testing.assert_allclose(var, both.var((0, 1), unbiased=False), atol=1e-6)
        assert int(got["sums"]["a"]) == 3 and float(got["sums"]["b"]) == 0.5
        assert got["sums"]["a"].dtype == torch.int64
        np.testing.assert_array_equal(got["ts"][0], np.ones(3))
        np.testing.assert_array_equal(got["ts"][1], np.arange(4) * 3.0)


def test_param_pspec_matches_jax(world):
    """The tensor-parallel rules (`parallel/mesh.py:param_partition` reads
    them, tests/test_torch_port_tp.py) give the JAX package's spec on every
    parameter name."""
    split = 0
    for params, _ in world["jax"].values():
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            want = tuple(JM.param_pspec(path, leaf))
            assert pmesh.param_pspec(JM._path_str(path), getattr(leaf, "ndim", 0)) == want
            split += bool(want)
    assert split > 20


def test_mesh_batch_rows_and_the_model_axis(world):
    ranks = K.result(world["ranks"], "mesh_case")
    b = K.batch()
    for r, got in enumerate(ranks):
        assert got["shape"] == (2, 1) and got["rank"] == r
        assert got["device"] == "cpu"
        np.testing.assert_array_equal(got["lens"], b["lens"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["feats"], b["feats"][2 * r:2 * r + 2])
        kinds = {k: v[0] for k, v in got["errors"].items()}
        assert kinds == {"model": "ValueError", "data": "ValueError", "backend": "ValueError"}
        assert "3 model with 2 processes" in got["errors"]["model"][1]
        assert "torchrun --nproc_per_node 3" in got["errors"]["data"][1]
        # the two processes as a 1 x 2 grid: one model group, a data group each
        assert got["model_axis"] == {"shape": (1, 2), "d": 0, "m": r, "global": r,
                                     "main": r == 0, "model": [0, 1], "data": [r]}
    # a one-process mesh, and what takes none
    mesh = pmesh.make_mesh(devices=["cpu", "cpu"])
    assert (mesh.n_data, mesh.group, mesh.device) == (2, None, torch.device("cpu"))
    grid = pmesh.make_mesh(n_model=2, devices=["cpu", "cpu"])
    assert (grid.n_data, grid.n_model, grid.devices, grid.group) == (1, 2, (mesh.device,), None)
    with pytest.raises(TypeError, match="mesh of processes"):
        TRN.make_train_step(TRN.TaskConfig(), K.LS, TO.Optimizer(), mesh=mesh, device="cpu")
    model = torch.load(world["out"] / "models.pt", weights_only=False)["ls"]
    with pytest.raises(ValueError, match="do not split evenly"):
        RT.StreamingServer(kind="ls", cfg=K.LS, model=model, n_lanes=3, n_slots=4,
                           device="cpu", mesh=mesh)


def _drift_rule(got16, want16, want32, label):
    bound = 3 * float(np.abs(want16 - want32).max()) + 1e-3
    err = float(np.abs(got16 - want32).max())
    assert err <= bound, f"{label}: {err:.3e} from float32 > {bound:.3e}"


def _fast(jitted):
    """A JAX server's jitted step compiled with FAST at its first call (the
    compile is most of this file's time)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(FAST))
        return compiled[0](*args)
    return call


def _jax_serve(world, fam, block_server, xs, K_, kind_kw):
    params, mstate = world["jax"][fam]
    cfg = JCFGS[fam]
    with jax.default_matmul_precision("highest"):
        if block_server:
            srv = JRT.BlockStreamingServer(cfg=dataclasses.replace(cfg, chunk_size=K_)
                                           if fam == "ls" else cfg, params=params,
                                           model_state=mstate, n_lanes=len(xs), n_slots=4,
                                           block=K_, kind=fam, **kind_kw)
            srv._step = _fast(srv._step)
            return np.concatenate([np.asarray(srv.process_block(xs[:, s:s + K_]))
                                   for s in range(0, xs.shape[1], K_)], axis=1)
        srv = JRT.StreamingServer(kind=fam, cfg=cfg, params=params, model_state=mstate,
                                  n_lanes=len(xs), n_slots=4, **kind_kw)
        srv._block = _fast(srv._block)
        return np.concatenate([np.asarray(srv.process_block(xs[:, s:s + K_])[0])
                               for s in range(0, xs.shape[1], K_)], axis=1)


def _port_serve(server, xs, K_, block_server):
    outs = [server.process_block(xs[:, s:s + K_]) for s in range(0, xs.shape[1], K_)]
    return torch.cat([o if block_server else o[0] for o in outs], dim=1).float().numpy()


@pytest.mark.parametrize("fam", ["ls", "fs"])
def test_lane_sharded_servers_match_jax_and_the_unsharded_port(world, fam):
    """Both server kinds of each family over 4 lanes in 2 shards: LS
    per-frame on the frame-scan route and the plain one, LS blockwise on
    the three retention routes, FS per-frame (fast block) on both
    cached-attention routes, FS blockwise; float32 and bf16; lane reset
    and step() on the per-frame ones."""
    mesh = pmesh.make_mesh(devices=["cpu", "cpu"])
    model = torch.load(world["out"] / "models.pt", weights_only=False)[fam]
    xs = np.random.default_rng(3).standard_normal((4, 12, K.LS.in_size)).astype(np.float32)
    extra = {"capacity": 32} if fam == "fs" else {}
    if fam == "ls":
        cases = [("frame", {"frame_kernel": True}), ("frame", {"frame_kernel": False})] + [
            ("block", {"cfg": dataclasses.replace(K.LS, kernel=k)})
            for k in ("fused", "core", "plain")]
    else:
        cases = [("frame", {"cfg": dataclasses.replace(K.FS, use_flash_attn=f)})
                 for f in (True, False)] + [("block", {})]
    ref = {kind: _jax_serve(world, fam, kind == "block", xs, 6, extra)
           for kind in ("frame", "block")}
    bf16_done = set()
    for kind, kw in cases:
        kw = dict({"cfg": K.CFGS[fam]}, **extra, **kw)
        make = RT.StreamingServer
        if kind == "block":
            make, kw["block"] = RT.BlockStreamingServer, 6

        def server(dtype=torch.float32, mesh_=None, kw=kw, make=make):
            return make(kind=fam, model=model, n_lanes=4, n_slots=4, device="cpu",
                        dtype=dtype, mesh=mesh_, **kw)

        sharded, alone = server(mesh_=mesh), server()
        got = _port_serve(sharded, xs, 6, kind == "block")
        np.testing.assert_allclose(got, _port_serve(alone, xs, 6, kind == "block"), atol=SHARD_ATOL)
        np.testing.assert_allclose(got, ref[kind], atol=ATOL)
        if kind not in bf16_done:                           # bf16: the first route of each kind
            bf16_done.add(kind)
            got16 = _port_serve(server(torch.bfloat16, mesh), xs, 6, kind == "block")
            want16 = _port_serve(server(torch.bfloat16), xs, 6, kind == "block")
            _drift_rule(got16, want16, got, f"{fam} {kind} {kw} bf16")
        if kind == "frame":
            for srv in (sharded, alone):
                srv.reset_lanes([1, 2])
            x1 = xs[:, 0]
            np.testing.assert_allclose(sharded.step(x1)[0].numpy(), alone.step(x1)[0].numpy(),
                                       atol=SHARD_ATOL)
        else:
            assert sharded.blocks_consumed() == 2
            with pytest.raises(ValueError, match="a shard"):
                sharded.block_step(None, None, False, None)


def _jax_step(jax_params, fam, task, b, compute_dtype="f32"):
    """JAX `make_train_step` (SGD at lr 1) on the global batch: (the
    gradients, the metrics, the new model state)."""
    params, mstate = jax_params[fam]
    jtask = JTRN.TaskConfig(**{**dataclasses.asdict(task), "compute_dtype": compute_dtype})
    tx = optax.sgd(1.0)
    state = JTRN.TrainState.create(params, mstate, tx)
    args = (state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    with jax.default_matmul_precision("highest"):
        step = JTRN.make_train_step(jtask, JCFGS[fam], tx, donate=False)
        new, metrics = step.lower(*args).compile(FAST)(*args)
    grads = jax.tree.map(lambda a, n: np.asarray(a) - np.asarray(n), params, new.params)
    return grads, {k: float(v) for k, v in metrics.items()}, new.model_state


@pytest.mark.parametrize("fam", ["ls", "fs", "eda"])
def test_dp_step_matches_jax_on_the_global_batch(world, fam):
    """LS: both decoder routes against JAX's one step."""
    ranks = K.result(world["ranks"], "dp_case")
    grads, metrics, mstate = world["jax_steps"][fam]
    for name in ((fam, fam + "_fused") if fam == "ls" else (fam,)):
        for r, got in enumerate(ranks):
            got = got[name]
            for k in ("pit_loss", "emb_loss", "tot_loss", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][0][k], metrics[k], atol=ATOL,
                                           rtol=ATOL, err_msg=f"{name} rank {r} {k}")
            for k in ("speaker_scored", "diarization_error", "frames", "correct"):
                assert got["metrics"][0][k] == metrics[k], (name, r, k)
            _close_tree(got["grads"], grads, f"{name} rank {r} gradients", rel=ATOL)
            _close_tree(got["after"][1], mstate, f"{name} rank {r} BatchNorm statistics")
        _close_tree(ranks[1][name]["after"], ranks[0][name]["after"], f"{name} ranks", atol=0.0)


def _cos(a, b):
    a, b = np.concatenate([x.ravel() for x in _leaves(a)]), np.concatenate(
        [x.ravel() for x in _leaves(b)])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_dp_step_bf16_matches_jax(world):
    """FS with compute_dtype="bf16" over two ranks against JAX's bf16 step
    (and its float32 step for the drift rule)."""
    ranks = K.result(world["ranks"], "dp_case")
    g16, m16, _ = world["jax_steps"]["fs_bf16"]
    g32, m32, _ = world["jax_steps"]["fs"]
    floor = _cos(g16, g32) - 0.01
    for got in ranks:
        got = got["fs_bf16"]
        loss = got["metrics"][0]["tot_loss"]
        assert abs(loss - m32["tot_loss"]) <= 3 * abs(m16["tot_loss"] - m32["tot_loss"]) + 1e-3
        assert _cos(got["grads"], g16) >= floor
        assert all(np.asarray(x).dtype == np.float32 for x in _leaves(got["after"]))
    _close_tree(ranks[1]["fs_bf16"]["after"], ranks[0]["fs_bf16"]["after"], "ranks", atol=0.0)


def test_run_training_over_two_ranks_equals_one_process(world, tmp_path):
    """Two epochs, then a resume from the first epoch's checkpoint to a
    third: the parameters and the logged losses of one process."""
    import json

    ranks = K.result(world["ranks"], "training_case")
    assert ranks[1]["dir"] is None and ranks[0]["dir"] is not None
    final, ckpt_dir = K.run_training(None, tmp_path / "one", 2)
    ckpt = tmp_path / "one" / "toy" / "version_0" / "ckpt_epoch=0.npz"
    resumed, _ = K.run_training(None, tmp_path / "resumed", 3, resume_from=str(ckpt))
    for r in ranks:
        _close_tree(r["final"], final, "two epochs")
        _close_tree(r["resumed"], resumed, "resumed")

    def losses(d):
        lines = [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
        return [x["train/tot_loss"] for x in lines if "train/tot_loss" in x]

    two = K.Path(ranks[0]["dir"])
    np.testing.assert_allclose(losses(two), losses(ckpt_dir), atol=ATOL, rtol=ATOL)
    assert sorted(p.name for p in two.glob("ckpt_epoch=*.npz")) == \
        sorted(p.name for p in ckpt_dir.glob("ckpt_epoch=*.npz"))

    # cli.train with `dist_strategy: ddp` under the two ranks' world against
    # one process on the same config (the one-chip line; its run is version_1)
    from fseend_tpu_torch.cli import train as TT
    from fseend_tpu_torch.utils import checkpoint as CK

    out = K.result(world["ranks"], "cli_case")
    assert "mesh: 2 data x 1 model (2 processes)" in out[0]["stdout"]
    assert "epoch 0:" in out[0]["stdout"] and out[1]["stdout"] == ""
    TT.main(["--configs", str(world["out"] / "ls_ddp.yaml"), "--device", "cpu"])
    runs = world["out"] / "logs" / "ls_ddp"
    assert (runs / "version_0" / "avg_model.npz").exists()
    assert not (runs / "version_2").exists()
    _close_tree(CK.load_pytree(runs / "version_0" / "ckpt_epoch=0.npz", "params"),
                CK.load_pytree(runs / "version_1" / "ckpt_epoch=0.npz", "params"), "cli.train")
