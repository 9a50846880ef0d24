"""PyTorch port, sequence parallelism (`fseend_tpu_torch/parallel/sp.py`)
on a 2-rank gloo group on the CPU (spawned once for the file,
`tests/torch_port_ranks.py`), T = 32 split 16 + 16 (two LS chunks of 8 a
rank):

* the halo exchange, the halo'd causal conv and the global-batch train
  BatchNorm, forward and gradients, against the one-process ops;
* `sp_causal_mha`, `sp_retention_parallel` and `_sp_retention_chunkwise`
  on the "fused" (B4's plain version here), "core" (B5's) and "plain"
  routes against the JAX package's single-device functions, the
  chunkwise one also against JAX's own `_sp_retention_chunkwise` on a
  2-device mesh of the conftest's virtual devices; their gradients (x and
  the weights, summed over the ranks) against the one-process port's, the
  chunkwise ones including the part that reaches rank 0's frames through
  `kv0` from rank 1's objective;
* `ls_forward_sp_train` and `fs_forward_sp_train` against JAX's
  `ls_forward` / `fs_forward(train=True)` (logits, emb, the BatchNorm
  statistics), `fs_forward_sp` against JAX's `fs_forward` and its
  `fs_forward_sp` on the 2-device mesh;
* both SP train steps at dropout 0 against JAX's `make_train_step` (SGD at
  lr 1) on the same batch, LS on the "fused" and "core" routes: the loss,
  every gradient and the BatchNorm statistics; at dropout 0.1 the steps
  run, give finite losses and repeat.

Tolerances are `tests/test_sp.py`'s: 1e-5 for mha, parallel retention,
emb and the BatchNorm statistics, 2e-5 chunkwise retention, 1e-4 FS
logits, 2e-4 LS logits, each gradient 1e-5 of its largest element.  Two
are looser, for a stated reason: the loss rtol 1e-5 (test_sp.py holds 1e-6
between two JAX programs; two packages' float32 sums differ by more) and a
1e-7 floor under each gradient leaf's 1e-5 (leaves whose largest element
is a few 1e-3).  Outputs against the one-process port: 1e-6; gradients by
the same rule as against JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_port_ranks as K
from fseend_tpu.models import fs_eend as JF
from fseend_tpu.models import ls_eend as JL
from fseend_tpu.ops import nn as JNN
from fseend_tpu.ops import retention as JR
from fseend_tpu.parallel import mesh as JM
from fseend_tpu.parallel import sp as JSP
from fseend_tpu.train import trainer as JTRN
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}
LOSS_RTOL, GRAD_REL, GRAD_FLOOR = 1e-5, 1e-5, 1e-7
JLS = JL.LSEENDConfig(**{f.name: getattr(K.LS, f.name)
                         for f in dataclasses.fields(JL.LSEENDConfig) if hasattr(K.LS, f.name)})
JFS = JF.FSEENDConfig(**{f.name: getattr(K.FS, f.name)
                         for f in dataclasses.fields(JF.FSEENDConfig)
                         if f.name != "use_flash_attn"})
JRC = JR.RetentionConfig(embed_dim=K.LS.n_units, num_heads=K.LS.n_heads,
                         chunk_size=K.LS.chunk_size)


def _jit(f, *args):
    with jax.default_matmul_precision("highest"):
        return jax.jit(f).lower(*args).compile(FAST)(*args)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX parameters for LS and FS (random BatchNorm statistics), the
    port's models on them, and the ranks' results."""
    out = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(9)
    jax_params, models = {}, {}
    for i, (fam, init, cfg) in enumerate((("ls", JL.init_ls_eend, JLS),
                                          ("fs", JF.init_fs_eend, JFS))):
        params, mstate = init(jax.random.PRNGKey(10 + i), cfg)
        mstate = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.0, 0.5, a.shape)
                              .astype(np.float32), mstate)
        jax_params[fam] = (params, mstate)
        models[fam] = getattr(CV, f"{fam}_params_from_jax")(
            jax.tree.map(np.asarray, params), mstate, K.CFGS[fam], "cpu")
    torch.save(models, out / "models.pt")
    procs = K.start_ranks(K.SP_CASES, out)
    steps = {fam: _jax_step(jax_params, fam, task) for fam, task in (
        ("ls", JTRN.TaskConfig(model="ls", masked_emb_loss=True)),
        ("fs", JTRN.TaskConfig(model="fs")))}
    return {"out": out, "jax": jax_params, "jax_steps": steps,
            "ranks": K.join_ranks(procs, out)}


@pytest.fixture(scope="module")
def jmesh():
    return JM.make_mesh(n_data=K.WORLD, n_model=1, devices=jax.devices()[:K.WORLD])


def _ops(world):
    return K.sp_ops(torch.load(world["out"] / "models.pt", weights_only=False))


def _gathered(ranks, case, name, key="y"):
    return np.concatenate([np.asarray(r[name][key]) for r in K.result(ranks, case)], axis=1)


def _one_process(world, name):
    """The one-process port's output (gathered over the ranks' parts) and
    the gradients of the summed objective, for op `name`."""
    m, x, _, single, whole = _ops(world)[name]
    x = x.clone().requires_grad_()
    ys = [single(m, x, r) for r in range(K.WORLD)]
    total = sum((y * K.weights_of(y.shape, name, r)).sum() for r, y in enumerate(ys))
    (total / (K.WORLD if whole else 1)).backward()
    grads = {} if m is None else {k: p.grad for k, p in m.named_parameters()}
    return ys, x.grad, grads


def _close_grad(got, want, label):
    """test_sp.py's gradient rule: within 1e-5 of the leaf's largest
    element, plus the 1e-7 floor."""
    got, want = np.asarray(got), np.asarray(want)
    tol = GRAD_REL * float(np.abs(want).max()) + GRAD_FLOOR
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{label}: {err:.3e} > {tol:.3e}"


def _check_grads(world, name):
    ranks = K.result(world["ranks"], "sp_ops_case")
    ys, x_grad, grads = _one_process(world, name)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[name]["y"], ys[r].detach(), atol=1e-6, err_msg=name)
    _close_grad(sum(g[name]["x_grad"] for g in ranks), x_grad, f"{name} x")
    for k, g in grads.items():
        _close_grad(sum(r[name]["grads"][k] for r in ranks), g, f"{name} {k}")
    return ys, x_grad


def test_halo_conv_and_batch_norm_match_one_process(world):
    for name in ("halo", "conv", "batch_norm"):
        _check_grads(world, name)


def test_sp_causal_mha_and_retention_parallel_match_jax(world):
    jls, jfs = world["jax"]["ls"][0], world["jax"]["fs"][0]
    ops = _ops(world)
    for name, ref in (("mha", lambda x: JNN.mha(jfs["enc"]["layers"][0]["self_attn"], x, x, x,
                                                JNN.causal_mask(K.T)[None, None])),
                      ("retention_parallel", lambda x: JR.retention_parallel(
                          jls["enc"]["blocks"][0]["ret"], x, JRC))):
        _check_grads(world, name)
        want = _jit(ref, jnp.asarray(ops[name][1].numpy()))
        for got in K.result(world["ranks"], "sp_ops_case"):
            np.testing.assert_allclose(got[name]["y"], want, atol=1e-5, err_msg=name)


def test_sp_retention_chunkwise_matches_jax_on_every_route(world, jmesh):
    p = world["jax"]["ls"][0]["dec"]["layers"][0]["time_ret"]
    x = jnp.asarray(_ops(world)["chunkwise_plain"][1].numpy())
    want = _jit(lambda x: JR.retention_chunkwise(p, x, JRC), x)
    jax_sp = _jit(lambda x: jax.shard_map(
        lambda xl: JSP._sp_retention_chunkwise(p, xl, JRC, "data"), mesh=jmesh,
        in_specs=P(None, "data", None), out_specs=P(None, "data", None))(x), x)
    np.testing.assert_allclose(jax_sp, want, atol=2e-5)
    for route in K.ROUTES:
        got = _gathered(world["ranks"], "sp_ops_case", f"chunkwise_{route}")
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=route)
        np.testing.assert_allclose(got, jax_sp, atol=2e-5, err_msg=route)


def test_kv0_gradient_crosses_ranks(world):
    """On each route (B4's and B5's plain versions, the plain core): rank
    1's objective reaches rank 0's frames only through kv0 (the sum of the
    earlier ranks' chunk summaries, all-gathered); the summed gradients
    equal one process's, rank 0's own x gradient holds that cross part, and
    the cross part is not zero."""
    half = K.T // K.WORLD
    ranks = K.result(world["ranks"], "sp_ops_case")
    for route in K.ROUTES:
        name = f"chunkwise_{route}"
        _, x_grad = _check_grads(world, name)
        _close_grad(ranks[0][name]["x_grad"][:, :half], x_grad[:, :half], f"{route} rank 0")
        m, x, _, single, _ = _ops(world)[name]
        x = x.clone().requires_grad_()
        y1 = single(m, x, 1)
        (y1 * K.weights_of(y1.shape, name, 1)).sum().backward()
        assert float(x.grad[:, :half].abs().max()) > 1e-3, route


def _jax_forward(world, fam, b, train=True):
    params, mstate = world["jax"][fam]
    fwd = JL.ls_forward if fam == "ls" else JF.fs_forward
    cfg = JLS if fam == "ls" else JFS
    return _jit(lambda p, s, f, l: fwd(p, s, cfg, f, l, K.N_SLOTS, train=train), params,
                mstate, jnp.asarray(b["feats"]), jnp.asarray(b["lens"]))


def _close_state(got, want, atol=1e-5):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


@pytest.mark.parametrize("fam", ["ls", "fs"])
def test_forward_sp_train_matches_jax(world, fam):
    b = K.batch()
    want = _jax_forward(world, fam, b)
    ranks = K.result(world["ranks"], "sp_model_case")
    name = f"{fam}_forward"
    np.testing.assert_allclose(_gathered(world["ranks"], "sp_model_case", name, "logits"),
                               want["logits"], atol=2e-4 if fam == "ls" else 1e-4)
    np.testing.assert_allclose(_gathered(world["ranks"], "sp_model_case", name, "emb"),
                               want["emb"], atol=1e-5)
    for got in ranks:
        _close_state(got[name]["state"], want["state"])


def _jax_step(jax_params, fam, task):
    params, mstate = jax_params[fam]
    tx = optax.sgd(1.0)
    args = (JTRN.TrainState.create(params, mstate, tx),
            {k: jnp.asarray(v) for k, v in K.batch().items()}, jax.random.PRNGKey(0))
    with jax.default_matmul_precision("highest"):
        step = JTRN.make_train_step(task, JLS if fam == "ls" else JFS, tx, donate=False)
        new, metrics = step.lower(*args).compile(FAST)(*args)
    grads = jax.tree.map(lambda a, n: np.asarray(a) - np.asarray(n), params, new.params)
    return grads, {k: float(v) for k, v in metrics.items()}, new.model_state


@pytest.mark.parametrize("fam", ["ls", "fs"])
def test_sp_train_step_matches_jax(world, fam):
    """LS on the "fused" and "core" routes; then the steps at dropout 0.1."""
    grads, metrics, mstate = world["jax_steps"][fam]
    ranks = K.result(world["ranks"], "sp_model_case")
    for name in (("ls_step_fused", "ls_step_core") if fam == "ls" else ("fs_step",)):
        for r, got in enumerate(ranks):
            got = got[name]
            for k in ("pit_loss", "emb_loss", "tot_loss"):
                np.testing.assert_allclose(got["metrics"][0][k], metrics[k], rtol=LOSS_RTOL,
                                           err_msg=f"{name} rank {r} {k}")
            np.testing.assert_allclose(got["metrics"][0]["grad_norm"], metrics["grad_norm"],
                                       rtol=GRAD_REL)
            for i, (a, b) in enumerate(zip(jax.tree.leaves(got["grads"]),
                                           jax.tree.leaves(grads), strict=True)):
                _close_grad(a, b, f"{name} rank {r} leaf {i}")
            _close_state(got["after"][1], mstate)
        _close_state(ranks[1][name]["after"], ranks[0][name]["after"], atol=0.0)
    runs = [r[f"{fam}_dropout"] for r in ranks]
    for r in runs:
        assert r[0] == r[1] == runs[0][0]
        assert np.isfinite(r[0]["tot_loss"]) and r[0]["tot_loss"] != metrics["tot_loss"]


def test_fs_forward_sp_matches_jax_and_its_mesh_form(world, jmesh):
    params, mstate = world["jax"]["fs"]
    b = K.batch()
    xs = jnp.asarray(b["feats"])
    want = _jit(lambda p, s, x: JF.fs_forward(p, s, JFS, x, jnp.full((x.shape[0],), K.T),
                                              K.N_SLOTS)["logits"], params, mstate, xs)
    jax_sp = _jit(lambda p, s, x: JSP.fs_forward_sp(p, s, JFS, x, jmesh, K.N_SLOTS),
                  params, mstate, xs)
    np.testing.assert_allclose(jax_sp, want, atol=1e-4)
    for got in K.result(world["ranks"], "sp_model_case"):
        np.testing.assert_allclose(got["fs_forward_sp"], want, atol=1e-4)
        np.testing.assert_allclose(got["fs_forward_sp"], jax_sp, atol=1e-4)
