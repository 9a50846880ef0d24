"""Rank-side helpers of tests/test_torch_port_parallel.py,
tests/test_torch_port_sp.py and tests/test_torch_port_tp.py: a 2-rank gloo
group on the CPU (for the tensor-parallel file a 2 x 2 grid of 4 ranks, then
a 1 x 2 grid of the first two), spawned once per test file, runs that
file's cases and saves each rank's results; the
test process then holds them against the JAX package and the port's
single-process functions.  The test process makes the models (from the
JAX package's init, through the port's converters) and saves them where
the ranks load them; the batches come from seeds here.  This module
imports torch and the port only, so a rank starts in a few seconds."""

from __future__ import annotations

import copy
import dataclasses
import os
import socket
import traceback
from pathlib import Path

import numpy as np
import torch

from fseend_tpu_torch.models import eend_eda, fs_eend, ls_eend

LS = ls_eend.LSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=1,
                          chunk_size=8, ff_expansion=2, conv_kernel_size=5,
                          dec_dim_feedforward=64, conv_delay=3, max_nspks=4, dropout=0.0,
                          kernel="plain")
FS = fs_eend.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=1,
                          enc_dim_feedforward=64, dec_dim_feedforward=64, conv_delay=3,
                          max_nspks=4, dropout=0.0, use_flash_attn=False)
EDA = eend_eda.EDAConfig(in_size=23, n_units=32, n_heads=4, n_layers=2, dim_feedforward=64,
                         dropout=0.0, max_attractors=4)
CFGS = {"ls": LS, "fs": FS, "eda": EDA}
T = 32                            # 16 frames (two LS chunks) a rank under SP
LENS = (32, 26, 20, 29)          # unequal valid-frame counts on both ranks' rows
N_SPK = (2, 1, 2, 2)
S = 2
N_SLOTS = S + 2
WORLD = 2


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def batch(seed: int = 0, lens=LENS, n_spk=N_SPK) -> dict:
    """A global batch of len(lens) rows (numpy), labels zero past each row's
    length and speaker count."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    labels = (rng.uniform(size=(B, T, S)) > 0.55).astype(np.float32)
    for b in range(B):
        labels[b, :, n_spk[b]:] = 0.0
        labels[b, lens[b]:] = 0.0
    feats = (labels @ rng.standard_normal((S, LS.in_size))
             + 0.5 * rng.standard_normal((B, T, LS.in_size))).astype(np.float32)
    return {"feats": feats, "labels": labels, "lens": np.asarray(lens, np.int32),
            "n_spk": np.asarray(n_spk, np.int32)}


def tensors(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def to_jax(m):
    """(params, model_state) of a port model in the JAX layout (numpy)."""
    from fseend_tpu_torch.utils import convert

    fn = {ls_eend.LSEEND: convert.ls_params_to_jax, fs_eend.FSEEND: convert.fs_params_to_jax,
          eend_eda.EENDEDA: convert.eda_params_to_jax}[type(m)]
    return fn(m)


def grads_tree(m) -> dict:
    """The parameters' .grad in the JAX layout (numpy)."""
    g = copy.deepcopy(m)
    with torch.no_grad():
        for p, q in zip(g.parameters(), m.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return to_jax(g)[0]


def models(out_dir) -> dict:
    """The test process's models, {"ls", "fs", "eda"}: fresh copies."""
    return torch.load(Path(out_dir) / "models.pt", weights_only=False)


def train_step(mesh, m, cfg, task, b: dict, steps: int = 1, sp=None, opt=None):
    """`steps` steps of `task` (SGD at lr 1 unless `opt`) on the model `m`
    from batch `b` (the global batch; a data-parallel step takes the
    rank's rows of it; `sp` is a sequence-parallel step maker): the
    gradients of the last step and the model after it, in the JAX layout,
    and each step's metrics."""
    from fseend_tpu_torch.parallel import mesh as pmesh
    from fseend_tpu_torch.train import optim
    from fseend_tpu_torch.train import trainer as TRN

    tx = opt or optim.Optimizer("sgd", 1.0)
    state = TRN.TrainState.create(m, tx)
    b = tensors(b)
    if sp is not None:
        step = sp(task, cfg, tx, mesh, device="cpu")
    else:
        step = TRN.make_train_step(task, cfg, tx, mesh=mesh, device="cpu")
        if mesh is not None:
            b = pmesh.shard_batch(b, mesh)
    metrics = [{k: float(v) for k, v in step(state, b, 0)[1].items()} for _ in range(steps)]
    return {"grads": grads_tree(m), "after": to_jax(m), "metrics": metrics}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, cases, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    import torch.distributed as dist

    from fseend_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(device="cpu")
    results = {}
    for fn in cases:
        try:
            results[fn.__name__] = fn(mesh, out_dir)
        except Exception:        # reported by the test that reads the case
            results[fn.__name__] = {"error": traceback.format_exc()}
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def start_ranks(cases, out_dir, world: int = WORLD) -> list:
    """Every case (fn(mesh, out_dir) -> picklable results) on `world` gloo
    ranks of spawned processes, started: `join_ranks` collects them (the
    test process computes its references meanwhile)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, cases, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs: list, out_dir, timeout: float = 240.0) -> list:
    """Each rank's {case name: results}.  A case that raises on one rank
    leaves the other waiting in a collective: the timeout ends both."""
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode for p in procs):
        raise RuntimeError(f"ranks: exit codes {[p.exitcode for p in procs]}"
                           + (" (killed at the timeout)" if alive else ""))
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def result(ranks: list, name: str) -> list:
    """Each rank's results of case `name`; a case that raised fails here
    with its traceback."""
    got = [r[name] for r in ranks]
    for g in got:
        if isinstance(g, dict) and "error" in g:
            raise AssertionError(g["error"])
    return got


# ---------------------------------------------------------------------------
# cases of tests/test_torch_port_parallel.py
# ---------------------------------------------------------------------------

SHAPE = (2, 6, 3)
COLLECTIVES = ("psum", "gather", "shift_right", "shift_left", "halo")


def collectives_case(mesh, out_dir):
    """Each collective on a rank-seeded x, backpropagated against
    rank-seeded weights; the data-parallel helpers."""
    from fseend_tpu_torch.parallel import collectives as C

    g, r = mesh.group, mesh.rank
    gen = torch.Generator().manual_seed(100 + r)
    x = torch.randn(SHAPE, generator=gen).requires_grad_()
    outs = {"psum": C.psum(x, g), "gather": C.all_gather(x, g, dim=1),
            "shift_right": C.shift(x, 1, g), "shift_left": C.shift(x, -1, g),
            "halo": C.halo_exchange(x, 2, g)}
    w = {k: torch.randn(o.shape, generator=gen) for k, o in outs.items()}
    sum((o * w[k]).sum() for k, o in outs.items()).backward()
    with C.data_parallel(g):
        helpers = {"batch_sum": C.batch_sum(torch.tensor(r + 1.0)),
                   "batch_mean": C.batch_mean(x.detach()[: r + 1]),
                   "moments": C.batch_moments(x.detach()[: r + 1], g)}
    outside = C.batch_sum(torch.tensor(r + 1.0))
    sums = C.sum_scalars({"a": torch.tensor(r + 1), "b": torch.tensor(0.5 * r)}, g)
    ts = [torch.full((3,), float(r)), torch.arange(4, dtype=torch.float64) * (r + 1)]
    C.all_reduce_(ts, g)
    return {"x": x.detach(), "w": w, "outs": {k: o.detach() for k, o in outs.items()},
            "grad": x.grad, "helpers": helpers, "outside": outside, "sums": sums, "ts": ts,
            "index": C.axis_index(g), "size": C.axis_size(g)}


def mesh_case(mesh, out_dir):
    """The mesh's fields, this rank's rows of the global batch and the
    errors of an impossible mesh."""
    from fseend_tpu_torch.parallel import mesh as pmesh

    errors = {}
    for name, kw in (("model", dict(n_model=3)), ("data", dict(n_data=3)),
                     ("backend", dict(device="cuda"))):
        try:
            pmesh.make_mesh(**{"device": "cpu", **kw})
        except (NotImplementedError, ValueError) as e:
            errors[name] = (type(e).__name__, str(e))
    local = pmesh.shard_batch(tensors(batch()), mesh)
    return {"shape": (mesh.n_data, mesh.n_model), "rank": mesh.rank,
            "device": str(mesh.device), "lens": local["lens"].numpy(),
            "feats": local["feats"].numpy(), "errors": errors,
            "model_axis": grid_fields(pmesh.make_mesh(device="cpu", n_model=2))}


def grid_fields(mesh) -> dict:
    """A mesh of processes' coordinates and the global ranks of its groups."""
    import torch.distributed as dist

    return {"shape": (mesh.n_data, mesh.n_model), "d": mesh.d, "m": mesh.m,
            "global": mesh.global_rank, "main": mesh.main,
            "model": dist.get_process_group_ranks(mesh.model_group),
            "data": dist.get_process_group_ranks(mesh.data_group)}


def dp_cases() -> dict:
    """name -> (family, config, TaskConfig) of the data-parallel steps."""
    from fseend_tpu_torch.train.trainer import TaskConfig

    ls_task = TaskConfig(model="ls", masked_emb_loss=True)
    return {"ls": ("ls", LS, ls_task),
            "ls_fused": ("ls", replace(LS, use_fused_dec=True, kernel="fused"), ls_task),
            "fs": ("fs", FS, TaskConfig(model="fs", label_mode="spk_pit")),
            "eda": ("eda", EDA, TaskConfig(model="eda")),
            "fs_bf16": ("fs", FS, TaskConfig(model="fs", label_mode="spk_pit",
                                             compute_dtype="bf16"))}


def dp_case(mesh, out_dir):
    ms = models(out_dir)
    return {name: train_step(mesh, copy.deepcopy(ms[fam]), cfg, task, batch())
            for name, (fam, cfg, task) in dp_cases().items()}


class ToyData:
    """An in-memory dataset of `n` recordings of 20 to 32 frames, 2
    speakers, from `seed`."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            t = int(rng.integers(20, T + 1))
            labels = (rng.uniform(size=(t, S)) > 0.5).astype(np.float32)
            feats = (labels @ rng.standard_normal((S, LS.in_size))
                     + 0.5 * rng.standard_normal((t, LS.in_size))).astype(np.float32)
            self.items.append((feats, labels, f"toy{i}"))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def run_training(mesh, root, max_epochs: int, resume_from=None, family: str = "ls",
                 tx=None):
    """`run_training` of the family's toy config (LS by default; SGD unless
    `tx`) on ToyData, batch 4: with `mesh` over its ranks, global rank 0
    logging under `root`.  Returns the whole model (JAX layout) and the
    checkpoint dir."""
    from fseend_tpu_torch.train import loop as LOOP
    from fseend_tpu_torch.train import optim
    from fseend_tpu_torch.train.trainer import TaskConfig

    logger = LOOP.MetricsLogger(str(root), "toy") if mesh is None or mesh.main else None
    task = TaskConfig(model="ls", masked_emb_loss=True) if family == "ls" else \
        TaskConfig(model=family)
    state, ckpt_dir = LOOP.run_training(
        task=task, model_cfg=CFGS[family],
        train_dataset=ToyData(10, 1), val_dataset=ToyData(3, 2),
        tx=tx or optim.build_optimizer("sgd", 0.05, grad_clip=5.0), logger=logger,
        batch_size=4, chunk_size=T, max_speakers=S, input_dim=LS.in_size,
        max_epochs=max_epochs, seed=3, mesh=mesh, resume_from=resume_from, log_every=1,
        device="cpu")
    return to_jax(LOOP.whole_state(state, mesh).model), ckpt_dir


def training_case(mesh, out_dir):
    """Two epochs over two ranks, then a resume from the first epoch's
    checkpoint to a third."""
    import torch.distributed as dist

    root = Path(out_dir) / "two_ranks"
    final, ckpt_dir = run_training(mesh, root, 2)
    dist.barrier()                       # rank 0 has written the checkpoints
    ckpt = root / "toy" / "version_0" / "ckpt_epoch=0.npz"
    resumed, _ = run_training(mesh, Path(out_dir) / "resumed", 3, resume_from=str(ckpt))
    return {"final": final, "resumed": resumed, "dir": None if ckpt_dir is None
            else str(ckpt_dir)}


def write_cli_world(root: Path) -> Path:
    """A Kaldi directory of 2 recordings of 6 s (a low and a high tone over
    noise, 8 kHz) and an LS yaml config at the test widths with
    `dist_strategy: ddp`, global batch 2; returns the config's path."""
    import wave

    import yaml

    kd = root / "kaldi"
    kd.mkdir(parents=True)
    rng, sr, dur = np.random.default_rng(0), 8000, 6.0
    t = np.arange(int(sr * dur)) / sr
    files = {k: [] for k in ("wav.scp", "segments", "utt2spk", "reco2dur")}
    for r in range(2):
        rec = f"rec{r}"
        audio = 0.01 * rng.standard_normal(len(t))
        for s, (f0, st, ed) in enumerate(((220.0, 0.5 + r, 3.5 + r), (1400.0, 2.5, 5.5))):
            audio += ((t >= st) & (t < ed)) * 0.3 * np.sin(2 * np.pi * f0 * t)
            files["segments"].append(f"{rec}_s{s} {rec} {st:.2f} {ed:.2f}")
            files["utt2spk"].append(f"{rec}_s{s} {rec}_spk{s}")
        with wave.open(str(kd / f"{rec}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
        files["wav.scp"].append(f"{rec} {kd / f'{rec}.wav'}")
        files["reco2dur"].append(f"{rec} {dur}")
    for k, lines in files.items():
        (kd / k).write_text("\n".join(lines) + "\n")
    feat = {"sample_rate": sr, "win_length": 200, "n_fft": 1024, "hop_length": 80,
            "n_mels": 23}
    config = {
        "log": {"model_name": "ls_ddp", "log_dir": str(root / "logs" / "ls_ddp")},
        "training": {"batch_size": 2, "max_epochs": 1, "opt": "sgd", "lr": 0.05,
                     "grad_clip": 5, "seed": 777, "dist_strategy": "ddp"},
        "model": {"arch": "ls_eend_conformer_retention", "params": {
            "n_units": 32, "n_heads": 4, "enc_n_layers": 2, "dec_n_layers": 1,
            "feed_forward_expansion_factor": 2, "dec_dim_feedforward": 64,
            "conv_kernel_size": 5, "recurrent_chunk_size": 8, "dropout": 0.0,
            "conv_delay": 3, "use_fused_dec": True, "fused_dec_chunk": 8}},
        "data": {"max_speakers": 2, "context_recp": 0, "label_delay": 0, "chunk_size": 40,
                 "subsampling": 10, "use_last_samples": True, "feat": feat,
                 "feat_type": "logmel23_cummn", "train_data_dir": str(kd),
                 "val_data_dir": str(kd)},
        "task": {"label_mode": "fixed"},
        "debug": {"limit_train_batches": 2, "limit_val_batches": 1}}
    path = root / "ls_ddp.yaml"
    path.write_text(yaml.safe_dump(config))
    return path


def cli_case(mesh, out_dir):
    """`cli.train` on the ddp config over the two ranks (the test process
    wrote it): each rank's standard output."""
    import contextlib
    import io

    from fseend_tpu_torch.cli import train as TT

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TT.main(["--configs", str(Path(out_dir) / "ls_ddp.yaml"), "--device", "cpu"])
    return {"stdout": buf.getvalue()}


PARALLEL_CASES = [collectives_case, mesh_case, dp_case, training_case, cli_case]


# ---------------------------------------------------------------------------
# cases of tests/test_torch_port_sp.py
# ---------------------------------------------------------------------------

ROUTES = ("fused", "core", "plain")


def sp_ops(ms: dict) -> dict:
    """name -> (the module whose parameters the op reads, its input x
    (2, T, width), the op under SP (module, rank's or global x, mesh) ->
    the rank's output, the op on one process (module, x, rank) -> what
    rank `rank` must return, whether the SP op takes the global x).  The
    parameters are the test models' (LS block 0, FS encoder layer 0)."""
    from fseend_tpu_torch.ops import nn as tnn
    from fseend_tpu_torch.ops import retention as R
    from fseend_tpu_torch.parallel import collectives as C
    from fseend_tpu_torch.parallel import sp as SP

    ls, fs = ms["ls"], ms["fs"]
    D = LS.n_units
    half = T // WORLD

    def mine(y, r, extra=0):
        return y[:, r * half:(r + 1) * half + extra]

    def x_of(seed, width=D):
        return torch.randn(2, T, width, generator=torch.Generator().manual_seed(seed))

    ops = {
        "halo": (None, x_of(1, 8), lambda m, x, mesh: C.halo_exchange(x, 3, mesh.group),
                 lambda m, x, r: mine(torch.nn.functional.pad(x, (0, 0, 3, 3)), r, 6), False),
        "conv": (ls.enc.blocks[0].conv.dw, x_of(2),
                 lambda m, x, mesh: SP._halo_causal_conv(m.weight, x, mesh.group),
                 lambda m, x, r: mine(tnn.causal_depthwise_conv(x, m.weight), r), False),
        "batch_norm": (ls.enc.blocks[0].conv.bn, x_of(3),
                       lambda m, x, mesh: SP._sp_batch_norm_train(x, m, mesh.group)[0],
                       lambda m, x, r: mine(tnn.batch_norm_train(x, m)[0], r), False),
        "mha": (fs.enc.layers[0].self_attn, x_of(4),
                lambda m, x, mesh: SP.sp_causal_mha(m, x, mesh),
                lambda m, x, r: tnn.mha(m, x, x, x, mask=tnn.causal_mask(T)), True),
        "retention_parallel": (ls.enc.blocks[0].ret, x_of(5),
                               lambda m, x, mesh: SP.sp_retention_parallel(m, x, LS.ret_cfg,
                                                                           mesh),
                               lambda m, x, r: R.retention_parallel(m, x, LS.ret_cfg), True),
    }
    for route in ROUTES:
        rc = replace(LS.ret_cfg, kernel=route)
        ops[f"chunkwise_{route}"] = (
            ls.dec.layers[0].time_ret, x_of(6),
            lambda m, x, mesh, rc=rc: SP._sp_retention_chunkwise(m, x, rc, mesh.group),
            lambda m, x, r, rc=rc: mine(R.retention_chunkwise(m, x, rc), r), False)
    return ops


def weights_of(y_shape, name: str, r: int):
    """The objective's weights on rank r's output of op `name`."""
    seed = 1000 + 17 * r + sum(map(ord, name))
    return torch.randn(y_shape, generator=torch.Generator().manual_seed(seed))


def sp_ops_case(mesh, out_dir):
    """Each op's output and the gradients of the rank's objective (its
    output against its weights; a gathered output divided by the number of
    ranks, as every rank holds it) for x and the module's parameters."""
    ms = models(out_dir)
    half, r, res = T // WORLD, mesh.rank, {}
    for name, (m, x, fn, _, whole) in sp_ops(ms).items():
        for p in [] if m is None else m.parameters():
            p.grad = None
        x = x.clone().requires_grad_()
        y = fn(m, x if whole else x[:, r * half:(r + 1) * half], mesh)
        ((y * weights_of(y.shape, name, r)).sum() / (WORLD if whole else 1)).backward()
        res[name] = {"y": y.detach(), "x_grad": x.grad,
                     "grads": {} if m is None else {k: p.grad.clone()
                                                    for k, p in m.named_parameters()}}
    return res


def sp_model_case(mesh, out_dir):
    """The SP train passes, the SP train steps on the kernel routes (one
    SGD step at lr 1), fs_forward_sp, and the steps at dropout 0.1 twice."""
    from fseend_tpu_torch.parallel import sp as SP
    from fseend_tpu_torch.train.trainer import TaskConfig

    ms = models(out_dir)
    b = tensors(batch())
    ls_task, fs_task = TaskConfig(model="ls", masked_emb_loss=True), TaskConfig(model="fs")

    def fwd(out):
        return {k: out[k].detach() for k in ("logits", "emb")} | {"state": out["state"]}

    res = {"ls_forward": fwd(SP.ls_forward_sp_train(ms["ls"], b["feats"], b["lens"], mesh,
                                                    N_SLOTS)),
           "fs_forward": fwd(SP.fs_forward_sp_train(ms["fs"], b["feats"], b["lens"], mesh,
                                                    N_SLOTS)),
           "fs_forward_sp": SP.fs_forward_sp(ms["fs"], b["feats"], mesh, N_SLOTS)}
    for route in ("fused", "core"):
        res[f"ls_step_{route}"] = train_step(mesh, copy.deepcopy(ms["ls"]),
                                             replace(LS, kernel=route), ls_task, batch(),
                                             sp=SP.make_ls_train_step_sp)
    res["fs_step"] = train_step(mesh, copy.deepcopy(ms["fs"]), FS, fs_task, batch(),
                                sp=SP.make_fs_train_step_sp)
    for fam, task, make in (("ls", ls_task, SP.make_ls_train_step_sp),
                            ("fs", fs_task, SP.make_fs_train_step_sp)):
        cfg = replace(CFGS[fam], dropout=0.1)
        res[f"{fam}_dropout"] = [train_step(mesh, copy.deepcopy(ms[fam]), cfg, task, batch(),
                                            sp=make)["metrics"][0] for _ in range(2)]
    return res


SP_CASES = [sp_ops_case, sp_model_case]


# ---------------------------------------------------------------------------
# cases of tests/test_torch_port_tp.py: a 2 x 2 grid, then 1 x 2
# ---------------------------------------------------------------------------

GRIDS = ((2, 2), (1, 2))          # (n_data, n_model)


def _grid_main(rank: int, phases, out_dir: str) -> None:
    """Each phase ((n_data, n_model), port, cases) whose grid holds this rank:
    a process group of its own, the mesh over it, the cases, results saved
    under "<n_data>x<n_model>/<case>"."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from fseend_tpu_torch.parallel import mesh as pmesh

    results = {}
    for (n_data, n_model), port, cases in phases:
        world = n_data * n_model
        if rank >= world:
            continue
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                          WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        mesh = pmesh.make_mesh(n_data, n_model, device="cpu")
        for fn in cases:
            try:
                results[f"{n_data}x{n_model}/{fn.__name__}"] = fn(mesh, out_dir)
            except Exception:    # reported by the test that reads the case
                results[f"{n_data}x{n_model}/{fn.__name__}"] = {"error": traceback.format_exc()}
        dist.destroy_process_group()
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")


def start_grid_ranks(phases, out_dir) -> list:
    """`start_ranks` for grids: phases [((n_data, n_model), cases)], run in
    order by the ranks each grid holds, in one set of spawned processes."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    phases = [(grid, _free_port(), cases) for grid, cases in phases]
    world = max(nd * nm for (nd, nm), _, _ in phases)
    procs = [ctx.Process(target=_grid_main, args=(r, phases, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def tp_cases() -> dict:
    """name -> (family, config, TaskConfig) of the tensor-parallel steps: LS
    on the "plain" and "core" retention routes and on "fused" with the
    fused decoder (B4's and B3's plain versions here), FS, EEND-EDA."""
    from fseend_tpu_torch.train.trainer import TaskConfig

    ls_task = TaskConfig(model="ls", masked_emb_loss=True)
    return {"ls_plain": ("ls", LS, ls_task),
            "ls_core": ("ls", replace(LS, kernel="core"), ls_task),
            "ls_fused": ("ls", replace(LS, kernel="fused", use_fused_dec=True), ls_task),
            "fs": ("fs", FS, TaskConfig(model="fs", label_mode="spk_pit")),
            "eda": ("eda", EDA, TaskConfig(model="eda"))}


ADAM_CLIP = dict(kind="adam", lr=1e-3, eps=1e-3, grad_clip=0.05)


def tp_train_step(mesh, m, cfg, task, b: dict, steps: int = 1, opt=None):
    """`train_step` with `m` sharded over the mesh's model axis first: the
    gradients and the model gathered whole (JAX layout), each step's
    metrics, and how many parameters were split."""
    from fseend_tpu_torch.parallel import collectives as C
    from fseend_tpu_torch.parallel import mesh as pmesh
    from fseend_tpu_torch.train import optim
    from fseend_tpu_torch.train import trainer as TRN

    pmesh.shard_model_(m, mesh)
    tx = opt or optim.Optimizer("sgd", 1.0)
    state = TRN.TrainState.create(m, tx)
    step = TRN.make_train_step(task, cfg, tx, mesh=mesh, device="cpu")
    local = pmesh.shard_batch(tensors(b), mesh)
    metrics = [{k: float(v) for k, v in step(state, local, 0)[1].items()} for _ in range(steps)]
    shards = list(C.param_shards(m).values())
    whole = pmesh.gather_model(m, mesh)
    grads = pmesh.gather_full([torch.zeros_like(p) if p.grad is None else p.grad
                               for p in m.parameters()], shards, mesh)
    g = copy.deepcopy(whole)
    with torch.no_grad():
        for p, q in zip(g.parameters(), grads):
            p.copy_(q)
    return {"grads": to_jax(g)[0], "after": to_jax(whole), "metrics": metrics,
            "split": sum(s is not None for s in shards)}


def tp_step_case(mesh, out_dir):
    """One SGD step (lr 1) of each `tp_cases` entry, and two Adam steps
    with an active clip (LS "plain")."""
    from fseend_tpu_torch.train import optim

    ms = models(out_dir)
    res = {name: tp_train_step(mesh, copy.deepcopy(ms[fam]), cfg, task, batch())
           for name, (fam, cfg, task) in tp_cases().items()}
    fam, cfg, task = tp_cases()["ls_plain"]
    res["adam_clip"] = tp_train_step(mesh, copy.deepcopy(ms[fam]), cfg, task, batch(), 2,
                                     optim.Optimizer(**ADAM_CLIP))
    return res


FFN_X = (2, 5, 32)


def ffn_pair(ms):
    """The FFN of FS encoder layer 0 with its input and the objective's
    weights."""
    gen = torch.Generator().manual_seed(11)
    layer = ms["fs"].enc.layers[0]
    x = torch.randn(FFN_X, generator=gen)
    w = torch.randn(FFN_X, generator=gen)
    return layer, x, w


def sp_model_axis_case(mesh, out_dir):
    """The FS sequence-parallel step over the "model" axis (the time axis
    split over the model group), one SGD step at lr 1."""
    from fseend_tpu_torch.parallel import sp as SP
    from fseend_tpu_torch.train.trainer import TaskConfig

    def make(task, cfg, tx, mesh, device):
        return SP.make_fs_train_step_sp(task, cfg, tx, mesh, axis="model", device=device)

    return train_step(mesh, copy.deepcopy(models(out_dir)["fs"]), FS, TaskConfig(model="fs"),
                      batch(), sp=make)


def tp_transpose_case(mesh, out_dir):
    """Megatron's FFN pair on this rank's shards against an objective of its
    (replicated) output: the gradients of x and of the whole linears, with
    the model-axis transposes and with a psum's (the data axis' transpose:
    its backward sums the cotangents over the ranks) at the row-parallel
    output."""
    from fseend_tpu_torch.ops import nn as tnn
    from fseend_tpu_torch.parallel import collectives as C
    from fseend_tpu_torch.parallel import mesh as pmesh

    layer, x0, w = ffn_pair(models(out_dir))
    out = {}
    for name in ("megatron", "psum"):
        lay = pmesh.shard_model_(copy.deepcopy(layer), mesh)
        x = x0.clone().requires_grad_()
        orig = C.reduce_from_model
        if name == "psum":
            C.reduce_from_model = lambda t: C.psum(t, C.model_group())
        try:
            with C.model_parallel(mesh.model_group):
                y = tnn.ff_block(x, lay.linear1, lay.linear2)
                (y * w).sum().backward()
        finally:
            C.reduce_from_model = orig
        ps = [lay.linear1.weight, lay.linear1.bias, lay.linear2.weight, lay.linear2.bias]
        shards = [C.shards_of(m).get(a) for m, a in ((lay.linear1, "weight"),
                                                   (lay.linear1, "bias"),
                                                   (lay.linear2, "weight"),
                                                   (lay.linear2, "bias"))]
        out[name] = {"y": y.detach(), "x": x.grad,
                     "params": pmesh.gather_full([p.grad for p in ps], shards, mesh)}
    return out


def grid_case(mesh, out_dir):
    """The grid's fields and groups, this rank's rows and the partition."""
    from fseend_tpu_torch.parallel import mesh as pmesh

    local = pmesh.shard_batch(tensors(batch()), mesh)
    ms = models(out_dir)
    return {**grid_fields(mesh), "lens": local["lens"].numpy(),
            "partition": {fam: pmesh.param_partition(m, mesh) for fam, m in ms.items()}}


def tp_training_case(mesh, out_dir):
    """FS `run_training` over the grid (Adam as ADAM_CLIP without the clip,
    2 epochs), then a resume from the first epoch's checkpoint to a third."""
    import torch.distributed as dist

    from fseend_tpu_torch.train import optim

    tx = optim.Optimizer(**{**ADAM_CLIP, "grad_clip": 5.0})
    root = Path(out_dir) / "tp_fs"
    final, ckpt_dir = run_training(mesh, root, 2, family="fs", tx=tx)
    dist.barrier()                       # global rank 0 has written the checkpoints
    ckpt = root / "toy" / "version_0" / "ckpt_epoch=0.npz"
    resumed, _ = run_training(mesh, Path(out_dir) / "tp_fs_resumed", 3, resume_from=str(ckpt),
                              family="fs", tx=tx)
    return {"final": final, "resumed": resumed,
            "dir": None if ckpt_dir is None else str(ckpt_dir)}


def tp_cli_case(mesh, out_dir):
    """`cli.train` on a `mesh: {model: 2}` config (the test process wrote
    it): each rank's standard output."""
    import contextlib
    import io

    from fseend_tpu_torch.cli import train as TT

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TT.main(["--configs", str(Path(out_dir) / "ls_tp.yaml"), "--device", "cpu"])
    return {"stdout": buf.getvalue()}


TP_PHASES = [((2, 2), [grid_case, tp_step_case, tp_training_case]),
             ((1, 2), [grid_case, tp_step_case, tp_transpose_case, sp_model_axis_case,
                       tp_cli_case])]
