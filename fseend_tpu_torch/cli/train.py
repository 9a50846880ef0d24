"""Training entry point, the port's twin of the root `cli/train.py`: one
yaml config drives LS-EEND, FS-EEND or EEND-EDA training.

  python -m fseend_tpu_torch.cli.train --configs configs/ls_simu.yaml
  python -m fseend_tpu_torch.cli.train --configs configs/ls_simu.yaml --test_from_folder DIR
  python -m fseend_tpu_torch.cli.train --configs ... --checkpoint_resume CKPT [--device cpu]

The model config takes every field from the yaml, with the JAX CLI's
defaults where the yaml is silent: the LS retention route is "fused" for
`use_fused_ret: true`, "core" for `use_pallas: true` and "plain" otherwise;
FS `use_flash_attn` defaults to False.  (The port's dataclasses default to
the kernel routes; the JAX package's to XLA.)  `training.precision: bf16`
trains LS-EEND and FS-EEND in mixed precision (`TaskConfig(compute_dtype=
"bf16")`: bf16 forward and backward, float32 parameters, moments and
checkpoints); EEND-EDA reads no precision, as the JAX CLI.

A `dist_strategy: ddp` or `mesh:` block trains over the processes torchrun
starts, one per card: data parallel, and with `mesh: {data: D, model: M}`
on a D x M grid whose "model" axis splits the large projections (tensor
parallelism; D defaults to the process count over M):

  torchrun --nproc_per_node 4 -m fseend_tpu_torch.cli.train --configs configs/ls_simu.yaml

(`parallel/mesh.py`; `training.batch_size` is the global batch, global
rank 0 logs and writes the checkpoints, whole).  With one process it
prints the JAX CLI's single-chip line and trains on the one card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fseend_tpu_torch.cli.common import add_device_arg, feature_config, seed_of, val_dataset


def _ls_route(p: dict) -> str:
    """The JAX config's kernel flags -> the port's chunkwise route (the
    whole-layer kernel wins, as in `fseend_tpu/ops/retention.py`)."""
    if p.get("use_fused_ret", False):
        return "fused"
    return "core" if p.get("use_pallas", False) else "plain"


def build_model(configs):
    """(model config, make_model(generator, device), TaskConfig) from the
    config's model.arch."""
    from fseend_tpu_torch.models import eend_eda, fs_eend, ls_eend
    from fseend_tpu_torch.train import trainer as trainer_lib

    arch = configs["model"]["arch"]
    p = dict(configs["model"].get("params") or {})
    data = configs["data"]
    in_size = (2 * data["context_recp"] + 1) * data["feat"]["n_mels"]
    max_spk = data["max_speakers"]
    task_cfg = configs.get("task", {})
    label_mode = task_cfg.get("label_mode", "fixed")
    precision = configs.get("training", {}).get("precision", "f32")
    consis = task_cfg.get("spk_attractor", {}).get("consis_weight", 1.0)

    if arch.startswith("ls") or "conformer" in arch:
        cfg = ls_eend.LSEENDConfig(
            in_size=in_size, n_units=p.get("n_units", 256),
            n_heads=p.get("n_heads", 4), enc_n_layers=p.get("enc_n_layers", 4),
            dec_n_layers=p.get("dec_n_layers", 2), dropout=p.get("dropout", 0.1),
            chunk_size=p.get("recurrent_chunk_size", 500),
            ff_expansion=p.get("feed_forward_expansion_factor", 4),
            conv_expansion=p.get("conv_expansion_factor", 2),
            conv_kernel_size=p.get("conv_kernel_size", 16),
            dec_dim_feedforward=p.get("dec_dim_feedforward", 2048),
            conv_delay=p.get("conv_delay", 9), max_nspks=max_spk + 2,
            kernel=_ls_route(p), use_fused_dec=p.get("use_fused_dec", False),
            fused_dec_chunk=p.get("fused_dec_chunk"), remat=p.get("remat", False))
        init = ls_eend.init_ls_eend
        task = trainer_lib.TaskConfig(
            model="ls", label_mode=label_mode, masked_emb_loss=True,
            compute_dtype=precision, label_delay=data.get("label_delay", 0),
            consis_weight=consis)
    elif "eda" in arch or "offl" in arch:
        cfg = eend_eda.EDAConfig(
            in_size=in_size, n_units=p.get("n_units", 256),
            n_heads=p.get("n_heads", 4), n_layers=p.get("enc_n_layers", 4),
            dropout=p.get("dropout", 0.1))
        init = eend_eda.init_eend_eda
        task = trainer_lib.TaskConfig(model="eda", label_mode="pit")
    else:
        cfg = fs_eend.FSEENDConfig(
            in_size=in_size, n_units=p.get("n_units", 256),
            n_heads=p.get("n_heads", 4), enc_n_layers=p.get("enc_n_layers", 4),
            dec_n_layers=p.get("dec_n_layers", 2), dropout=p.get("dropout", 0.1),
            enc_dim_feedforward=p.get("enc_dim_feedforward", 2048),
            dec_dim_feedforward=p.get("dec_dim_feedforward", 2048),
            conv_delay=p.get("conv_delay", 9), mask_delay=p.get("mask_delay", 0),
            max_nspks=max_spk + 2, use_flash_attn=p.get("use_flash_attn", False))
        init = fs_eend.init_fs_eend
        task = trainer_lib.TaskConfig(
            model="fs", label_mode=label_mode, compute_dtype=precision,
            label_delay=data.get("label_delay", 0), consis_weight=consis)

    def make_model(generator: torch.Generator, device=None):
        return init(cfg, generator, device=device)

    return cfg, make_model, task


def _n_devices() -> int:
    """The processes of the run, one per card: torchrun's WORLD_SIZE, 1
    without a launcher (the JAX CLI counts jax.devices())."""
    return int(os.environ.get("WORLD_SIZE", "1"))


@torch.no_grad()
def evaluate_folder(configs, folder, device="cuda"):
    """The reference's --test_from_folder path: average the folder's epoch
    checkpoints, run the test pass over the validation set with
    max_speakers + 2 attractor slots in batches, print the frame-level DER
    table and write one probability h5 per recording."""
    from fseend_tpu_torch.data.loader import batched
    from fseend_tpu_torch.models import fs_eend, ls_eend
    from fseend_tpu_torch.train import labels as labels_lib
    from fseend_tpu_torch.train import loop, losses, trainer as trainer_lib
    from fseend_tpu_torch.utils import convert
    from fseend_tpu_torch.utils.postprocess import save_h5_probs

    device = ls_eend.resolve_device(device)
    data = configs["data"]
    feat = feature_config(data)
    ds = val_dataset(data, feat)
    model_cfg, make_model, task = build_model(configs)
    if task.model == "eda":
        raise ValueError("--test_from_folder scores LS-EEND and FS-EEND; stream EEND-EDA "
                         "with fseend_tpu_torch.cli.stb_eval")
    model = make_model(torch.Generator().manual_seed(seed_of(configs, 0)), device)
    try:
        params, mstate, paths = loop.average_epoch_range(
            folder, configs["log"].get("start_epoch"), configs["log"].get("end_epoch"))
    except FileNotFoundError:
        pass
    else:
        from_jax = convert.ls_params_from_jax if task.model == "ls" else \
            convert.fs_params_from_jax
        model = from_jax(params, mstate, model_cfg, device)
        print(f"averaged {len(paths)} checkpoints from {folder}")

    test_fn = ls_eend.ls_test if task.model == "ls" else fs_eend.fs_test
    S = data["max_speakers"]
    h5_dir = os.path.join(folder, "preds_h5")
    os.makedirs(h5_dir, exist_ok=True)
    eval_bs = int(configs.get("training", {}).get("val_batch_size")
                  or configs.get("training", {}).get("batch_size", 8))
    ms = []
    per_rec: dict[str, list] = {}
    for batch in batched(ds, range(len(ds)), eval_bs, data["chunk_size"], S,
                         feat.input_dim, drop_last=False):
        recs = batch.pop("recs")
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        out = test_fn(model, b["feats"], b["lens"], S + 2)
        slot_labels, _ = labels_lib.prepare_labels(b["labels"], b["lens"], b["n_spk"])
        # frame-level DER over the real-speaker slots
        stats = losses.diarization_error_counters(
            out["logits"][..., 1:1 + S], slot_labels[..., 1:1 + S], b["lens"],
            torch.arange(S, device=device)[None] < b["n_spk"][:, None])
        ms.append({k: float(v) for k, v in stats.items()})
        probs_all = torch.sigmoid(out["logits"][..., 1:]).cpu().numpy()
        lens_np = b["lens"].cpu().numpy()
        for i, rec in enumerate(recs):
            per_rec.setdefault(rec, []).append(probs_all[i, : lens_np[i]])
    for rec, parts in per_rec.items():
        save_h5_probs(os.path.join(h5_dir, rec + ".h5"), np.concatenate(parts, axis=0))
    agg = trainer_lib.aggregate_metrics(ms)
    print({f"test/{k}": round(float(v), 5) for k, v in agg.items()})
    print(f"h5 predictions -> {h5_dir} (score with cli.score --hyp_dir)")
    return agg


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.train")
    parser.add_argument("--configs", required=True)
    parser.add_argument("--checkpoint_resume", default=None)
    parser.add_argument("--test_from_folder", default=None,
                        help="average epoch ckpts in folder and evaluate")
    parser.add_argument("--max_epochs", type=int, default=None)
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from fseend_tpu_torch.data.dataset import DiarizationDataset, OnTheFlyDiarizationDataset
    from fseend_tpu_torch.models.ls_eend import resolve_device
    from fseend_tpu_torch.train import loop, optim
    from fseend_tpu_torch.utils import checkpoint as ckpt_lib
    from fseend_tpu_torch.utils.config import dump_config, load_config

    configs = load_config(args.configs)
    data = configs["data"]
    tr = configs["training"]
    np.random.seed(tr.get("seed", 777))
    device = resolve_device(args.device)

    if args.test_from_folder:
        return evaluate_folder(configs, args.test_from_folder, device)

    feat = feature_config(data)
    on_the_fly = "chunk_step" in data
    DS = OnTheFlyDiarizationDataset if on_the_fly else DiarizationDataset
    train_set = DS(data["train_data_dir"], feat, chunk_size=data["chunk_size"],
                   use_last_samples=data.get("use_last_samples", True),
                   label_delay=data.get("label_delay", 0),
                   n_speakers=data.get("num_speakers"))
    val_set = DiarizationDataset(
        data["val_data_dir"], feat,
        chunk_size=data.get("val_chunk_size", data["chunk_size"]),
        use_last_samples=data.get("use_last_samples", True),
        label_delay=data.get("label_delay", 0),
        n_speakers=data.get("num_speakers"))

    # the reference's `dist_strategy: ddp` (plus an optional model axis)
    mesh = None
    mesh_cfg = tr.get("mesh")
    if mesh_cfg or tr.get("dist_strategy") in ("ddp", "dp"):
        n_dev = _n_devices()
        if mesh_cfg:
            n_model = int(mesh_cfg.get("model", 1))
            n_data = int(mesh_cfg.get("data", 0)) or n_dev // n_model
        else:
            n_data, n_model = n_dev, 1
        if n_data * n_model > 1:
            from fseend_tpu_torch.parallel import mesh as pmesh

            mesh = pmesh.make_mesh(n_data=n_data, n_model=n_model, device=device)
            device = mesh.device
            if mesh.main:
                print(f"mesh: {n_data} data x {n_model} model ({n_dev} processes)")
        else:
            print("dist requested but only 1 device visible; single-chip run")

    model_cfg, _, task = build_model(configs)
    tx = optim.build_optimizer(
        tr.get("opt", "noam"), lr=tr.get("lr", 1.0),
        d_model=configs["model"]["params"].get("n_units", 256),
        warmup_steps=tr.get("warm_steps", 100_000),
        schedule_scale=tr.get("schedule_scale", 1.0),
        grad_clip=tr.get("grad_clip", 5.0), grad_accum=tr.get("grad_accm", 1))

    logger = None
    if mesh is None or mesh.main:
        logger = loop.MetricsLogger(
            os.path.dirname(configs["log"]["log_dir"]) or "./logs",
            configs["log"]["model_name"])
        dump_config(configs, logger.dir / "config.yaml")

    debug = configs.get("debug") or {}
    state, ckpt_dir = loop.run_training(
        task=task, model_cfg=model_cfg,
        train_dataset=train_set, val_dataset=val_set, tx=tx, logger=logger,
        batch_size=tr["batch_size"], chunk_size=data["chunk_size"],
        max_speakers=data["max_speakers"], input_dim=feat.input_dim,
        max_epochs=args.max_epochs or tr["max_epochs"], seed=tr.get("seed", 777),
        early_stop_patience=tr.get("early_stop_epoch"),
        val_interval=tr.get("val_interval", 1),
        init_ckpt=tr.get("init_ckpt"), resume_from=args.checkpoint_resume,
        on_the_fly=on_the_fly,
        log_every=debug.get("log_every_n_steps", 100),
        limit_train_batches=debug.get("limit_train_batches"),
        limit_val_batches=debug.get("limit_val_batches"), device=device, mesh=mesh)
    if ckpt_dir is None:                # a rank other than global rank 0
        return state

    # post-training checkpoint averaging; the BatchNorm statistics ride
    # along from the last epoch so avg_model.npz stands alone
    try:
        avg, avg_mstate, paths = loop.average_epoch_range(
            ckpt_dir, configs["log"].get("start_epoch"), configs["log"].get("end_epoch"))
    except FileNotFoundError:
        return state
    out = configs["log"].get("save_avg_path") or str(ckpt_dir / "avg_model.npz")
    tree = {"params": avg}
    if avg_mstate is not None:
        tree["model_state"] = avg_mstate
    ckpt_lib.save_pytree(out, tree)
    print(f"averaged {len(paths)} checkpoints -> {out}")
    return state


if __name__ == "__main__":
    main()
