"""wav -> RTTM offline inference, the port's twin of the root `cli/infer.py`.

  python -m fseend_tpu_torch.cli.infer --configs configs/fs_infer.yaml \
      --wav /path/x.wav --ckpt avg_model.npz --out out.rttm [--device cpu]

Reads the JAX package's .npz checkpoints (its layout; `params/` and
`model_state/` subtrees, or bare params) and the reference's torch
.ckpt/.pt/.pth files.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fseend_tpu_torch.cli.common import add_device_arg, feature_config, seed_of


def load_model(configs, ckpt_path, device="cuda"):
    """(model config, TaskConfig, model on `device`) for the config's
    family, holding the checkpoint's weights (a seeded random model when
    there is none)."""
    from fseend_tpu_torch.cli.train import build_model
    from fseend_tpu_torch.models.ls_eend import resolve_device
    from fseend_tpu_torch.train.loop import load_weights
    from fseend_tpu_torch.utils import torch_convert as tc

    device = resolve_device(device)
    model_cfg, make_model, task = build_model(configs)
    ckpt_path = os.fspath(ckpt_path) if ckpt_path else None
    if ckpt_path and ckpt_path.endswith((".ckpt", ".pt", ".pth")):
        sd = tc.load_torch_ckpt(ckpt_path)
        if task.model == "eda":
            raise ValueError("reference .ckpt files hold LS-EEND or FS-EEND models")
        from_sd = tc.ls_from_state_dict if task.model == "ls" else tc.fs_from_state_dict
        return model_cfg, task, from_sd(sd, model_cfg, device)
    model = make_model(torch.Generator().manual_seed(seed_of(configs, 0)), device)
    if ckpt_path:
        load_weights(model, ckpt_path)
    return model_cfg, task, model


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.infer")
    parser.add_argument("--configs", required=True)
    parser.add_argument("--wav", default=None)
    parser.add_argument("--wav_dir", default=None,
                        help="run every wav/flac in a directory")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--median", type=int, default=11)
    parser.add_argument("--device_frontend", action="store_true",
                        help="featurize on the device (ops/features_tpu) instead of "
                             "the host DSP, for --wav inference")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from fseend_tpu_torch.ops.features import extract_fbank
    from fseend_tpu_torch.utils.config import load_config

    configs = load_config(args.configs)
    data = configs["data"]
    model_cfg, task, model = load_model(configs, args.ckpt, args.device)

    if args.wav_dir:
        from fseend_tpu_torch.data.dataset import PredictDataset

        ds = PredictDataset(args.wav_dir, feature_config(data))
        for i in range(len(ds)):
            feats_i, rec = ds[i]
            _run_one(configs, task, model, feats_i, rec, args)
        return
    if not args.wav:
        parser.error("need --wav or --wav_dir")

    if args.device_frontend:
        from fseend_tpu_torch.ops.features import read_wav
        from fseend_tpu_torch.ops.features_tpu import logmel_frontend

        audio, _sr = read_wav(args.wav)
        if audio.ndim > 1:
            audio = audio[:, 0]
        feats = logmel_frontend(
            audio[None], frame_size=data["feat"]["win_length"],
            frame_shift=data["feat"]["hop_length"], context_size=data["context_recp"],
            subsampling=data["subsampling"], input_transform=data["feat_type"],
            sr=data["feat"]["sample_rate"], device=args.device)[0].cpu().numpy()
    else:
        feats = extract_fbank(
            args.wav, context_size=data["context_recp"],
            frame_size=data["feat"]["win_length"],
            frame_shift=data["feat"]["hop_length"],
            input_transform=data["feat_type"], subsampling=data["subsampling"])
    rec = os.path.splitext(os.path.basename(args.wav))[0]
    _run_one(configs, task, model, feats, rec, args)


@torch.no_grad()
def batch_probs(task, model, feats: np.ndarray, max_slots: int) -> np.ndarray:
    """One recording's (T, F) features through the batch test pass ->
    (T, max_slots - 1) probabilities, the silence slot dropped."""
    from fseend_tpu_torch.models import fs_eend, ls_eend

    device = next(model.parameters()).device
    xs = torch.as_tensor(np.asarray(feats, np.float32))[None].to(device)
    lens = torch.tensor([len(feats)], device=device)
    test_fn = ls_eend.ls_test if task.model == "ls" else fs_eend.fs_test
    out = test_fn(model, xs, lens, max_slots)
    return torch.sigmoid(out["logits"][0, :, 1:]).cpu().numpy()


def _run_one(configs, task, model, feats, rec, args):
    from fseend_tpu_torch.utils.rttm import make_rttm

    data = configs["data"]
    probs = batch_probs(task, model, feats, data["max_speakers"] + 2)
    rttm = make_rttm(rec, probs, frame_shift=data["feat"]["hop_length"],
                     subsampling=data["subsampling"],
                     sampling_rate=data["feat"]["sample_rate"],
                     threshold=args.threshold, median=args.median,
                     out_rttm_file=args.out)
    print(rttm, end="")


if __name__ == "__main__":
    main()
