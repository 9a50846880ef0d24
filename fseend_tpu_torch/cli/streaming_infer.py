"""Streaming inference on one wav with an optional check against the batch
pass (the reference's own acceptance check), the port's twin of the root
`cli/streaming_infer.py`.

  python -m fseend_tpu_torch.cli.streaming_infer --configs configs/ls_infer.yaml \
      --wav_path x.wav --test_from_file avg_model.npz --check [--frame_kernel | --block 128]

Per-frame (the default): LS `ls_stream_scan`, or with `--frame_kernel` both
frame-scan kernels (`ls_stream_scan_fused`); FS the frame scan.  `--block
K`: the blockwise mode (LS: the config's chunkwise route, the
retention-layer kernel on `use_fused_ret: true`).  `--device_frontend`
feeds raw audio through the device front end into a blockwise server.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fseend_tpu_torch.cli.common import add_device_arg


@torch.no_grad()
def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.streaming_infer")
    parser.add_argument("--configs", required=True)
    parser.add_argument("--wav_path", required=True)
    parser.add_argument("--test_from_file", dest="ckpt", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--check", action="store_true",
                        help="compare streaming vs batch output")
    parser.add_argument("--block", type=int, default=0,
                        help="blockwise-recurrent mode with this block size "
                             "(0 = per-frame recurrent scan)")
    parser.add_argument("--frame_kernel", action="store_true",
                        help="LS per-frame mode only: run the encoder and decoder "
                             "frame-scan kernels instead of the plain per-frame scan")
    parser.add_argument("--device_frontend", action="store_true",
                        help="consume raw audio blocks: the on-device streaming "
                             "featurizer feeding the block server (requires --block; "
                             "causal transforms only)")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from fseend_tpu_torch.cli.infer import load_model
    from fseend_tpu_torch.models import fs_eend, ls_eend
    from fseend_tpu_torch.ops.features import extract_fbank
    from fseend_tpu_torch.utils.config import load_config
    from fseend_tpu_torch.utils.rttm import make_rttm

    configs = load_config(args.configs)
    data = configs["data"]
    model_cfg, task, model = load_model(configs, args.ckpt, args.device)
    device = next(model.parameters()).device

    feats = extract_fbank(
        args.wav_path, context_size=data["context_recp"],
        frame_size=data["feat"]["win_length"],
        frame_shift=data["feat"]["hop_length"],
        input_transform=data["feat_type"], subsampling=data["subsampling"])
    xs = torch.as_tensor(feats)[None].to(device)
    n_slots = data["max_speakers"] + 2

    if args.frame_kernel and (args.block or task.model != "ls"):
        parser.error("--frame_kernel applies to the LS per-frame mode only "
                     "(drop --block; fs has no frame-scan kernel)")

    t0 = time.perf_counter()
    if args.device_frontend:
        if not args.block:
            parser.error("--device_frontend requires --block")
        from fseend_tpu_torch.ops.features import read_wav
        from fseend_tpu_torch.serving.raw_audio import stream_audio_file
        from fseend_tpu_torch.serving.runtime import BlockStreamingServer

        audio, _sr = read_wav(args.wav_path)
        srv = BlockStreamingServer(
            kind=task.model, cfg=model_cfg, model=model, n_lanes=1, n_slots=n_slots,
            block=args.block, capacity=len(feats) + args.block, device=device)
        probs01 = stream_audio_file(
            srv, np.asarray(audio, np.float32),
            frame_size=data["feat"]["win_length"],
            frame_shift=data["feat"]["hop_length"],
            context_size=data["context_recp"],
            subsampling=data["subsampling"],
            input_transform=data["feat_type"])
        # probabilities -> logits for the shared --check / rttm path below
        p = np.clip(probs01, 1e-7, 1 - 1e-7)
        logits = np.concatenate(
            [np.zeros((1, len(p), 1), np.float32), np.log(p / (1 - p))[None]], axis=-1)
    else:
        if task.model == "ls" and args.block:
            logits = ls_eend.ls_blockstream_run(model, xs, n_slots, block=args.block)
        elif task.model == "ls":
            st = ls_eend.ls_stream_init(model_cfg, 1, n_slots, device=device)
            if args.frame_kernel:
                logits = ls_eend.ls_stream_scan_fused(model, st, xs, n_slots)
            else:
                logits, _ = ls_eend.ls_stream_scan(model, st, xs, n_slots)
        elif args.block:
            logits = fs_eend.fs_blockstream_run(model, xs, n_slots, block=args.block)
        else:
            st = fs_eend.fs_stream_init(model_cfg, 1, len(feats) + model_cfg.conv_delay,
                                        n_slots, device=device)
            logits, _ = fs_eend.fs_stream_scan(model, st, xs, n_slots)
        logits = logits.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"streamed {len(feats)} frames in {dt:.2f}s "
          f"({len(feats) / dt:.0f} frames/s, {dt / len(feats) * 1000:.2f} ms/frame)")

    if args.check:
        lens = torch.tensor([len(feats)], device=device)
        if task.model == "ls":
            batch = ls_eend.ls_test(model, xs, lens, n_slots)
            atol = 1e-3  # LS accepts 1e-3 drift (chunkwise vs recurrent)
        else:
            batch = fs_eend.fs_test(model, xs, lens, n_slots)
            atol = 1e-4
        if args.device_frontend:
            # the raw-audio path returns probabilities (silence slot
            # dropped); compare in probability space over speaker slots
            ref_p = torch.sigmoid(batch["logits"][..., 1:]).cpu().numpy()
            diff = float(np.abs(probs01[None] - ref_p).max())
        else:
            diff = float(np.abs(logits - batch["logits"].cpu().numpy()).max())
        ok = diff < (0.05 if task.model == "ls" else atol)
        print(f"streaming vs batch: max diff {diff:.2e} -> "
              f"{'OK' if ok else 'MISMATCH'}")

    probs = 1.0 / (1.0 + np.exp(-logits[0, :, 1:]))
    rec = os.path.splitext(os.path.basename(args.wav_path))[0]
    rttm = make_rttm(rec, probs, frame_shift=data["feat"]["hop_length"],
                     subsampling=data["subsampling"],
                     sampling_rate=data["feat"]["sample_rate"],
                     out_rttm_file=args.out)
    print(rttm, end="")


if __name__ == "__main__":
    main()
