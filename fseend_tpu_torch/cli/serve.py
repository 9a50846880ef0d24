"""Continuous-batching server over a directory of wavs, the port's twin of
the root `cli/serve.py`: every recording streams concurrently over the
lanes of one per-frame `StreamingServer`, each lane with its own clock; a
finished lane is reset and reused at once.

  python -m fseend_tpu_torch.cli.serve --configs configs/ls_infer.yaml --ckpt avg.npz \
      --wav_dir /data/wavs --out_dir rttms --lanes 128 --block 500 [--device cpu]

LS serves through both frame-scan kernels (`--frame_kernel auto` = on for
LS); FS through the per-frame-exact fast block, its cached attention on the
kernel when the config sets `use_flash_attn: true`.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from fseend_tpu_torch.cli.common import add_device_arg


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.serve")
    parser.add_argument("--configs", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--lanes", type=int, default=128)
    parser.add_argument("--block", type=int, default=500)
    parser.add_argument("--frame_kernel", choices=["auto", "on", "off"], default="auto",
                        help="LS frame-scan serving kernels; auto = on for LS")
    parser.add_argument("--capacity", type=int, default=8192,
                        help="FS only: max frames per recording")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from fseend_tpu_torch.cli.infer import load_model
    from fseend_tpu_torch.ops.features import extract_fbank
    from fseend_tpu_torch.serving.runtime import StreamingServer
    from fseend_tpu_torch.serving.scheduler import ContinuousBatcher
    from fseend_tpu_torch.utils.config import load_config
    from fseend_tpu_torch.utils.rttm import make_rttm

    configs = load_config(args.configs)
    data = configs["data"]
    model_cfg, task, model = load_model(configs, args.ckpt, args.device)
    fk = {"auto": None, "on": True, "off": False}[args.frame_kernel]
    srv = StreamingServer(kind=task.model, cfg=model_cfg, model=model,
                          n_lanes=args.lanes, n_slots=data["max_speakers"] + 2,
                          capacity=args.capacity, frame_kernel=fk, device=args.device)
    cb = ContinuousBatcher(srv, block=args.block)

    wavs = sorted(glob.glob(os.path.join(args.wav_dir, "*.wav")))
    if not wavs:
        sys.exit(f"no wavs in {args.wav_dir}")
    total_frames = 0
    for path in wavs:
        feats = extract_fbank(
            path, context_size=data["context_recp"],
            frame_size=data["feat"]["win_length"],
            frame_shift=data["feat"]["hop_length"],
            input_transform=data["feat_type"],
            subsampling=data["subsampling"])
        total_frames += len(feats)
        cb.submit(os.path.splitext(os.path.basename(path))[0], feats)

    t0 = time.perf_counter()
    results = cb.run()
    dt = time.perf_counter() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    for rec, probs in results.items():
        out_path = os.path.join(args.out_dir, rec + ".rttm")
        if os.path.exists(out_path):   # make_rttm appends; re-runs must not
            os.unlink(out_path)        # duplicate every segment
        make_rttm(rec, np.asarray(probs),
                  frame_shift=data["feat"]["hop_length"],
                  subsampling=data["subsampling"],
                  sampling_rate=data["feat"]["sample_rate"],
                  out_rttm_file=out_path)
    print(f"served {len(wavs)} recordings ({total_frames} frames) over "
          f"{args.lanes} lanes in {dt:.2f}s "
          f"({total_frames / dt:.0f} frames/s) -> {args.out_dir}")
    return results


if __name__ == "__main__":
    main()
