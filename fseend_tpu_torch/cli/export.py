"""Freeze a blockwise serving configuration into a self-contained artifact,
the port's twin of the root `cli/export.py`.

  python -m fseend_tpu_torch.cli.export --configs configs/ls_infer.yaml \
      --ckpt avg_model.npz --out ls_server.npz --lanes 128 --block 100 [--device cpu]

The artifact (`torch.export` programs with the weights inside, the kernels
as custom ops; `serving/aot.py`) is loaded on the serving host with
`fseend_tpu_torch.serving.aot.AotBlockServer`: no model code, configs or
checkpoints needed there.  Export on the device type you will serve on.
`--dtype bf16` exports an LS-EEND server in bf16 (its weights and state
bf16, the retention layer's bf16 kernel through the custom op); FS-EEND
serves float32 only so far (its bf16 kernels are ROADMAP B9) and raises.
So `--dtype` defaults to f32, where the JAX CLI defaults to bf16.
"""

from __future__ import annotations

import argparse
import os

from fseend_tpu_torch.cli.common import add_device_arg


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.export")
    parser.add_argument("--configs", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("--lanes", type=int, default=128)
    parser.add_argument("--block", type=int, default=100)
    parser.add_argument("--capacity", type=int, default=4096,
                        help="FS only: max frames per stream")
    parser.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                        help="serving dtype; bf16 for LS-EEND only (FS-EEND bf16 is "
                             "ROADMAP B9 and raises)")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    import torch

    from fseend_tpu_torch.cli.infer import load_model
    from fseend_tpu_torch.serving.aot import save_server
    from fseend_tpu_torch.serving.runtime import BlockStreamingServer
    from fseend_tpu_torch.utils.config import load_config

    configs = load_config(args.configs)
    model_cfg, task, model = load_model(configs, args.ckpt, args.device)
    if args.dtype == "bf16" and task.model != "ls":
        raise NotImplementedError(f"--dtype bf16: {task.model} serves float32 only so far; "
                                  f"its bf16 kernels are ROADMAP B9")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    srv = BlockStreamingServer(kind=task.model, cfg=model_cfg, model=model,
                               n_lanes=args.lanes, n_slots=configs["data"]["max_speakers"] + 2,
                               block=args.block, dtype=dtype, capacity=args.capacity,
                               device=args.device)
    save_server(srv, args.out)
    sz = os.path.getsize(args.out) / 1e6
    print(f"exported {task.model} block server (lanes={args.lanes}, "
          f"block={args.block}, {args.dtype}) -> {args.out} ({sz:.1f} MB)")
    return srv


if __name__ == "__main__":
    main()
