"""Freeze a blockwise serving configuration into a self-contained artifact,
the port's twin of the root `cli/export.py`.

  python -m fseend_tpu_torch.cli.export --configs configs/ls_infer.yaml \
      --ckpt avg_model.npz --out ls_server.npz --lanes 128 --block 100 [--device cpu]

The artifact (`torch.export` programs with the weights inside, the kernels
as custom ops; `serving/aot.py`) is loaded on the serving host with
`fseend_tpu_torch.serving.aot.AotBlockServer`: no model code, configs or
checkpoints needed there.  Export on the device type you will serve on.
`--dtype` defaults to bf16, as the JAX CLI's does: the server's weights and
state are bf16 and its programs call the bf16 forms of the blockwise
kernels through the custom ops (LS-EEND: the retention layer; FS-EEND: the
encoder's cached attention).  `--dtype f32` exports in float32.
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
    parser.add_argument("--dtype", choices=["f32", "bf16"], default="bf16",
                        help="serving dtype")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    import torch

    from fseend_tpu_torch.cli.infer import load_model
    from fseend_tpu_torch.serving.aot import save_server
    from fseend_tpu_torch.serving.runtime import BlockStreamingServer
    from fseend_tpu_torch.utils.config import load_config

    configs = load_config(args.configs)
    model_cfg, task, model = load_model(configs, args.ckpt, args.device)
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
