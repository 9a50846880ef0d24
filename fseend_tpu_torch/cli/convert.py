"""A reference PyTorch checkpoint (or the average of several) -> an .npz in
the JAX package's layout, which both packages load; the port's twin of the
root `cli/convert.py`.  Host code.

  python -m fseend_tpu_torch.cli.convert --configs configs/ls_infer.yaml \
      --ckpt epoch1.ckpt epoch2.ckpt --out avg_model.npz
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.convert")
    parser.add_argument("--configs", required=True)
    parser.add_argument("--ckpt", nargs="+", required=True,
                        help="one or more torch .ckpt files (averaged if several)")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    from fseend_tpu_torch.cli.train import build_model
    from fseend_tpu_torch.utils import checkpoint as ckpt_lib
    from fseend_tpu_torch.utils import torch_convert as tc
    from fseend_tpu_torch.utils.config import load_config

    configs = load_config(args.configs)
    model_cfg, _, task = build_model(configs)
    sds = [tc.load_torch_ckpt(p) for p in args.ckpt]
    sd = sds[0] if len(sds) == 1 else tc.average_state_dicts(sds)
    if task.model == "ls":
        params, mstate = tc.ls_tree_from_state_dict(sd, model_cfg)
    else:
        params, mstate = tc.fs_tree_from_state_dict(sd, model_cfg)
    ckpt_lib.save_pytree(args.out, {"params": params, "model_state": mstate})
    n = sum(x.size for x in ckpt_lib._flatten(params, "", {}).values())
    print(f"converted {len(sds)} checkpoint(s) -> {args.out} ({n:,} params)")


if __name__ == "__main__":
    main()
