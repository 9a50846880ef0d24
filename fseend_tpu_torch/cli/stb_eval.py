"""FLEX-STB block-wise streaming evaluation of an offline EEND-EDA model,
the port's twin of the root `cli/stb_eval.py`: each validation recording
runs through the KL-buffer block streamer (`serving/flex_stb.py`), its
probabilities go to one h5 per recording (score with cli.score --hyp_dir),
and the real-time factor is printed.

  python -m fseend_tpu_torch.cli.stb_eval --configs configs/stb.yaml \
      --ckpt eda.npz --out_dir preds_h5_stb [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fseend_tpu_torch.cli.common import add_device_arg, feature_config, seed_of, val_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.stb_eval")
    parser.add_argument("--configs", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--out_dir", required=True)
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from fseend_tpu_torch.models import eend_eda
    from fseend_tpu_torch.serving.flex_stb import FlexSTB
    from fseend_tpu_torch.utils import checkpoint as ckpt_lib
    from fseend_tpu_torch.utils.config import load_config
    from fseend_tpu_torch.utils.postprocess import save_h5_probs

    configs = load_config(args.configs)
    data = configs["data"]
    p = configs["model"].get("params") or {}
    in_size = (2 * data["context_recp"] + 1) * data["feat"]["n_mels"]
    cfg = eend_eda.EDAConfig(
        in_size=in_size, n_units=p.get("n_units", 256),
        n_heads=p.get("n_heads", 4), n_layers=p.get("enc_n_layers", 4),
        dropout=p.get("dropout", 0.1))
    if args.ckpt:
        model = ckpt_lib.load_eend_eda(args.ckpt, cfg, args.device)
    else:
        model = eend_eda.init_eend_eda(cfg, torch.Generator().manual_seed(seed_of(configs, 0)),
                                       device=args.device)

    ds = val_dataset(data, feature_config(data))
    stb = FlexSTB(model=model, cfg=cfg, n_speakers=data["max_speakers"],
                  buf_size=data.get("buffer_size", 1000),
                  block_size=data.get("block_size", 100),
                  buffer_weights=data.get("buffer_weights", "v1"))
    os.makedirs(args.out_dir, exist_ok=True)
    # per-recording streaming (chunk order == dataset order)
    per_rec: dict[str, list] = {}
    for i in range(len(ds)):
        Y, _T, rec = ds[i]
        per_rec.setdefault(rec, []).append(Y)
    for rec, parts in per_rec.items():
        feats = np.concatenate(parts, axis=0)
        t0 = time.perf_counter()
        probs = stb.run(feats)
        dt = time.perf_counter() - t0
        rtf = dt / (len(feats) / 10.0)  # 10 Hz post-subsampling frame rate
        save_h5_probs(os.path.join(args.out_dir, rec + ".h5"), probs)
        print(f"{rec}: {len(feats)} frames in {dt:.2f}s (RTF {rtf:.3f})")


if __name__ == "__main__":
    main()
