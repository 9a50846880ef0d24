"""Oracle-SAD rescoring, the port's twin of the root `cli/sad_postprocess.py`:
reads hypothesis .h5 files, applies the oracle speech mask from the data
directory's labels, writes rescored .h5 files.  Host code.

  python -m fseend_tpu_torch.cli.sad_postprocess --configs configs/ls_callhome_infer.yaml \
      --hyp_dir preds_h5 --out_dir preds_h5_sad
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from fseend_tpu_torch.cli.common import feature_config, val_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.sad_postprocess")
    parser.add_argument("--configs", required=True)
    parser.add_argument("--hyp_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--threshold", type=float, default=0.5)
    args = parser.parse_args(argv)

    from fseend_tpu_torch.utils.config import load_config
    from fseend_tpu_torch.utils.postprocess import (load_h5_probs, oracle_sad_rescore,
                                                    save_h5_probs)

    configs = load_config(args.configs)
    data = configs["data"]
    ds = val_dataset(data, feature_config(data))
    os.makedirs(args.out_dir, exist_ok=True)
    # oracle labels per recording (chunk order == dataset order)
    rec_labels: dict[str, list] = {}
    for i in range(len(ds)):
        ref, rec = ds.full_labels(i)
        rec_labels.setdefault(rec, []).append(np.asarray(ref)[:: data["subsampling"]])
    for rec, parts in rec_labels.items():
        path = os.path.join(args.hyp_dir, rec + ".h5")
        if not os.path.exists(path):
            continue
        hyp = load_h5_probs(path)
        speech = np.concatenate(parts, axis=0).max(axis=1)[: len(hyp)]
        if len(speech) < len(hyp):
            speech = np.pad(speech, (0, len(hyp) - len(speech)))
        out = oracle_sad_rescore(hyp, speech, threshold=args.threshold)
        save_h5_probs(os.path.join(args.out_dir, rec + ".h5"), out)
        print(rec)


if __name__ == "__main__":
    main()
