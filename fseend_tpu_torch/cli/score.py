"""DER scoring, the port's twin of the root `cli/score.py`.

  h5 probability files against a Kaldi data directory's labels:
      python -m fseend_tpu_torch.cli.score --configs configs/fs_infer.yaml --hyp_dir DIR
  a reference / hypothesis RTTM pair:
      python -m fseend_tpu_torch.cli.score --ref_rttm ref.rttm --hyp_rttm hyp.rttm

The collar defaults to 50 frames (250 ms at 100 Hz) with a median filter of
11, the reference's publication protocol.  Host code: no device is used.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from fseend_tpu_torch.cli.common import feature_config, val_dataset


def score_h5_dir(configs, hyp_dir, threshold, median, collar):
    from fseend_tpu_torch.utils.metrics import DERComponents, score_frames
    from fseend_tpu_torch.utils.postprocess import load_h5_probs

    data = configs["data"]
    ds = val_dataset(data, feature_config(data))
    total = DERComponents()
    # chunk labels concatenated per recording (chunk order == dataset order)
    rec_labels: dict[str, list] = {}
    for i in range(len(ds)):
        ref, rec = ds.full_labels(i)
        rec_labels.setdefault(rec, []).append(np.asarray(ref))
    for rec, parts in rec_labels.items():
        path = os.path.join(hyp_dir, rec + ".h5")
        if not os.path.exists(path):
            print(f"missing hypothesis for {rec}", file=sys.stderr)
            continue
        ref = np.concatenate(parts, axis=0)
        hyp = load_h5_probs(path)
        c = score_frames(ref, hyp, threshold=threshold, median=median,
                         collar_frames=collar, subsampling=data["subsampling"])
        total += c
        print(f"{rec}: DER {c.der:.4f}")
    print(f"\nspeaker score: {total.total}")
    print(f"mean der: {total.der:.4f}")
    print(f"mean speaker confusion rate: {total.confusion / max(total.total, 1e-9):.4f}")
    print(f"mean speaker false alarm rate: {total.falarm / max(total.total, 1e-9):.4f}")
    print(f"mean speaker miss rate: {total.miss / max(total.total, 1e-9):.4f}")
    return total


def score_rttm_pair(ref_path, hyp_path, collar_sec):
    from fseend_tpu_torch.utils.metrics import DERComponents, der_components
    from fseend_tpu_torch.utils.rttm import read_rttm

    refs, hyps = read_rttm(ref_path), read_rttm(hyp_path)
    if not (refs.keys() & hyps.keys()):
        # recording ids that do not overlap (files from different
        # pipelines): aligned by sorted order
        print(f"warning: no common recording ids between {ref_path} and "
              f"{hyp_path}; aligning by sorted order", file=sys.stderr)
        hyps = dict(zip(sorted(refs), (hyps[k] for k in sorted(hyps))))
    total = DERComponents()
    for rec, ref in refs.items():
        c = der_components(ref, hyps.get(rec, []), collar=collar_sec)
        total += c
        print(f"{rec}: DER {c.der:.4f} (miss {c.miss:.2f}s fa {c.falarm:.2f}s "
              f"conf {c.confusion:.2f}s / total {c.total:.2f}s)")
    print(f"\noverall DER: {total.der:.4f}")
    return total


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fseend_tpu_torch.cli.score")
    parser.add_argument("--configs")
    parser.add_argument("--hyp_dir")
    parser.add_argument("--ref_rttm")
    parser.add_argument("--hyp_rttm")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--median", type=int, default=11)
    parser.add_argument("--collar", type=float, default=50.0,
                        help="frames for h5 mode; seconds for rttm mode "
                             "(use 0.25 for NIST-style)")
    args = parser.parse_args(argv)

    if args.ref_rttm and args.hyp_rttm:
        return score_rttm_pair(args.ref_rttm, args.hyp_rttm, args.collar)
    if not (args.configs and args.hyp_dir):
        parser.error("need --configs + --hyp_dir, or --ref_rttm + --hyp_rttm")
    from fseend_tpu_torch.utils.config import load_config

    return score_h5_dir(load_config(args.configs), args.hyp_dir, args.threshold,
                        args.median, args.collar)


if __name__ == "__main__":
    main()
