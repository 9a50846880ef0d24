"""Post-processing: the port's copy of `fseend_tpu/utils/postprocess.py`
(numpy and h5py only).

h5 export: sigmoid(logits) under the dataset "T_hat" (the reference's
FS-EEND/visualize/gen_h5_output.py:12-20).

Oracle-SAD rescoring (the reference's sad_func,
LS-EEND/sad_post_process.py:23-33): given oracle speech / non-speech,
(a) zero every speaker probability on non-speech frames (removes false
alarms), (b) on speech frames where no speaker fires, raise the argmax
speaker just above the threshold (fills misses)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_h5_probs(path: str | Path, probs: np.ndarray) -> None:
    import h5py

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("T_hat", data=probs.astype(np.float32))


def load_h5_probs(path: str | Path) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f["T_hat"])


def logits_npy_to_h5(npy_path: str | Path, h5_path: str | Path) -> None:
    """npy logits -> sigmoid -> h5 (gen_h5_output.py:12-20)."""
    logits = np.load(npy_path)
    save_h5_probs(h5_path, 1.0 / (1.0 + np.exp(-logits)))


def oracle_sad_rescore(probs: np.ndarray, speech: np.ndarray,
                       threshold: float = 0.5) -> np.ndarray:
    """probs: (T, S) sigmoid activity; speech: (T,) oracle 0/1 speech mask."""
    out = probs.copy()
    speech = speech.astype(bool)
    out[~speech] = 0.0
    decisions = out > threshold
    missed = speech & (~decisions.any(axis=1))
    if missed.any():
        rows = np.where(missed)[0]
        top = np.argmax(out[missed], axis=1)
        out[rows, top] = np.maximum(out[rows, top], threshold + 1e-6)
    return out
