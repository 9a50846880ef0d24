"""FLEX-STB: block-wise streaming inference with the offline EEND-EDA
model.  Port of `fseend_tpu/serving/flex_stb.py` (the reference's
FS-EEND/train/tfm_STB.py:147-237 and its buffer utilities,
FS-EEND/train/utils/utils.py:32-111).

A 10 s block arrives; the model scores concat(buffer, block) on its
device; the new block's speaker columns are aligned to the buffer's earlier
predictions by a correlation + Hungarian permutation; the buffer keeps
`buf_size` frames chosen by KL-divergence-weighted sampling (frames whose
speaker posterior is far from uniform are informative anchors).  The
buffer and its selection stay on the host, drawn from
`np.random.default_rng(seed)` as in the JAX package; the numpy helpers
are its copies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.optimize import linear_sum_assignment

from fseend_tpu_torch.models import eend_eda
from fseend_tpu_torch.models.ls_eend import with_cfg


def kl_weights(y: np.ndarray) -> np.ndarray:
    """KL(p_t || uniform) per frame with the reference's clamping (upd_buf,
    utils.py:60-73).  y: (T, S) probabilities."""
    T, S = y.shape
    p = y / np.maximum(y.sum(axis=1, keepdims=True), 1e-12)
    p = np.where(p == 0, 1e-6, p)
    kld = (p * np.log(p * S)).sum(axis=1)
    kld = np.where(kld < 0, 0.0, kld)
    kld = np.where(kld == 0, 1e-6, kld)
    return kld / kld.sum()


def kl_weights_v2(y: np.ndarray) -> np.ndarray:
    """The variant weighted by each frame's importance r = sum_s y / colsum
    (upd_buf_ver2, utils.py:32-58)."""
    T, S = y.shape
    p = y / np.maximum(y.sum(axis=1, keepdims=True), 1e-12)
    p = np.where(p == 0, 1e-6, p)
    r = (y / np.maximum(y.sum(axis=0, keepdims=True), 1e-12)).sum(axis=1)
    kld = r * (p * np.log(p * S)).sum(axis=1)
    kld = np.maximum(kld, 1e-12)
    return kld / kld.sum()


def split_results(labels: np.ndarray, preds: np.ndarray, blk_size: int):
    """A recording's labels and predictions split into blocks, each with
    the speakers active so far only (the reference's split_results,
    loss.py:26-41).  Returns (label blocks, prediction blocks, speakers per
    block)."""
    out_l, out_p, out_n = [], [], []
    T = len(labels)
    for st in range(0, T, blk_size):
        ed = min(st + blk_size, T)
        active = labels[:ed].max(axis=0) > 0
        n = int(active.sum())
        out_l.append(labels[st:ed][:, active])
        out_p.append(preds[st:ed][:, :n])
        out_n.append(n)
    return out_l, out_p, out_n


def update_buffer(x_buf, x_i, y_buf, y_i, buf_size: int, rng: np.random.Generator,
                  weights: str = "v1"):
    """The next buffer's frames from buffer + block.  weights:
      "v1"   KL(p || uniform) sampling without replacement (upd_buf,
             utils.py:60-87)
      "v2"   the importance-weighted KL variant (upd_buf_ver2, utils.py:32-58)
      "fifo" the most recent buf_size frames (the LS-side upd_buf_FIFO)
    Returns (x_buf', y_buf')."""
    x_cat = np.concatenate([x_buf, x_i], axis=0)
    y_cat = np.concatenate([y_buf, y_i], axis=0)
    if len(x_cat) <= buf_size:
        return x_cat, y_cat
    if weights == "fifo":
        return x_cat[-buf_size:], y_cat[-buf_size:]
    prob = kl_weights_v2(y_cat) if weights == "v2" else kl_weights(y_cat)
    sel = rng.choice(len(x_cat), size=buf_size, replace=False, p=prob)
    sel.sort()
    return x_cat[sel], y_cat[sel]


def correlation(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation with the reference's eps (utils.py:89-96)."""
    a0, b0 = a - a.mean(), b - b.mean()
    return float((a0 * b0).sum() / (np.sqrt((a0 ** 2).sum()) * np.sqrt((b0 ** 2).sum())
                                    + 1e-6))


def find_best_perm(y: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """y_pred's speaker columns aligned to y's by the max-correlation
    assignment (utils.py:100-111)."""
    C = y.shape[1]
    cc = np.zeros((C, C))
    for i in range(C):
        for j in range(C):
            cc[i, j] = correlation(y[:, i], y_pred[:, j])
    return linear_sum_assignment(cc, maximize=True)[1]


@dataclasses.dataclass
class FlexSTB:
    """Block-wise streaming loop around the EEND-EDA scorer on the
    model's device.  Each block scores the true-length buffer + block (the
    JAX package pads to buf_size + block_size, for XLA's one static shape,
    and masks the pad through `lens`: the same logits)."""

    model: eend_eda.EENDEDA
    cfg: eend_eda.EDAConfig
    n_speakers: int
    buf_size: int = 1000       # the reference's spk_STB.yaml: a 100 s buffer
    block_size: int = 100      # 10 s blocks
    seed: int = 777
    buffer_weights: str = "v1"  # "v1" | "v2" | "fifo"

    def __post_init__(self):
        if self.buffer_weights not in ("v1", "v2", "fifo"):
            raise ValueError(f"buffer_weights {self.buffer_weights!r}")
        self.rng = np.random.default_rng(self.seed)
        self._model = with_cfg(self.model, self.cfg)

    def score(self, inp: np.ndarray) -> np.ndarray:
        """(T, F) features -> (T, n_speakers) logits, on the host."""
        out = eend_eda.eda_test(self._model, inp[None], n_attractors=self.n_speakers)
        return out["logits"][0].cpu().numpy()

    def run(self, feats: np.ndarray) -> np.ndarray:
        """feats: (T, F) -> (T, n_speakers) sigmoid probabilities, produced
        causally block by block (tfm_STB.py:147-237)."""
        T = len(feats)
        outs = []
        x_buf = np.zeros((0, feats.shape[1]), feats.dtype)
        y_buf = np.zeros((0, self.n_speakers), np.float32)
        for st in range(0, T, self.block_size):
            block = feats[st:st + self.block_size]
            inp = np.concatenate([x_buf, block], axis=0)
            probs = 1.0 / (1.0 + np.exp(-self.score(inp)))
            y_blk = probs[len(x_buf):]
            if len(y_buf):
                # the new block's speakers aligned to the buffer's history
                y_blk = y_blk[:, find_best_perm(y_buf, probs[:len(x_buf)])]
            outs.append(y_blk)
            x_buf, y_buf = update_buffer(x_buf, block, y_buf, y_blk, self.buf_size, self.rng,
                                         self.buffer_weights)
        return np.concatenate(outs, axis=0)[:T]
