"""Fixed-shape batcher and background prefetcher: the port's copy of
`fseend_tpu/data/loader.py` (numpy only), feeding the card without ragged
shapes."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np


def pad_collate(items, chunk_size: int, max_speakers: int, input_dim: int):
    """[(feat (T,F), label (T,S), rec)] -> fixed-shape batch dict.

    Pads frames to chunk_size and speaker columns to max_speakers; emits
    lens / n_spk for masking (replaces the reference's identity collate +
    in-model pad_sequence, diarization_dataset.py:31-33)."""
    B = len(items)
    feats = np.zeros((B, chunk_size, input_dim), np.float32)
    labels = np.zeros((B, chunk_size, max_speakers), np.float32)
    lens = np.zeros((B,), np.int32)
    n_spk = np.zeros((B,), np.int32)
    recs = []
    for b, (Y, T, rec) in enumerate(items):
        t = min(len(Y), chunk_size)
        s = min(T.shape[1], max_speakers)
        feats[b, :t] = Y[:t, :input_dim]
        labels[b, :t, :s] = T[:t, :s]
        lens[b] = t
        n_spk[b] = s
        recs.append(rec)
    return {"feats": feats, "labels": labels, "lens": lens, "n_spk": n_spk,
            "recs": recs}


def batched(dataset, index_iter: Iterable, batch_size: int, chunk_size: int,
            max_speakers: int, input_dim: int, drop_last: bool = True) -> Iterator[dict]:
    buf = []
    for idx in index_iter:
        buf.append(dataset[idx])
        if len(buf) == batch_size:
            yield pad_collate(buf, chunk_size, max_speakers, input_dim)
            buf = []
    if buf and not drop_last:
        yield pad_collate(buf, chunk_size, max_speakers, input_dim)


class Prefetcher:
    """Runs an iterator in background threads with a bounded queue."""

    _DONE = object()

    def __init__(self, make_iter, depth: int = 4):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.thread = threading.Thread(target=self._run, args=(make_iter,),
                                       daemon=True)  # not joined: the consumer may stop early
        self.error = None
        self.thread.start()

    def _run(self, make_iter):
        try:
            for item in make_iter():
                self.q.put(item)
        except BaseException as e:  # surface worker errors to the consumer
            self.error = e
        finally:
            self.q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._DONE:
                if self.error is not None:
                    raise self.error
                return
            yield item
