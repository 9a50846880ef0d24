"""Deterministic sharded sampler: the port's copy of
`fseend_tpu/data/sampler.py` (numpy only), which replaces the reference's
MyDistributedSampler.

Every host computes the SAME epoch-shuffled index permutation from
(seed, epoch) and takes its rank's strided slice; items are emitted as
(index, item_seed) so random crops are reproducible across any
rank/worker configuration (the reference's key determinism property,
SURVEY.md §4)."""

from __future__ import annotations

import numpy as np


class ShardedSampler:
    def __init__(self, n_items: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 777, drop_last: bool = False):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside [0, {num_replicas})")
        self.n_items = n_items
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if drop_last and n_items % num_replicas:
            self.num_samples = n_items // num_replicas
        else:
            self.num_samples = -(-n_items // num_replicas)
        self.total_size = self.num_samples * num_replicas
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> list[tuple[int, int]]:
        """Rank's (index, item_seed) list for the current epoch."""
        if self.shuffle:
            g = np.random.Generator(np.random.PCG64(self.seed + self.epoch))
            order = g.permutation(self.n_items)
        else:
            order = np.arange(self.n_items)
        if not self.drop_last:
            pad = self.total_size - len(order)
            if pad > 0:
                reps = int(np.ceil(pad / len(order)))
                order = np.concatenate([order, np.tile(order, reps)[:pad]])
        else:
            order = order[: self.total_size]
        mine = order[self.rank : self.total_size : self.num_replicas]
        # item seed mixes (seed, epoch, item index) — identical on every rank
        return [(int(i), int(self.seed * 1_000_003 + self.epoch * 10_007 + int(i)))
                for i in mine]

    def __iter__(self):
        return iter(self.indices())

    def __len__(self):
        return self.num_samples
