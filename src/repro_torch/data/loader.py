"""Seeded, batched host data loader (a copy of ``repro.data.loader``).

Deterministic per (seed, epoch): supports the paper's "40 batches per
epoch" protocol. Batches are plain dicts of numpy arrays; the fused
training loops move each batch to the store's device once per step.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from .synthetic import make_batch


class DataLoader:
    def __init__(self, cfg, *, batch_size: int, seq_len: int = 128,
                 num_batches: int = 40, seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_batches = num_batches
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        for _ in range(self.num_batches):
            yield make_batch(self.cfg, rng, self.batch_size, self.seq_len)
