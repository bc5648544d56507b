"""Fixed-shape batching, the port's copy of ``univl_tpu/data/batching.py``'s
``collate``, ``Batcher`` and ``pad_rows``.

Samples are fixed-shape numpy arrays, fetched by a thread pool and stacked;
the trainer moves each batch to its device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


class Batcher:
    """Deterministic shuffling batcher.

    Yields ``[batch_size, ...]`` dicts; with ``grad_accum > 1``,
    ``[grad_accum, batch_size, ...]`` (the trainer's layout)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, grad_accum: int = 1, num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.grad_accum = grad_accum
        self.num_workers = num_workers

    def __len__(self):
        chunk = self.batch_size * self.grad_accum
        n = len(self.dataset)
        return n // chunk if self.drop_last else -(-n // chunk)

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's update-batches in the order seeded by (seed, epoch);
        ``start_batch`` skips the first update-batches without reading their
        samples (a resume inside the epoch)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        chunk = self.batch_size * self.grad_accum

        def fetch(i):
            return self.dataset[int(i)]

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            for off in range(start_batch * chunk, n - chunk + 1 if self.drop_last else n, chunk):
                idxs = order[off: off + chunk]
                if len(idxs) < chunk and self.grad_accum > 1:
                    # the accum reshape needs a full chunk: wrap-pad the last
                    # partial one with indices from the epoch's start (torch
                    # DistributedSampler's equal-size padding)
                    idxs = np.concatenate([idxs, np.resize(order, chunk - len(idxs))])
                batch = collate(list(ex.map(fetch, idxs)))
                if self.grad_accum > 1:
                    batch = {k: v.reshape(self.grad_accum, self.batch_size, *v.shape[1:])
                             for k, v in batch.items()}
                yield batch


def pad_rows(x: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad the leading (row) dim to ``size``: the fixed serving batch."""
    if x.shape[0] == size:
        return x
    pad = np.zeros((size - x.shape[0], *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad], axis=0)
