"""Prefetching data loader: host workers overlap GT/shapely-style work with
device compute.

Copy of the JAX package's data/loader.py. Replaces the reference's torch
DataLoader worker processes (datasets/builder.py:18-146 — num_workers
subprocesses doing image IO and online map-GT geometry): a thread pool prefetches and collates batches ahead
of the training step. Threads (not processes) suffice because the heavy
per-sample work is numpy/PIL/native-C++ which release the GIL.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


def shuffled_epoch_indices(n: int, seed: int, drop_last_to: Optional[int] = None
                           ) -> np.ndarray:
    """Per-epoch deterministic shuffle (DistributedGroupSampler's role;
    nuScenes images share one aspect group so grouping is a no-op)."""
    idx = np.random.default_rng(seed).permutation(n)
    if drop_last_to:
        idx = idx[: (len(idx) // drop_last_to) * drop_last_to]
    return idx


class PrefetchLoader:
    """Iterates collated batches with `prefetch` batches in flight."""

    def __init__(
        self,
        get_sample: Callable[[int], Dict[str, np.ndarray]],
        indices: Sequence[int],
        batch_size: int,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        self.get_sample = get_sample
        self.indices = list(indices)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = [
            self.indices[i * self.batch_size:(i + 1) * self.batch_size]
            for i in range(len(self))
        ]
        if self.num_workers <= 0:
            # synchronous path (torch DataLoader num_workers=0 semantics):
            # no producer thread, no prefetch — load in the caller
            for batch_idx in batches:
                samples = [self.get_sample(i) for i in batch_idx]
                yield {k: np.stack([s[k] for s in samples])
                       for k in samples[0]}
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        samples = list(pool.map(self.get_sample, batch_idx))
                        q.put({k: np.stack([s[k] for s in samples])
                               for k in samples[0]})
            except BaseException as e:  # surface in the consumer, not a
                err.append(e)           # silently-dead producer thread
            finally:
                q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                break
            yield item
