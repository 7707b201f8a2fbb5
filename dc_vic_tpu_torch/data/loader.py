"""Host data loader: threaded decode and prefetch, infinite shuffled batches
(port of dc_vic_tpu/data/loader.py). A pool of threads reads the next
batches while the current one trains; the item order and each item's crop
depend on the seed alone, not on the threads.

A data-parallel rank (``rank``, ``world``) takes its rows of each global
batch (``parallel/mesh.py::shard_rows``; ``groups=2`` for the halves of an
``mc_sampling`` batch) and decodes only those. The global order, crops and
flips are the single-process loader's, because each item's generator is
keyed by (seed, epoch, index) alone."""
from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from ..parallel.mesh import shard_rows
from ..utils.profiling import span
from .datasets import BaseImageDataset


class HostDataLoader:
    def __init__(self, dataset: BaseImageDataset, batch_size: int, num_workers: int = 8,
                 seed: int = 0, prefetch: int = 4, drop_last: bool = True,
                 rank: int = 0, world: int = 1, groups: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rank, self.world, self.groups = rank, world, groups
        if world > 1:
            shard_rows(batch_size, rank, world, groups)     # raises if it does not divide

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch_batches(self, epoch: int = 0, shuffle: bool = True) -> Iterator[Dict]:
        """One pass over the dataset: dicts of ``real_images`` (NHWC
        float32 in [-1, 1]) and ``paths``; this rank's rows of each global
        batch."""
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(n) if shuffle else np.arange(n)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.world > 1:
            batches = [b[shard_rows(len(b), self.rank, self.world, self.groups)]
                       for b in batches]

        def fetch(idx: int) -> Dict:
            item_rng = np.random.default_rng(
                (self.seed * 1_000_003 + epoch) * 2_000_029 + int(idx))
            return self.dataset.get(int(idx), item_rng)

        pool = ThreadPoolExecutor(self.num_workers)
        try:
            pending = queue.Queue()
            for b in batches[: self.prefetch]:
                pending.put([pool.submit(fetch, i) for i in b])
            next_submit = self.prefetch
            for _ in range(len(batches)):
                futs = pending.get()
                if next_submit < len(batches):
                    pending.put([pool.submit(fetch, i) for i in batches[next_submit]])
                    next_submit += 1
                items = [f.result() for f in futs]
                yield {"real_images": np.stack([it["real_images"] for it in items]),
                       "paths": [it["path"] for it in items]}
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def infinite(self, start_epoch: int = 0) -> Iterator[Dict]:
        """Epoch after epoch, without end. Each batch is taken inside the
        program span ``data.next`` (with an epoch's start where it begins
        one)."""
        batches = self._epochs(start_epoch)
        while True:
            with span("data.next"):
                batch = next(batches)
            yield batch

    def _epochs(self, epoch: int) -> Iterator[Dict]:
        while True:
            yield from self.epoch_batches(epoch)
            epoch += 1

    def eval_batches(self) -> Iterator[Dict]:
        """Batch-1, full-resolution evaluation pass."""
        for i in range(len(self.dataset)):
            item = self.dataset.get(i)
            yield {"real_images": item["real_images"][None], "paths": [item["path"]]}
