"""Batching and prefetching data loader.

Port of `image_restoration_tpu/data/loader.py` (numpy and a thread):
`EnlargedSampler` (an epoch-seeded shuffle over len(dataset)·enlarge_ratio),
one background thread that reads and collates numpy batches, and
`build_dataloader`'s policies. In a `torch.distributed` world every rank
walks the same index stream of global batches (`batch_size_per_gpu`, JAX's
global batch) and reads its own contiguous 1/world of each.
The options' `num_worker_per_gpu` is not read: the reader is one thread. The
trainer copies each batch to the device; CUDA runs asynchronously, so
the next batch is read while the step runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..utils.dist_util import check_global_batch


class EnlargedSampler:
    """Index stream: epoch-seeded shuffle over len(dataset)·ratio."""

    def __init__(self, num_samples: int, ratio: int = 1):
        self.num_samples_total = num_samples
        self.per_rank = int(np.ceil(num_samples * ratio))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        g = np.random.default_rng(self.epoch)
        return g.permutation(self.per_rank) % self.num_samples_total


class DataLoader:
    """Thread-prefetching batch loader over a map-style dataset. A consumer
    that stops iterating early ends the reader thread."""

    def __init__(self, dataset, batch_size: int, sampler=None,
                 shuffle: bool = False, drop_last: bool = True,
                 prefetch: int = 3, seed: int = 0, rank: int = 0,
                 world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        self.rank, self.world = rank, world
        self.local_batch = check_global_batch(batch_size, world)

    def __len__(self):
        n = (self.sampler.per_rank if self.sampler is not None
             else len(self.dataset))
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _index_stream(self):
        if self.sampler is not None:
            idx = self.sampler.indices()
        elif self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = g.permutation(len(self.dataset))
        else:
            idx = np.arange(len(self.dataset))
        n = len(idx)
        stop = n - n % self.batch_size if self.drop_last else n
        lo = self.rank * self.local_batch
        for start in range(0, stop, self.batch_size):
            yield idx[start:start + self.batch_size][lo:lo + self.local_batch]

    @staticmethod
    def _collate(samples) -> Dict:
        batch = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], np.ndarray):
                batch[key] = np.stack(vals)
            else:
                batch[key] = vals
        return batch

    def __iter__(self) -> Iterator[Dict]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        batches = list(self._index_stream())
        stop = object()
        closed = threading.Event()  # the consumer left: the reader ends

        def put(item):
            while not closed.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                for batch_idx in batches:
                    if closed.is_set():
                        return
                    samples = [self.dataset[int(i)] for i in batch_idx]
                    put(self._collate(samples))
                put(stop)
            except BaseException as e:  # propagate instead of hanging
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            closed.set()


def build_dataloader(dataset, dataset_opt: dict, seed: int = 0,
                     sampler: Optional[EnlargedSampler] = None,
                     rank: int = 0, world: int = 1):
    """Train: sampler, `batch_size_per_gpu` (the global batch, of which
    this rank reads its 1/world), drop_last; val: in order."""
    phase = dataset_opt.get("phase", "train")
    if phase == "train":
        if sampler is None:
            sampler = EnlargedSampler(
                len(dataset), dataset_opt.get("dataset_enlarge_ratio", 1))
        return DataLoader(dataset,
                          batch_size=dataset_opt["batch_size_per_gpu"],
                          sampler=sampler, drop_last=True, seed=seed,
                          rank=rank, world=world)
    return DataLoader(dataset, batch_size=dataset_opt.get("batch_size", 1),
                      shuffle=False, drop_last=False)
