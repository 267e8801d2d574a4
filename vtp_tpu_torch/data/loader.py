"""Batched, thread-prefetching data loader (port of ``vtp_tpu/data/loader.py``).

One host process feeds whole batches; workers are threads (PIL decode
releases the GIL for its heavy parts) and ``prefetch`` batches are
decoded ahead while the card computes. ``ShardedSampler`` keeps
``torch.utils.data.DistributedSampler(shuffle=False)``'s index split for
multi-process ingest. Batches are numpy arrays, as the JAX loader's.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np


class ShardedSampler:
    """Deterministic interleaved shard of indices, matching
    DistributedSampler(shuffle=False): rank r takes indices r, r+W, r+2W,
    ... with wrap-around padding to equal length (or the tail dropped)."""

    def __init__(self, n: int, shard: int = 0, num_shards: int = 1,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False):
        self.n = n
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def indices(self, epoch: int = 0) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(self.n)
        if self.drop_last:
            per = self.n // self.num_shards
            idx = idx[: per * self.num_shards]
        else:
            total = -(-self.n // self.num_shards) * self.num_shards
            if total > self.n:
                idx = np.concatenate([idx, idx[: total - self.n]])
        return idx[self.shard:: self.num_shards]


class InfiniteSampler:
    """Endless shuffled index stream (reference test_linear_probing_hf.py:
    192-209): reshuffles every pass, deterministic from the seed."""

    def __init__(self, n: int, shard: int = 0, num_shards: int = 1, seed: int = 0):
        self.n = n
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            rng = np.random.default_rng(self.seed + epoch)
            for i in rng.permutation(self.n)[self.shard:: self.num_shards]:
                yield int(i)
            epoch += 1


def _default_collate(items: List[Any]):
    first = items[0]
    if isinstance(first, tuple):
        return tuple(_default_collate([it[k] for it in items]) for k in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(items, axis=0)
    return np.asarray(items)


class DataLoader:
    """Iterates batches of a map-style dataset with threaded decode and
    batch prefetch. An exception raised by the dataset reaches the
    consumer."""

    def __init__(self, dataset, batch_size: int, *, sampler: Optional[Sequence[int]] = None,
                 num_workers: int = 8, prefetch: int = 4, drop_last: bool = False,
                 collate: Callable = _default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.collate = collate

    def _index_batches(self) -> Iterator[List[int]]:
        idx = self.sampler if self.sampler is not None else range(len(self.dataset))
        batch: List[int] = []
        for i in idx:
            batch.append(int(i))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def _batches(self) -> Iterator:
        """The collated batches in order, each decoded by the worker threads."""
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for batch_idx in self._index_batches():
                yield self.collate(list(pool.map(self.dataset.__getitem__, batch_idx)))

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            batches = self._batches()
            try:
                for batch in batches:
                    if not put(batch):
                        return
            except BaseException as e:  # handed to the consumer, raised there
                put(e)
                return
            finally:
                batches.close()
            put(done)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
