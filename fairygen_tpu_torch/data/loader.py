"""Threaded prefetch loader (port of fairygen_tpu/data/loader.py), in place
of the upstream ``DataLoader(shuffle=True, collate_fn=lambda x: x[0],
num_workers=N)`` (upstream diffusion/runner.py:29,61).

CUDA launches are asynchronous but the host-side sample work (disk read,
decode, resize, collate) is not: a plain ``for sample in dataset`` loop
serialises it with the device step.  PrefetchLoader runs
``collate_fn(dataset[i])`` on a small thread pool and keeps up to
``prefetch`` prepared batches in flight, yielding them in order.  Threads,
not processes: numpy/PIL release the GIL, and a collate that runs on the
card shares its tensors with the training loop without pickling.  The
per-epoch order is the JAX package's seeded permutation, so both packages
walk the same samples.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np

__all__ = ["PrefetchLoader"]


def _identity(x):
    return x


class PrefetchLoader:
    """Iterable over ``collate_fn(dataset[i])`` with shuffling + prefetch.

    Each ``__iter__`` is one epoch; with ``shuffle=True`` the order is a
    fresh seeded permutation per epoch (epoch counter folded into the
    seed, so epochs differ but runs reproduce).  ``num_workers=0`` keeps
    the loader fully synchronous (debugging / deterministic device-op
    ordering); otherwise samples are prepared out-of-order on the pool
    and yielded in order.  A worker exception is re-raised at the yield
    point for its sample.  Early loop exit (break / preemption) shuts the
    pool down without draining the queue.
    """

    def __init__(
        self,
        dataset: Sequence,
        collate_fn: Callable = _identity,
        *,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 1,
        prefetch: int = 2,
        num_shards: int = 1,
        shard_index: int = 0,
        shard_block: int = 1,
    ):
        """``num_shards``/``shard_index``/``shard_block``: multi-process
        position sharding (the DistributedSampler analogue).  All shards
        must use the same ``seed`` so they walk the SAME epoch
        permutation; positions are dealt out in contiguous blocks of
        ``shard_block`` — position j belongs to shard (j // shard_block)
        % num_shards — and the epoch is truncated to complete rounds of
        num_shards * shard_block so every shard yields the same count."""
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if not (0 <= shard_index < num_shards):
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = int(num_workers)
        self.prefetch = int(prefetch)
        self.num_shards = int(num_shards)
        self.shard_index = int(shard_index)
        self.shard_block = int(shard_block)
        self._epoch = 0
        self._lock = threading.Lock()

    def __len__(self):
        if self.num_shards > 1:
            # per-shard epoch length: the epoch is truncated to complete
            # rounds of num_shards * shard_block and dealt out evenly, so
            # each shard yields exactly this many items (not len(dataset))
            rnd = self.num_shards * self.shard_block
            return (len(self.dataset) // rnd) * self.shard_block
        return len(self.dataset)

    def _epoch_order(self):
        n = len(self.dataset)
        with self._lock:
            epoch, self._epoch = self._epoch, self._epoch + 1
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            rnd = self.num_shards * self.shard_block
            order = order[: (n // rnd) * rnd]
            pos = np.arange(order.shape[0])
            order = order[(pos // self.shard_block) % self.num_shards
                          == self.shard_index]
        return order

    def _load(self, idx):
        return self.collate_fn(self.dataset[idx])

    def __iter__(self):
        order = self._epoch_order()
        if self.num_workers <= 0:
            for idx in order:
                yield self._load(idx)
            return

        pool = ThreadPoolExecutor(
            max_workers=self.num_workers,
            thread_name_prefix="fairygen-loader")
        try:
            it = iter(order)
            pending = []  # in-order futures
            for idx in it:
                pending.append(pool.submit(self._load, idx))
                if len(pending) >= self.prefetch:
                    break
            for idx in it:
                yield pending.pop(0).result()
                pending.append(pool.submit(self._load, idx))
            while pending:
                yield pending.pop(0).result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
