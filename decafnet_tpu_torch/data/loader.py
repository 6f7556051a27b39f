"""Deterministic data loader with background prefetch (port of
decafnet_tpu/data/loader.py; sample order, epoch shuffle and both rank
sharding modes are the JAX loader's).

Per-epoch shuffling comes from an explicit seeded RNG (identical across
processes), each process reads only its shard, and a thread overlaps
feature IO with device compute.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from ..parallel import host_batch_slice


class DataLoader:
    """Iterates batches of raw sample dicts, or of what ``transform`` makes
    of each list of samples."""

    def __init__(self, dataset, batch_size, shuffle, seed=2022,
                 drop_last=True, rank=0, world_size=1, num_threads=4,
                 transform=None, shard_within_batch=False):
        """``transform`` (optional) maps a batch's list of samples to the
        batch inside the prefetch thread, so batch assembly overlaps the
        device step (the trainer passes ``batchify_train``).

        For ``world_size > 1``, by default each rank iterates its own
        rank-strided subset (``batch_size`` is per rank; the Evaluator's
        video shards). With ``shard_within_batch`` every rank walks the same
        globally ordered batches of ``batch_size`` (the global batch) and
        loads only its contiguous block of each: the DDP trainer's rows,
        loss-identical to the single-process run by construction."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.num_threads = max(1, num_threads)
        self.transform = transform
        self.shard_within_batch = shard_within_batch
        if shard_within_batch:
            assert batch_size % world_size == 0, (
                f"global batch {batch_size} not divisible by "
                f"{world_size} processes")
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def _epoch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.world_size > 1 and not self.shard_within_batch:
            # rank-strided shard, equal-size with drop_last semantics
            per = n // self.world_size if self.drop_last else -(-n // self.world_size)
            idx = idx[self.rank::self.world_size][:per]
        return idx

    def __len__(self):
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        idx = self._epoch_indices()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.shard_within_batch and self.world_size > 1:
            lo, hi = host_batch_slice(self.batch_size, self.rank,
                                      self.world_size)
            batches = [b[lo:hi] for b in batches]

        def build(b):
            samples = [self.dataset[int(i)] for i in b]
            return self.transform(samples) if self.transform else samples

        if self.num_threads <= 1:
            for b in batches:
                yield build(b)
            return

        q = queue.Queue(maxsize=2)
        stop = threading.Event()

        def worker():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(("item", build(b)))
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                q.put(("error", e))
                return
            q.put(("end", None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "end":
                    break
                if kind == "error":
                    raise item
                yield item
        finally:
            # the consumer stopped early (a dryrun break): let the worker
            # finish its current put and end
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
