"""Batching on the host, copy of `open3dsot_tpu/data/loader.py`: a numpy
collator of fixed-shape batches and a loader whose background thread builds
the next batches while the device trains on this one. Unlike the original,
the background thread ends when the consumer stops iterating early (a
trainer's `steps_per_epoch` below the loader's length), `close` shuts the
worker threads down, and `transform` (the int16 pack, the pinned copies of
the device sampler's raw batches) runs on each collated batch in the
background thread too.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def collate(samples) -> dict:
    """Stack a list of dict samples into one batch dict of arrays."""
    out = {}
    for key in samples[0]:
        out[key] = np.stack([np.asarray(s[key]) for s in samples], axis=0)
    return out


class BatchLoader:
    """Iterate fixed-size batches over a Dataset-like (len/getitem) sampler.

    drop_last=True keeps batch shapes static. Shuffling is deterministic
    given `seed` + `epoch`. `workers` > 0 builds a batch's samples in a
    thread pool; `prefetch` batches are built ahead in a background thread;
    `transform` maps each collated batch there.
    """

    def __init__(self, sampler, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 workers: int = 0, transform=None):
        self.sampler = sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.workers = workers
        self.transform = transform
        self.epoch = 0
        self._pool = None
        if workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.sampler)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def _iter_sync(self) -> Iterator[dict]:
        idx = self._indices()
        nb = len(self)
        for b in range(nb):
            chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
            if self._pool is not None:
                samples = list(self._pool.map(self.sampler.__getitem__, map(int, chunk)))
            else:
                samples = [self.sampler[int(i)] for i in chunk]
            batch = collate(samples)
            yield batch if self.transform is None else self.transform(batch)

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._iter_sync()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []
        stop = threading.Event()  # set when the consumer stops early

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for batch in self._iter_sync():
                    if not put(batch):
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]

    def close(self) -> None:
        """Shut down the worker threads."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
