"""Host batch assembly with background prefetch (counterpart of
``usip_tpu/data/pipeline.py``; the port keeps its own copy).

Replaces the reference's ``DataLoader(num_workers=nThreads)`` processes:
augmentation and FPS run on the device, so the host work per item is file
IO and subsampling, which a small thread pool covers. Batches are assembled
ahead of the consumer. The transfer to the card is the engine's
(``train/loop.py prefetch_batches``)."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class BatchLoader:
    """Iterates shuffled fixed-size batches with background prefetch.

    Args:
      dataset: indexable with __len__ and __getitem__ -> dict of arrays.
      batch_size: items per batch.
      shuffle: reshuffle indices each epoch.
      num_workers: item-fetch thread pool size.
      prefetch: max batches buffered ahead.
      drop_last: True (default) drops the final partial batch like the
        reference's drop_last=True train loaders; eval/export loaders pass
        False so every frame is visited (the reference's save_keypoints.py
        loop exports every frame: a dropped tail frame corrupts the
        repeatability protocol on non-divisible eval sets).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 4, seed: int = 0,
                 post_collate: Optional[Callable] = None,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.post_collate = post_collate
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> list:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.drop_last:
            idx = idx[:(len(idx) // self.batch_size) * self.batch_size]
        return [idx[i:i + self.batch_size]
                for i in range(0, len(idx), self.batch_size)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._epoch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        # np.random.Generator is documented not-thread-safe: datasets with a
        # shared ._rng must not run __getitem__ concurrently (duplicated or
        # correlated subsample draws). The GIL already serializes most of the
        # numpy work here, so the lock costs little.
        shared_rng = (hasattr(self.dataset, "_rng") or
                      hasattr(getattr(self.dataset, "base", None), "_rng"))
        rng_lock = threading.Lock() \
            if (self.num_workers > 1 and shared_rng) else None

        def fetch(i: int):
            if rng_lock is None:
                return self.dataset[int(i)]
            with rng_lock:
                return self.dataset[int(i)]

        def _put(item) -> bool:
            # bounded put: consumers may abandon the iterator mid-epoch
            # (truncated test sweeps, single-batch pulls); a plain q.put
            # would leave this thread + its pool blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for row in batches:
                    if stop.is_set():
                        break
                    items = list(pool.map(fetch, [int(i) for i in row]))
                    batch = collate(items)
                    if self.post_collate is not None:
                        batch = self.post_collate(batch, row)
                    if not _put(batch):
                        break
            _put(sentinel)

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
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30)
