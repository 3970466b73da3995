"""Host-side input pipeline runtime: background prefetch + worker pool
(a copy of ``interactvlm_tpu/runtime/prefetch.py``).

The reference leans on torch ``DataLoader`` worker processes
(``train.py:334-352``). Here the pipeline is a bounded-queue prefetch
iterator (the producer runs ahead while the card's step executes) and a
thread pool for parallel sample construction -- the heavy per-sample work
(PNG decode) runs in the native C++ decoder (``runtime/native_image.py``),
which releases the GIL, so threads scale. Threads, not worker processes:
the datasets' random generators are shared as in the JAX package, so the
same seeds draw the same samples and templates (with one worker in order).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence


class PrefetchIterator:
    """Wrap an iterator with a bounded background producer thread.
    ``close`` stops the producer and drops what it holds (an endless
    training loader would otherwise keep ``depth`` batches alive)."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.err = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._produce, daemon=True)
        self.thread.start()

    def _produce(self):
        try:
            for item in self.it:
                self.q.put(item)
                if self._stop.is_set():
                    break
        except Exception as e:  # surfaced on the consumer side
            self.err = e
        finally:
            self.it = None
            self.q.put(self._DONE)

    def close(self):
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        while not self.q.empty():
            self.q.get_nowait()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._DONE:
            if self.err is not None:
                raise self.err
            raise StopIteration
        return item


def iter_sample_batches(ds, batch_size: int, limit: int = None,
                        num_workers: int = 8):
    """Yield lists of ``ds[j]`` of size <= batch_size over [0, limit) with a
    thread pool (the eval-side analogue of DataLoader workers; the heavy
    per-sample PNG decode releases the GIL). Order-preserving; drains the
    pool on exit so abandoned lookahead work cannot leak."""
    n = len(ds) if limit is None else min(len(ds), limit)
    sampler = ParallelSampler(
        lambda j: ds[j], num_workers=num_workers,
        lookahead=max(2 * batch_size, num_workers),
    )
    it = sampler.iterate(range(n))
    try:
        batch = []
        for s in it:
            batch.append(s)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch
    finally:
        sampler.pool.shutdown(wait=False, cancel_futures=True)


class ParallelSampler:
    """Evaluate ``fn(i)`` for a stream of indices with a thread pool,
    preserving order; the dataset-side analogue of DataLoader workers."""

    def __init__(self, fn: Callable[[int], object], num_workers: int = 4,
                 lookahead: int = 8):
        self.fn = fn
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.lookahead = lookahead

    def iterate(self, indices: Sequence[int]):
        futures = []
        it = iter(indices)
        try:
            for _ in range(self.lookahead):
                futures.append(self.pool.submit(self.fn, next(it)))
        except StopIteration:
            pass
        exhausted = len(futures) < self.lookahead
        while futures:
            out = futures.pop(0).result()
            if not exhausted:
                try:
                    futures.append(self.pool.submit(self.fn, next(it)))
                except StopIteration:
                    exhausted = True
            yield out
