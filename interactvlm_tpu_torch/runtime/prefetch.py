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
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence


class _Feed:
    """What a producer thread shares with its ``PrefetchIterator``: the
    source, the queue, the stop flag and the source's exception. The thread
    holds this and not the iterator, so an iterator dropped without
    ``close`` is collected, and its finalizer stops the thread."""

    def __init__(self, it: Iterator, depth: int):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.err = None
        self.stop = threading.Event()


def _produce(feed: _Feed, done):
    try:
        for item in feed.it:
            feed.q.put(item)
            if feed.stop.is_set():
                break
    except Exception as e:  # surfaced on the consumer side
        feed.err = e
    finally:
        feed.it = None
        feed.q.put(done)


def _stop(feed: _Feed, thread: threading.Thread):
    """Stop the producer and drop what it holds: drain the queue until the
    thread has let go of its source (whose own cleanup then runs)."""
    feed.stop.set()
    while thread.is_alive():
        try:
            feed.q.get(timeout=0.1)
        except queue.Empty:
            pass
    while not feed.q.empty():
        feed.q.get_nowait()


class PrefetchIterator:
    """Wrap an iterator with a bounded background producer thread.
    ``close`` stops the producer and drops what it holds (an endless
    training loader would otherwise keep ``depth`` batches alive, and its
    sample pool decoding); dropping the iterator does the same."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._feed = _Feed(it, depth)
        self.q = self._feed.q
        self.thread = threading.Thread(target=_produce,
                                       args=(self._feed, self._DONE),
                                       daemon=True)
        self.thread.start()
        self._finalizer = weakref.finalize(self, _stop, self._feed,
                                           self.thread)
        self._finalizer.atexit = False  # the daemon thread dies with us

    @property
    def it(self):
        return self._feed.it

    def close(self):
        self._finalizer()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._DONE:
            if self._feed.err is not None:
                raise self._feed.err
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
