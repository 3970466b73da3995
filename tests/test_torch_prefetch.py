"""The port's prefetch iterator (``runtime/prefetch.py``) when its caller
drops it without ``close``: the producer thread stops and the source's own
cleanup runs, as ``close`` does. A training loader dropped so would
otherwise go on decoding its look-ahead samples into a test or a process
that has moved on."""

import threading

from interactvlm_tpu_torch.runtime.prefetch import PrefetchIterator


def test_a_dropped_prefetch_iterator_stops_its_producer():
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    it = PrefetchIterator(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    thread = it.thread
    del it  # the last reference: its finalizer stops the producer
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert closed.is_set()
