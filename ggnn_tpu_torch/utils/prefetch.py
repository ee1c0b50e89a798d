"""Host-side batch prefetching (a copy of `ggnn_tpu/utils/prefetch.py`).

`ThreadedIterator` reproduces the one concurrent structure of the
reference: a background thread fills a bounded queue so batch assembly
overlaps device compute (reference: utils.py:16-36). Elements must not be
None (None is the end sentinel; a violating source raises on the
consumer). Unlike the reference, abandoning the iteration early (an
exception in the consuming loop) does not leak a blocked worker thread:
`close()` — called automatically when the generator is torn down —
unblocks and retires the worker; and the worker starts LAZILY on first
iteration, so a constructed-but-never-iterated instance holds no
spinning thread. The iterator is single-use: a second
`iter()` raises instead of hanging on the drained queue. Each pull of an
element from the source is the span `ggnn.pack.batch` (utils/spans.py),
its `step` the element's index.
"""

import queue
import threading
from typing import Any, Iterable

from ggnn_tpu_torch.utils.spans import pulls


class ThreadedIterator:
    """A single-use iterator whose elements are computed in a
    background thread (started on first iteration)."""

    def __init__(self, original_iterator: Iterable[Any], max_queue_size: int = 2):
        self._source = original_iterator
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue_size)
        self._closed = False
        self._started = False
        self._error = None
        self._thread = threading.Thread(target=self._worker, daemon=True)

    def _put(self, element) -> bool:
        """Bounded put that gives up when the consumer closed us (a
        plain blocking put would park the worker forever — holding its
        packed batches — if the consuming loop is abandoned early)."""
        while not self._closed:
            try:
                self._queue.put(element, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for _, element in pulls(self._source, "ggnn.pack.batch"):
                if element is None:
                    # Explicit raise, not assert: python -O strips
                    # asserts, and a None element reaching the queue
                    # would act as the END sentinel — silently
                    # truncated epoch, then a consumer/worker mutual
                    # deadlock. The raise surfaces on the consumer via
                    # _error.
                    raise ValueError(
                        "iterator elements must not be None (None is "
                        "the end sentinel)")
                if not self._put(element):
                    return
        except BaseException as e:  # surface worker errors on the consumer
            self._error = e
        finally:
            self._put(None)

    def close(self):
        """Retire the worker without consuming the stream (called by the
        generator's finally on early exit)."""
        self._closed = True
        try:  # unblock a parked put
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=5)

    def __iter__(self):
        if self._closed or self._started:
            # Single-use: the queue is drained and the worker retired
            # after the first pass — a second iteration would block
            # forever on an empty queue with no producer.
            raise RuntimeError(
                "ThreadedIterator is single-use and was already "
                "iterated or closed")
        self._started = True
        self._thread.start()
        try:
            next_element = self._queue.get(block=True)
            while next_element is not None:
                yield next_element
                next_element = self._queue.get(block=True)
            self._thread.join()
            if self._error is not None:
                raise self._error
        finally:
            self.close()
