"""Batch prefetching for the training loop (port of
``vf_nerf_tpu/utils/prefetch.py:29-58``).

``Prefetcher`` runs the ``iterable → feed_fn`` chain in one worker thread a
fixed depth ahead of the consumer, so batch ``k+1`` is assembled, packed
and copied to the device while step ``k`` is being launched. One worker
keeps the iterator's order, and so its random draws, exactly; numpy and the
host-to-device copy release the interpreter lock for the bulk of the work.
``wait_span`` names the span (``utils/profiling.py``) that records the
consumer's waits for the next result.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from vf_nerf_torch.utils.profiling import span

_SENTINEL = object()


class Prefetcher:
    """Iterate ``feed_fn(item)`` for the items of ``iterable``, computed
    ahead in a background thread (at most ``depth`` results waiting)."""

    def __init__(self, iterable: Iterable, feed_fn: Callable[[Any], Any],
                 depth: int = 2, wait_span: Optional[str] = None) -> None:
        self._wait_span = wait_span
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._iterable = iterable
        self._feed_fn = feed_fn
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for item in self._iterable:
                self._queue.put(self._feed_fn(item))
            self._queue.put(_SENTINEL)
        except BaseException as exc:  # handed to the consumer, who raises it
            self._queue.put(exc)

    def __iter__(self) -> Iterator[Any]:
        while True:
            if self._wait_span is None:
                item = self._queue.get()
            else:
                with span(self._wait_span):
                    item = self._queue.get()
            if item is _SENTINEL:
                self._thread.join()
                return
            if isinstance(item, BaseException):
                self._thread.join()
                raise item
            yield item
