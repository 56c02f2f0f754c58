"""Background-thread batch prefetcher (port of ``ssp/data/prefetch.py``).

Augmentation runs on the card, so one decode thread that keeps a small
queue full overlaps host IO with the training step (the reference used 16
DataLoader workers).  The decoder releases the GIL, so the thread runs
beside the step's Python.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator


class Prefetcher:
    """Wrap an iterator; a daemon thread keeps ``depth`` items ready.  An
    exception in the thread is raised in the consumer at that point of the
    stream."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], depth: int = 4):
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=max(depth, 1))
        self._error = None

        def worker() -> None:
            try:
                for item in it:
                    self._queue.put(item)
            except BaseException as e:  # raised again in the consumer
                self._error = e
            finally:
                self._queue.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> Any:
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
