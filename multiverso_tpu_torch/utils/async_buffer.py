"""``prefetch_iterator``: run a generator on a background thread so host
batch production overlaps device steps (the reference's ASyncBuffer /
ParameterLoader role). Copied from ``multiverso_tpu/utils/async_buffer.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


def prefetch_iterator(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Run ``it`` on a background thread, buffering up to ``depth`` items.

    Closing the generator (``break`` in the consumer, ``.close()``, GC)
    cancels the producer thread so the source iterator is released.
    """
    q: "queue.Queue[object]" = queue.Queue(maxsize=depth)
    _END = object()
    cancel = threading.Event()

    def _put_cancellable(item) -> bool:
        """Offer to the queue until accepted or the consumer cancels;
        an unconditional blocking put would deadlock the producer thread
        forever when the consumer stops draining with a full queue."""
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def work() -> None:
        try:
            for item in it:
                if not _put_cancellable(item):
                    return
            _put_cancellable(_END)
        except BaseException as exc:
            _put_cancellable(exc)

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item  # type: ignore[misc]
    finally:
        cancel.set()
