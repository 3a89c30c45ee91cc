"""Background-filled buffers, copied from
``multiverso_tpu/utils/async_buffer.py``:

- :class:`ASyncBuffer`, the reference's two-slot double buffer: one
  persistent worker thread produces slot k+1 while the caller consumes
  slot k (the cached view's readback rides it, ``client/cache.py``);
- ``prefetch_iterator``, a generator run on a background thread so host
  batch production overlaps device steps (the reference's ASyncBuffer /
  ParameterLoader role).
"""

from __future__ import annotations

import queue
import threading
from typing import (Callable, Generic, Iterable, Iterator, Optional,
                    TypeVar)

T = TypeVar("T")


class ASyncBuffer(Generic[T]):
    """Two-slot buffer: ``fill_fn(slot_index)`` runs on ONE persistent
    worker thread fed by a request queue (a thread create/teardown per
    fill would put ~100µs of OS work back on the per-batch path this
    buffer exists to hide).

    ``get()`` blocks until the in-flight fill completes, returns the filled
    value, and immediately kicks off the next fill — the caller always
    overlaps its consumption of buffer k with the production of buffer k+1.
    ``poll()`` is the non-blocking variant (the staleness-bounded get
    cache's absorb path): the filled value when the in-flight fill has
    completed, else ``None`` — and a completed poll kicks the next fill
    exactly like ``get()``.
    """

    def __init__(self, fill_fn: Callable[[int], T],
                 name: Optional[str] = None) -> None:
        self._fill_fn = fill_fn
        # named buffers publish queue.depth/queue.age_s gauges (lazy
        # import: this module stays importable without the telemetry
        # package initialised)
        self._qg = None
        if name is not None:
            from multiverso_tpu_torch.telemetry.metrics import QueueGauges
            self._qg = QueueGauges(f"async:{name}")
        self._requests: "queue.Queue[Optional[int]]" = queue.Queue()
        self._results: "queue.Queue[tuple[Optional[T], Optional[BaseException]]]" = (
            queue.Queue(maxsize=1))
        self._index = 0
        self._stopped = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()
        self._kick()

    def _work(self) -> None:
        while True:
            idx = self._requests.get()
            if idx is None:         # stop() sentinel
                return
            if self._qg is not None:
                self._qg.on_take()
            try:
                item = (self._fill_fn(idx), None)
            except BaseException as exc:  # propagate to consumer
                item = (None, exc)
            # bounded offer: an unconditional put would wedge the worker
            # forever when the consumer stops draining after stop()
            while not self._stopped:
                try:
                    self._results.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def _kick(self) -> None:
        self._requests.put(self._index)
        self._index += 1
        if self._qg is not None:
            self._qg.on_put()

    def _consume(self, value: Optional[T],
                 exc: Optional[BaseException]) -> T:
        if exc is not None:
            self._stopped = True
            raise exc
        self._kick()
        return value  # type: ignore[return-value]

    def get(self) -> T:
        if self._stopped:
            raise RuntimeError("ASyncBuffer already stopped")
        value, exc = self._results.get()
        return self._consume(value, exc)

    def poll(self) -> Optional[T]:
        """Non-blocking ``get``: the filled value when the in-flight fill
        is done (kicking the next fill), else ``None``. A fill_fn that can
        itself return ``None`` is indistinguishable from "not ready" —
        such producers should use ``get()``. Fill errors raise here just
        like ``get()``."""
        if self._stopped:
            raise RuntimeError("ASyncBuffer already stopped")
        try:
            value, exc = self._results.get_nowait()
        except queue.Empty:
            return None
        return self._consume(value, exc)

    def stop(self) -> None:
        self._stopped = True
        self._requests.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5.0)



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
