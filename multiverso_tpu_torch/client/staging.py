"""Async staging: overlap host batch prep with the device apply.

Counterpart of ``multiverso_tpu/client/staging.py``. A ``KVTable.add``
is two halves: a host half (key validation, the splitmix hash, the sort
by bucket, the per-shard lane slicing and the copies to the card) and a
device half (the probe + commit launches). Issued serially, the host
half of batch k+1 waits for nothing but still sits on the critical path
between dispatches. :class:`KVStagingWriter` double-buffers them: a
persistent worker thread runs ``KVTable.prepare_add`` (the host half; it
touches no table state) up to ``depth`` batches ahead, while the
caller's thread runs ``KVTable.add_prepared`` (the device half, which
writes the table and must stay on the owning thread) — the reference's
ParameterLoader / ASyncBuffer pipelining role applied to the Add path.

Update order is submission order: one worker + FIFO queues means
prepared batches come back in the order they went in, and dispatches
happen on the caller's thread in that order.

Streams: ``prepare_add`` queues CUDA work from the worker thread (a card
delta permuted and sliced on the card, the host lanes copied to it). It
runs on that thread's current stream, which is each card's default
stream, the one every thread of the port queues on (``HostCopy``'s
docstring, ``tables/base.py``); so stream order keeps a prepared batch
ahead of its ``add_prepared``. The writer uses no side stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Optional, Tuple

from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry import trace as tracing
from multiverso_tpu_torch.updaters import AddOption


class KVStagingWriter:
    """Double-buffered Add writer for one :class:`KVTable`.

    ``add(keys, deltas)`` submits the batch for background prep and
    dispatches any batches whose prep (H2D) already landed; when
    ``depth`` batches are in flight it blocks until one drains — the
    pipeline is bounded, not unbounded. ``flush()`` drains everything
    and returns the last table Handle. The caller must not mutate
    ``keys``/``deltas`` until the writer flushes (zero-copy hand-off).

    AddOptions resolve at PREPARE time (see ``KVTable.prepare_add``) —
    an lr schedule advanced mid-pipeline applies from the next batch.
    """

    def __init__(self, table: Any, depth: int = 2, *,
                 option: Optional[AddOption] = None) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._table = table
        self._depth = int(depth)
        self._option = option
        self._req: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        self._ready: "queue.Queue[Tuple]" = queue.Queue()
        self._inflight = 0
        self._last_handle = None
        self._closed = False
        lbl = f"{table.table_id}:{table.name}"
        self._lbl = lbl
        self._m_batches = telemetry.counter("client.stage.batches",
                                            table=lbl)
        self._m_inflight = telemetry.gauge("client.stage.inflight",
                                           table=lbl)
        self._qg = telemetry.QueueGauges(f"stage:{lbl}")
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self) -> None:
        while True:
            item = self._req.get()
            if item is None:
                return
            keys, deltas, option, token = item
            self._qg.on_take()
            try:
                # the off-thread prep chains to the add that submitted it
                with tracing.adopt(token):
                    with tracing.span("client.stage_prepare",
                                      table=self._lbl):
                        prepared = self._table.prepare_add(keys, deltas,
                                                           option)
                self._ready.put((prepared, None, token))
            except BaseException as exc:    # surfaces on the caller side
                self._ready.put((None, exc, token))

    def _land(self, item: Tuple) -> None:
        """Dispatch one prepared batch on the caller's thread."""
        prepared, exc, token = item
        self._inflight -= 1
        self._m_inflight.set(self._inflight)
        if exc is not None:
            raise exc
        # the dispatch chains to the batch's ORIGINAL request, not to
        # whichever later add happened to drain it
        with tracing.adopt(token):
            with tracing.span("client.stage_dispatch",
                              table=self._lbl):
                self._last_handle = self._table.add_prepared(prepared)

    def add(self, keys: Any, deltas: Any,
            option: Optional[AddOption] = None) -> None:
        """Submit one Add batch into the pipeline (prep off-thread,
        dispatch on the next add/flush once its H2D lands)."""
        if self._closed:
            raise RuntimeError("KVStagingWriter already closed")
        with tracing.request("client.stage_add", table=self._lbl):
            self._req.put((keys, deltas,
                           option if option is not None
                           else self._option, tracing.link()))
            self._qg.on_put()
            self._inflight += 1
            self._m_batches.inc()
            self._m_inflight.set(self._inflight)
            # dispatch whatever prep already finished (non-blocking) ...
            while True:
                try:
                    self._land(self._ready.get_nowait())
                except queue.Empty:
                    break
            # ... then apply the depth bound (blocking)
            while self._inflight > self._depth:
                self._land(self._ready.get())

    def flush(self):
        """Drain the pipeline; returns the last dispatched batch's table
        Handle (None when nothing was ever added)."""
        while self._inflight:
            self._land(self._ready.get())
        return self._last_handle

    def close(self):
        """Flush, then stop the worker thread. Returns the last Handle."""
        handle = self.flush() if not self._closed else self._last_handle
        if not self._closed:
            self._closed = True
            self._req.put(None)
            self._thread.join(timeout=5.0)
        return handle

    def __enter__(self) -> "KVStagingWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:   # don't mask the in-flight error with a flush error
            self._closed = True
            self._req.put(None)


def stage_kv_adds(table: Any, batches: Iterable[Tuple[Any, Any]], *,
                  depth: int = 2, option: Optional[AddOption] = None):
    """Drive an iterable of ``(keys, deltas)`` batches through a
    :class:`KVStagingWriter`; returns the last batch's table Handle."""
    with KVStagingWriter(table, depth, option=option) as writer:
        for keys, deltas in batches:
            writer.add(keys, deltas)
        return writer.flush()
