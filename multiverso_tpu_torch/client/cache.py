"""Staleness-bounded get cache: reads that never block on the table.

Counterpart of ``multiverso_tpu/client/cache.py``. The reference serves
worker ``Get``s from a local cache kept within a bounded number of
versions of the server copy (the SSP-style bound), so the hot loop never
pays the round trip. :class:`CachedView` does so over a table:

- it serves the last host snapshot as long as that snapshot is within
  ``max_staleness`` GENERATIONS of the table (its update counter — one
  generation per applied add / superstep / load),
- a refresh is split along the thread-safety line. On the table's
  dispatch thread, inside the generation bump's notification, the view
  takes a fresh snapshot (``Table.get_tensor``: a clone, so the table's
  in-place kernels cannot reach it) and queues its copy into one pinned
  host buffer with ``non_blocking``, then records an event on each
  card's current stream. A persistent worker thread
  (:class:`~multiverso_tpu_torch.utils.async_buffer.ASyncBuffer`) only
  waits on that event and copies the landed bytes out into a new host
  array: it queues no CUDA work, so stream order alone keeps the copy
  ahead of every later add (the ``HostCopy`` argument, ``tables/base.py``),
- the pinned buffer is kept between refreshes (pinning a fresh one costs
  the dispatch thread tens of ms at LightLDA's 205 MB); the worker's
  copy-out means no array a ``get`` returned is ever written again,
- a read that WOULD exceed the bound blocks until a fresh-enough
  snapshot lands: the bound is a guarantee, not a hint.

At most one refresh is in flight at a time (a generation bump while one
is pending is picked up by the next bump or read), so the pinned buffer
is never rewritten while the worker reads it; ``max_staleness=0`` still
dedupes: repeated reads of an unchanged table cost no snapshot.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.control import knobs as _knobs
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry import trace as tracing
from multiverso_tpu_torch.utils.async_buffer import ASyncBuffer


class CachedView:
    """Bounded-staleness host view of one dense table's logical value.

    Works on any :class:`multiverso_tpu_torch.tables.base.Table`
    (ArrayTable / MatrixTable / SparseMatrixTable — anything with
    ``get_tensor()`` and a ``generation`` counter). KVTables are keyed,
    not whole-value; their cached-read analog is ``get_async`` plus
    coalescing.

    Reads (``get``) may come from any thread; table UPDATES come from the
    table's dispatch thread, as every table op does.

    ``max_staleness`` is the live ``client.staleness`` knob binding.
    ``refreshes`` counts the background refreshes queued and
    ``staging_allocs`` the pinned buffers made for them (one for a table
    that keeps its shape); ``last_refresh_s`` is the dispatch thread's
    time to queue the latest refresh and ``last_wait_s`` /
    ``last_copy_s`` the worker's wait on its event and its copy-out.
    """

    def __init__(self, table: Any, max_staleness: int = 0, *,
                 background: bool = True) -> None:
        if max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        mesh = getattr(table, "mesh", None)
        if mesh is not None and mesh.model_split:
            # a snapshot of such a table is a collective, which a refresh
            # on a generation bump calls on one process and not another
            raise NotImplementedError(
                "a cached view of a table whose model axis crosses "
                "processes is not ported (ROADMAP.md queue A item 12)")
        self._table = table
        self.max_staleness = int(max_staleness)
        self._lock = threading.Lock()
        self._closed = False
        lbl = f"{table.table_id}:{table.name}"
        self._lbl = lbl
        self._m_hits = telemetry.counter("client.cache.hits", table=lbl)
        self._m_misses = telemetry.counter("client.cache.misses",
                                           table=lbl)
        self._m_staleness = telemetry.gauge("client.cache.staleness",
                                            table=lbl)
        self._h_get = telemetry.histogram(
            "client.get.seconds", telemetry.LATENCY_BUCKETS, table=lbl)
        # control-plane binding: get() reads max_staleness per call,
        # so a controller write widens/narrows the bound live
        _knobs.bind("client.staleness", self, "max_staleness",
                    label=lbl)
        self._staging: Optional[torch.Tensor] = None
        self.refreshes = 0
        self.staging_allocs = 0
        self.last_refresh_s = 0.0
        self.last_wait_s = 0.0
        self.last_copy_s = 0.0
        # a view never serves nothing: first snapshot is synchronous
        self._gen, self._val = self._sync_snapshot()
        # refresh pipeline: (generation, pinned host buffer, events, trace
        # link) handed to the worker, which only WAITS and copies out
        self._req: "queue.Queue[Optional[Tuple[int, Any, Any, Any]]]" = \
            queue.Queue()
        self._inflight = False
        self._buf: Optional[ASyncBuffer] = (
            ASyncBuffer(self._fill, name=f"view:{lbl}")
            if background else None)
        table._attach_view(self)

    # -- snapshot machinery -----------------------------------------------

    def _sync_snapshot(self) -> Tuple[int, np.ndarray]:
        """(generation, host value), queued AND read on the calling
        thread. The generation is read BEFORE the snapshot: updates apply
        in stream order, so the snapshot reflects at least that
        generation (it may be fresher)."""
        gen = self._table.generation
        return gen, self._table.get_tensor().cpu().numpy()

    def _staging_for(self, snap: torch.Tensor) -> torch.Tensor:
        """The pinned host buffer for ``snap``: the one kept from the last
        refresh when it fits, else a new one."""
        buf = self._staging
        if buf is None or buf.shape != snap.shape or buf.dtype != snap.dtype:
            buf = torch.empty(snap.shape, dtype=snap.dtype,
                              pin_memory=snap.is_cuda)
            self._staging = buf
            self.staging_allocs += 1
        return buf

    def _fill(self, _idx: int) -> Optional[Tuple[int, np.ndarray]]:
        """Worker-thread body: wait for a queued snapshot copy to land and
        copy it out into a new host array. No CUDA work is queued here
        (see the module docstring)."""
        item = self._req.get()
        if item is None:                # close() sentinel
            return None
        gen, host, events, token = item
        # the wait chains to whatever request triggered the refresh
        with tracing.adopt(token):
            with tracing.span("client.d2h_wait", table=self._lbl,
                              gen=gen):
                t0 = time.perf_counter()
                for event in events:
                    event.synchronize()
                t1 = time.perf_counter()
                val = host.clone().numpy()
                self.last_wait_s = t1 - t0
                self.last_copy_s = time.perf_counter() - t1
                return gen, val

    def _on_table_update(self) -> None:
        """Table hook, invoked on the table's dispatch thread right after
        a generation bump: queue one snapshot and its copy to the pinned
        buffer (the wait happens on the worker) unless one is already in
        flight."""
        if self._buf is None or self._closed or self._inflight:
            return
        gen = self._table.generation
        if gen == self._gen:
            return
        t0 = time.perf_counter()
        snap = self._table.get_tensor()
        host = self._staging_for(snap)
        host.copy_(snap, non_blocking=True)
        events = []
        if snap.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(snap.device))
            events.append(event)
        self._inflight = True
        self._req.put((gen, host, events, tracing.link()))
        self.refreshes += 1
        self.last_refresh_s = time.perf_counter() - t0

    def _absorb(self, snap: Optional[Tuple[int, np.ndarray]]) -> None:
        self._inflight = False
        if snap is not None:
            gen, val = snap
            if gen > self._gen:
                self._gen, self._val = gen, val

    # -- reads -------------------------------------------------------------

    @property
    def generation(self) -> int:
        """Generation of the snapshot currently served."""
        return self._gen

    def staleness(self) -> int:
        """Current gap (generations) between the table and the served
        snapshot."""
        return self._table.generation - self._gen

    def get(self, max_staleness: Optional[int] = None) -> np.ndarray:
        """The cached host value, guaranteed within ``max_staleness``
        generations of the table. Non-blocking on the hit path; a read
        past the bound blocks on the in-flight refresh (or snapshots
        synchronously).

        The bound defaults to the view's ``max_staleness``; pass
        ``max_staleness=`` to override it for THIS read only (``0``
        forces freshness, a larger value lets a tolerant reader skip the
        wait a strict default would impose)."""
        bound = self.max_staleness if max_staleness is None \
            else int(max_staleness)
        if bound < 0:
            raise ValueError("max_staleness must be >= 0")
        t0 = time.monotonic()
        try:
            with tracing.request("client.get", table=self._lbl), \
                    self._lock:
                cur = self._table.generation
                if self._inflight and self._buf is not None:
                    snap = self._buf.poll()  # absorb finished refresh
                    if snap is not None:
                        self._absorb(snap)
                stale = cur - self._gen
                self._m_staleness.set(max(stale, 0))
                if stale <= bound:
                    self._m_hits.inc()
                    return self._val
                self._m_misses.inc()
                if self._inflight and self._buf is not None:
                    with tracing.span("client.d2h_wait",
                                      table=self._lbl):
                        self._absorb(self._buf.get())  # blocking wait
                if cur - self._gen > bound:
                    # the in-flight refresh was older than needed (or none
                    # was running): snapshot here, on the reading thread —
                    # for single-dispatcher apps this IS the dispatch
                    # thread
                    self._absorb(self._sync_snapshot())
                return self._val
        finally:
            self._h_get.observe(time.monotonic() - t0)

    def refresh(self) -> np.ndarray:
        """Force an up-to-date snapshot (staleness 0 as of the call)."""
        with self._lock:
            if self._inflight and self._buf is not None:
                # the worker may still be reading the pinned buffer
                self._absorb(self._buf.get())
            self._absorb(self._sync_snapshot())
            return self._val

    def close(self) -> None:
        """Stop the background reader (idempotent)."""
        self._closed = True
        if self._buf is not None:
            self._req.put(None)         # release a fill blocked on _req
            self._buf.stop()
            self._buf = None

    def __enter__(self) -> "CachedView":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
