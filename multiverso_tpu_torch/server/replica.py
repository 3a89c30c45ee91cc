"""Snapshot read replicas: staleness-bounded reads off the dispatch
thread.

Counterpart of ``multiverso_tpu/server/replica.py``. The device copy is
a :class:`~multiverso_tpu_torch.tables.base.HostCopy` queued on the
dispatch thread (the table's current stream); the publisher thread
waits on its CUDA events only, and no reader thread touches a tensor.

On the wire server every table op funnels into ONE dispatch thread (the
single-dispatch-thread contract), so under a write-heavy load every
``get`` queues behind every ``add`` — reads pay for writes. A
:class:`TableReplica` breaks that coupling for clients that can tolerate
bounded staleness: a ``get``/``kv_get`` frame carrying a ``staleness``
header (max generations behind) is answered directly on the
connection's READER thread from a host-side snapshot, never entering
the dispatch queue at all.

The two halves respect the threading contract strictly:

- **dispatch half** (``_on_table_update``, via the table's
  ``_attach_view`` hook — notifications run on the add's thread, which
  on a server IS the dispatch thread): queues an async device-to-host
  copy (dense: ``get_tensor``; KV: ``snapshot_kv_async``, each into a
  ``HostCopy``) and hands it to the worker. One snapshot in flight at a time — under an add storm
  the replica refreshes at the rate D2H can drain, not per add.
- **publisher thread** (one daemon per replica): blocks on the copy's
  events (the D2H the dispatch thread must never wait on), builds the
  servable form, publishes ``(generation, payload)`` under the lock.
  For KV that form is (sorted live uint64 keys, row-matched values):
  reader threads then serve lookups with ``np.searchsorted`` — no
  tensor anywhere near a reader thread.

A replica starts DORMANT (zero overhead on the write path) and is
armed by the first staleness-tolerant read, which itself is served
fresh through the dispatch queue. Freshness check at serve time is two
plain int reads — ``table.generation - snapshot_generation <= bound``;
a miss (no snapshot yet, bound exceeded, in-flight refresh) falls back
to the dispatch queue, where the miss handler kicks another refresh.
Tiered KV tables are not replicated: their device arrays hold only the
resident tier, so a device snapshot would serve wrong (tier-partial)
reads. On a replication follower a replica measures its staleness
against the repl stream (``stream``), as the reference's does.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.control import knobs as _knobs
from multiverso_tpu_torch.tables.base import HostCopy
from multiverso_tpu_torch.tables.hashing import _join_keys
from multiverso_tpu_torch.server import wire
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.utils import log


# -- a table's values on the host and on the wire ---------------------------

def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type a table of ``dtype`` holds on the host: numpy's
    own, or for bfloat16 (which numpy lacks) its uint16 bit patterns."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def wire_dtype(dtype: torch.dtype) -> str:
    """The reference's ``np.dtype(table.dtype).str`` of a table type."""
    return wire.BF16_TAG if dtype == torch.bfloat16 \
        else host_dtype(dtype).str


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host in its :func:`host_dtype` (blocking)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_wire(host: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Host-form values of a ``dtype`` table as the reference puts them
    on the wire (bfloat16 bits tagged :data:`wire.BF16_TAG`)."""
    host = np.ascontiguousarray(host)
    return wire.bf16_bits(host) if dtype == torch.bfloat16 else host


class TableReplica:
    """One table's read replica (see module docstring)."""

    def __init__(self, table: Any, kind: str, *,
                 server: str = "tables", stream: Any = None,
                 tid: Optional[int] = None) -> None:
        if kind not in ("array", "kv"):
            raise ValueError(f"no replica for table kind {kind!r}")
        self.table = table
        self.kind = kind
        # on a FOLLOWER the honest staleness reference is not the
        # local generation but the newest primary generation the repl
        # stream has ANNOUNCED at intake (frames noted but not yet
        # applied are real lag the local generation can't see):
        # ``stream`` is the server's FollowerState, or None on a
        # primary. ``tid`` is the WIRE table id the stream keys on
        # (the registry id on ``table`` is a different id space).
        self.stream = stream
        self.tid = int(tid) if tid is not None else None
        # a missing key's value in the table's host form (bfloat16 bits)
        self._fill = host_array(torch.tensor(
            float(getattr(table, "default_value", 0.0)),
            dtype=table.dtype))
        self._lock = threading.Lock()
        self._gen = -1              # generation of the published snapshot
        self._value: Any = None     # dense: ndarray; kv: (keys64, values)
        self._armed = False
        self._inflight = False
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        lbl = f"{table.table_id}:{table.name}"
        self._g_gen = telemetry.gauge("server.replica.generation",
                                      server=server, table=lbl)
        self._g_stale = telemetry.gauge("server.replica.staleness",
                                        server=server, table=lbl)
        self._c_hits = telemetry.counter("server.replica.hits",
                                         server=server)
        self._c_misses = telemetry.counter("server.replica.misses",
                                           server=server)
        self._c_degraded = telemetry.counter(
            "server.replica.degraded_hits", server=server)
        self._c_relaxed = telemetry.counter(
            "server.replica.relaxed_hits", server=server)
        # control-plane staleness slack: extra generations a snapshot
        # may lag past the CLIENT-requested bound and still be served
        # (a relaxed reply carries the real staleness). 0 = strict.
        self.slack = _knobs.initial("server.replica.slack")
        _knobs.bind("server.replica.slack", self, "slack",
                    label=f"{server}:{lbl}")

    # -- dispatch-thread half ----------------------------------------------

    def arm(self) -> None:
        """First staleness-tolerant read arms the replica (idempotent;
        dispatch thread only — ``_attach_view`` and the first snapshot
        dispatch both require it)."""
        if self._armed:
            return
        self._armed = True
        self._thread = threading.Thread(
            target=self._publisher, daemon=True,
            name=f"replica-{self.table.name}")
        self._thread.start()
        self.table._attach_view(self)
        self._on_table_update()

    def refresh(self) -> None:
        """Re-kick after a bound miss (dispatch thread): if the last
        notification's snapshot was dropped because one was already in
        flight, this closes the gap. No-op while armed + in flight."""
        self._on_table_update()

    def _on_table_update(self) -> None:
        # the table's view hook: runs on the thread that applied the
        # add == the server dispatch thread. Dispatch-only: the D2H
        # wait lives on the publisher thread.
        if not self._armed:
            return
        with self._lock:
            if self._inflight:
                return
            self._inflight = True
        gen = self.table.generation
        try:
            if self.kind == "kv":
                keys, vals = self.table.snapshot_kv_async()
                fut = (HostCopy([keys]), HostCopy([vals]))
            else:
                fut = HostCopy([self.table.get_tensor()])
        except Exception as exc:    # noqa: BLE001 — replica must not
            with self._lock:        # take the dispatch thread down
                self._inflight = False
            log.warn("replica %r: snapshot dispatch failed: %s",
                     self.table.name, exc)
            return
        self._q.put((gen, fut))

    # -- publisher thread --------------------------------------------------

    def _publisher(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            gen, fut = item
            try:
                if self.kind == "kv":
                    value = self._host_kv(fut)
                else:
                    value = np.ascontiguousarray(fut.numpy())
            except Exception as exc:    # noqa: BLE001
                log.warn("replica %r: snapshot publish failed: %s",
                         self.table.name, exc)
                value = None
            with self._lock:
                if value is not None and gen > self._gen:
                    self._gen = gen
                    self._value = value
                self._inflight = False
            if value is not None:
                self._g_gen.set(float(gen))

    @staticmethod
    def _host_kv(fut) -> Tuple[np.ndarray, np.ndarray]:
        keys_fut, vals_fut = fut
        # (B, S, 2) int32 bit patterns on the device -> uint32 words
        host_keys = keys_fut.numpy().view(np.uint32)
        host_vals = vals_fut.numpy()
        live = ~(host_keys == np.uint32(0xFFFFFFFF)).all(-1)
        k64 = _join_keys(host_keys[live])
        vals = host_vals[live]
        order = np.argsort(k64, kind="stable")
        return k64[order], np.ascontiguousarray(vals[order])

    # -- reader-thread half ------------------------------------------------

    def serve(self, header: Dict[str, Any], arrays: List[np.ndarray],
              relax: bool = False) -> Optional[tuple]:
        """Serve one staleness-tolerant read on a READER thread, or
        return ``None`` (miss — the frame takes the dispatch queue and
        its handler calls :meth:`arm`/:meth:`refresh`). Never touches
        a tensor.

        ``relax=True`` is degraded-mode routing (the admission layer is
        shedding writes): a snapshot PAST the requested bound is served
        anyway rather than queueing the read behind the very overload
        being shed — the reply carries the real ``staleness`` plus a
        ``degraded`` marker so the client can see the bound was
        relaxed. No snapshot at all is still a miss."""
        try:
            bound = max(int(header.get("staleness")), 0)
        except (TypeError, ValueError):
            return None
        with self._lock:
            gen, value = self._gen, self._value
        if value is None:
            self._c_misses.inc()
            return None
        lag = max(self.table.generation - gen, 0)   # plain int reads
        if self.stream is not None and self.tid is not None:
            # follower: lag vs the stream's noted primary generation
            # (>= local generation — frames noted at intake but not
            # yet applied are real lag the local generation can't see)
            lag = max(lag, self.stream.lag(self.tid, gen))
        degraded = False
        relaxed = False
        if lag > bound:
            slack = max(int(self.slack), 0)
            if relax:
                degraded = True
                self._c_degraded.inc()
            elif lag <= bound + slack:
                # within the control plane's staleness slack: serve
                # past the requested bound, marked, rather than
                # queueing the read behind the writes it lags
                relaxed = True
                self._c_relaxed.inc()
            else:
                self._c_misses.inc()
                return None
        self._c_hits.inc()
        self._g_stale.set(float(lag))
        head = {"ok": True, "gen": gen, "replica": True,
                "staleness": lag}
        if self.stream is not None:
            # follower-served replies carry the same markers the
            # dispatch-path follower serve annotates
            head["follower"] = True
            head["lag"] = lag
        # trace echo (the wire's TRACE_KEY, read raw): a replica-served
        # reply names the request it answered, like shed/expired
        # replies do
        tr = header.get("trace")
        if isinstance(tr, dict) and tr.get("req") is not None:
            head["req"] = tr["req"]
        if degraded:
            head["degraded"] = True
        if relaxed:
            head["relaxed"] = True
        if self.kind == "array":
            return (head, [to_wire(value, self.table.dtype)])
        keys = np.ascontiguousarray(arrays[0]).astype(np.uint64,
                                                      copy=False)
        skeys, svals = value
        n = len(keys)
        if len(skeys):
            idx = np.clip(np.searchsorted(skeys, keys), 0,
                          len(skeys) - 1)
            found = skeys[idx] == keys
        else:
            idx = np.zeros(n, np.intp)
            found = np.zeros(n, bool)
        vd = int(getattr(self.table, "value_dim", 0) or 0)
        out = np.full((n, vd) if vd else (n,), self._fill,
                      dtype=self._fill.dtype)
        if found.any():
            out[found] = svals[idx[found]]
        return (head, [to_wire(out, self.table.dtype), found])

    # -- lifecycle / observability -----------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._lock:
            gen = self._gen
            have = self._value is not None
        return {"table": self.table.name, "kind": self.kind,
                "armed": self._armed, "generation": gen,
                "lag": max(self.table.generation - gen, 0) if have
                else None}

    def stop(self) -> None:
        self._q.put(None)
