"""Delta coalescing: the reference's worker-side Aggregator as a buffer.

Counterpart of ``multiverso_tpu/client/coalesce.py``. Workers do NOT ship
every local delta: deltas accumulate in a client-side buffer and reach
the table as one summed update. Every table ``add`` is its own dispatch
(host prep, kernel launches, generation bump), so K small adds pay K
dispatches. :class:`CoalescingBuffer` absorbs up to ``max_deltas`` adds
(or a byte / age budget) per table and flushes them as ONE add.

Semantics (the SSP-style contract coalescing opts into):

- Buffered deltas are INVISIBLE to reads until their flush; fused
  supersteps and ``store``/``load`` force a flush first (the table
  attaches the buffer via ``_attach_coalescer``), so ops that must
  observe every prior add still do.
- Summation before a single updater step is EXACT for the linear
  updaters (``default``, ``sgd``) and the standard mini-batch
  approximation for stateful ones (one state update for K deltas).
- Deltas are cast to the table's type at buffer time, as a direct
  ``add`` would have cast each one.
- KV / row / COO adds coalesce BY KEY: duplicate keys across the
  buffered batches are pre-summed before the flush, which also
  satisfies the table layer's unique-keys-per-add rule.

Deltas may be numpy arrays or tensors (ids and keys likewise). Host ids
are unique'd with ``np.unique``; ids on a card with ``torch.unique(
sorted=True, return_inverse=True)``, which gives the same unique ids in
the same order and the same inverse (a KV key tensor holds the uint64
bit patterns as int64 and is sorted as unsigned). Host deltas with host
ids pre-sum with ``np.add.at``, as in the reference; otherwise every
delta goes to one device (the card's when any part is there) and the
pre-sum is the row scatter-add (``ops.table_kernels.row_scatter_add``)
of the deltas into a zero ``[n_unique, C]`` tensor at the inverse ids:
the CUDA kernel on a card, its plain version on the CPU. Each row
receives its deltas in lane order from zero, ``np.add.at``'s left fold,
so the sums are bit-identical to the reference's. No card delta is
copied to the host to be summed. The kernel takes float32 and int32
deltas, so a float16 KV table's card deltas are refused with a
TypeError (its host deltas sum with ``np.add.at`` as the reference's
do). A bfloat16 table is refused at construction: numpy has no
bfloat16, and no torch sum rounds as the reference's does.
``MatrixTable.add_rows`` and ``SparseMatrixTable.add_sparse`` take host
arrays, so a row or COO flush of card deltas copies the SUMMED deltas to
the host once.

Every buffered add returns a :class:`PendingHandle` — Handle-compatible
(``wait``/``done``/``result``); ``wait()`` forces the flush carrying the
delta and then blocks on the table.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from multiverso_tpu_torch.control import knobs as _knobs
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry import trace as tracing
from multiverso_tpu_torch.updaters import AddOption

#: flips a signed int64 key's top bit: signed order of the flipped keys is
#: unsigned order of the keys (torch has no uint64 sort)
_SIGN = -(1 << 63)


def presum(zeros: torch.Tensor, inv: torch.Tensor,
           deltas: torch.Tensor) -> torch.Tensor:
    """``zeros[inv] += deltas`` in lane order (the duplicate-key pre-sum):
    the row scatter-add kernel on a card, its plain version on the CPU."""
    if zeros.device.type == "cpu":
        return tk.row_scatter_add_plain(zeros, inv, deltas)
    return tk.row_scatter_add(zeros, inv, deltas)


def _nbytes(x: Any) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else x.nbytes


def _np_dtype(table: Any) -> np.dtype:
    """The numpy type of the table's values (a KVTable keeps a torch
    type, a remote table of the wire transport a numpy one); a bfloat16
    table, which numpy cannot sum, raises."""
    if hasattr(table, "np_dtype"):
        return table.np_dtype
    if isinstance(table.dtype, np.dtype):
        return table.dtype
    if table.dtype == torch.bfloat16:
        raise TypeError(
            f"kv table {table.name!r}: coalescing a bfloat16 table is not "
            "supported (numpy has no bfloat16 to pre-sum in)")
    return torch.empty(0, dtype=table.dtype).numpy().dtype


class PendingHandle:
    """Async handle for a BUFFERED delta (Handle-compatible surface).

    Carries the flush ticket its delta will ride: ``wait()`` forces that
    flush (if it has not happened) and then blocks on the table — the
    same generation contract as :class:`multiverso_tpu_torch.tables.base
    .Handle`: updates apply in stream order, so the table's queued work
    being done implies this delta's flush has been applied.
    """

    def __init__(self, buffer: "CoalescingBuffer", ticket: int,
                 request_id: Optional[str] = None) -> None:
        self._buffer = buffer
        self._ticket = ticket
        #: request id minted by the buffered add this handle tracks —
        #: ``wait()`` re-enters that request's trace tree
        self.request_id = request_id

    def flushed(self) -> bool:
        """True once the flush carrying this delta has been dispatched."""
        return self._buffer.flush_generation > self._ticket

    def done(self) -> bool:
        """Non-blocking: False while buffered; after the flush, the
        underlying table handle's readiness."""
        if not self.flushed():
            return False
        h = self._buffer._last_handle
        return h is not None and h.done()

    def wait(self) -> Any:
        # re-enter this delta's request scope: the wait span (and the
        # flush it may force) chain to the add that minted the id
        with tracing.adopt((self.request_id, None)
                           if self.request_id else None):
            with tracing.span("client.wait"):
                self._buffer.flush_through(self._ticket)
                h = self._buffer._last_handle
                assert h is not None
                return h.wait()

    def result(self) -> Any:
        return self.wait()


class CoalescingBuffer:
    """Accumulate adds against one table; flush as ONE add.

    One buffer holds ONE pending group at a time: a group is (op kind,
    AddOption) — an add of a different kind (dense / kv / rows / coo) or
    with a different explicit option forces the current group out first,
    preserving update order. Thread-safe.

    Flush triggers (checked on every buffered add, whichever fires
    first): ``max_deltas`` buffered adds, ``max_bytes`` of buffered
    payload, ``max_age_s`` since the group's first add (age is only
    observed at add/:meth:`maybe_flush` time — there is no timer
    thread). ``flush()`` forces; supersteps and store/load force through
    the table's ``flush_coalesced`` hook. ``max_deltas`` is the live
    ``client.coalesce_k`` knob binding.
    """

    def __init__(self, table: Any, max_deltas: int = 8, *,
                 max_bytes: Optional[int] = None,
                 max_age_s: Optional[float] = None,
                 option: Optional[AddOption] = None) -> None:
        if max_deltas < 1:
            raise ValueError("max_deltas must be >= 1")
        self._table = table
        self._np_dtype = _np_dtype(table)
        self.max_deltas = int(max_deltas)
        self.max_bytes = max_bytes
        self.max_age_s = max_age_s
        self._default_option = option
        self._lock = threading.RLock()
        self._kind: Optional[str] = None
        self._option: Optional[AddOption] = None
        self._count = 0
        self._bytes = 0
        self._first_ts: Optional[float] = None
        # dense accumulator / batched-op part lists
        self._acc: Any = None
        self._ids: List[Any] = []          # kv keys / row ids / coo keys
        self._deltas: List[Any] = []
        self._flush_gen = 0
        self._last_handle = None
        lbl = f"{table.table_id}:{table.name}"
        self._lbl = lbl
        self._m_flushes = telemetry.counter("client.coalesce.flushes",
                                            table=lbl)
        self._m_deltas = telemetry.counter("client.coalesce.deltas",
                                           table=lbl)
        self._m_bytes = telemetry.counter("client.coalesce.bytes",
                                          table=lbl)
        self._h_flush = telemetry.histogram(
            "client.flush.seconds", telemetry.LATENCY_BUCKETS, table=lbl)
        # control-plane binding: _maybe_flush_locked reads max_deltas
        # per buffered add, so K moves live
        _knobs.bind("client.coalesce_k", self, "max_deltas", label=lbl)
        # occupancy as a queue gauge: buffered-delta count + group age
        self._qg = telemetry.QueueGauges(f"coalesce:{lbl}")
        # request ids riding the open group (stamped onto the flush
        # span — a coalesced flush serves MANY requests)
        self._req_ids: List[str] = []
        table._attach_coalescer(self)

    # -- state -------------------------------------------------------------

    @property
    def flush_generation(self) -> int:
        """Number of flushes dispatched so far (PendingHandle tickets
        compare against it)."""
        return self._flush_gen

    @property
    def pending_deltas(self) -> int:
        return self._count

    @property
    def pending_bytes(self) -> int:
        return self._bytes

    def _start_group(self, kind: str, option: Optional[AddOption]) -> None:
        """Flush-on-boundary: a kind or option change closes the open
        group (update order across groups is preserved)."""
        opt = option if option is not None else self._default_option
        if self._count and (self._kind != kind or self._option != opt):
            self._flush_locked()
        self._kind = kind
        self._option = opt
        if self._first_ts is None:
            self._first_ts = time.monotonic()

    def _buffered(self, nbytes: int) -> int:
        """Account one buffered add; returns its PendingHandle ticket."""
        self._count += 1
        self._bytes += int(nbytes)
        self._m_deltas.inc()
        self._m_bytes.inc(int(nbytes))
        rid = tracing.current_request()
        if rid is not None:
            self._req_ids.append(rid)
        self._qg.sample(self._count,
                        time.monotonic() - self._first_ts
                        if self._first_ts is not None else 0.0)
        return self._flush_gen

    def _maybe_flush_locked(self) -> None:
        if (self._count >= self.max_deltas
                or (self.max_bytes is not None
                    and self._bytes >= self.max_bytes)
                or (self.max_age_s is not None
                    and self._first_ts is not None
                    and time.monotonic() - self._first_ts
                    >= self.max_age_s)):
            self._flush_locked()

    def _values(self, deltas: Any) -> Any:
        """A delta in the table's type: a tensor stays a tensor (on its
        device), a host array numpy."""
        if isinstance(deltas, torch.Tensor):
            return deltas.to(self._table.dtype)
        return np.asarray(deltas, dtype=self._np_dtype)

    # -- buffered add variants --------------------------------------------

    def add(self, delta: Any,
            option: Optional[AddOption] = None) -> PendingHandle:
        """Buffer a whole-table dense delta (``Table.add`` shape rules:
        logical or padded); a tensor accumulates with ``+=`` on its
        device."""
        arr = self._values(delta)
        with tracing.request("client.add", table=self._lbl,
                             kind="dense") as rid, self._lock:
            self._start_group("dense", option)
            if self._acc is None:
                self._acc = arr.clone() if isinstance(arr, torch.Tensor) \
                    else arr.copy()
            else:
                if tuple(arr.shape) != tuple(self._acc.shape):
                    raise ValueError(
                        f"coalesced delta shape {tuple(arr.shape)} != "
                        f"buffered {tuple(self._acc.shape)} (flush between "
                        "shapes)")
                if isinstance(arr, torch.Tensor) \
                        and not isinstance(self._acc, torch.Tensor):
                    self._acc = torch.as_tensor(self._acc, device=arr.device)
                if isinstance(self._acc, torch.Tensor):
                    self._acc += torch.as_tensor(arr, device=self._acc.device)
                else:
                    self._acc += arr
            ticket = self._buffered(_nbytes(arr))
            self._maybe_flush_locked()
            return PendingHandle(self, ticket, rid)

    def add_kv(self, keys: Any, deltas: Any,
               option: Optional[AddOption] = None) -> PendingHandle:
        """Buffer a KV batch; duplicate keys WITHIN and ACROSS buffered
        batches pre-sum at flush (the Aggregator role). Host keys are
        uint64; a key tensor holds their bit patterns as int64."""
        keys = keys if isinstance(keys, torch.Tensor) \
            else np.asarray(keys, dtype=np.uint64)
        deltas = self._values(deltas)
        if len(deltas) != len(keys):
            raise ValueError(f"deltas length {len(deltas)} != keys "
                             f"length {len(keys)}")
        with tracing.request("client.add", table=self._lbl,
                             kind="kv") as rid, self._lock:
            self._start_group("kv", option)
            self._ids.append(keys)
            self._deltas.append(deltas)
            ticket = self._buffered(_nbytes(deltas))
            self._maybe_flush_locked()
            return PendingHandle(self, ticket, rid)

    def add_rows(self, row_ids: Any, deltas: Any,
                 option: Optional[AddOption] = None) -> PendingHandle:
        """Buffer a MatrixTable row batch; duplicate row ids pre-sum at
        flush (which also satisfies the stateful-updater unique-ids
        rule)."""
        ids = row_ids if isinstance(row_ids, torch.Tensor) \
            else np.asarray(row_ids, dtype=np.int32)
        deltas = self._values(deltas)
        if tuple(deltas.shape) != (len(ids), self._table.num_cols):
            raise ValueError(f"deltas shape {tuple(deltas.shape)} != "
                             f"({len(ids)}, {self._table.num_cols})")
        with tracing.request("client.add", table=self._lbl,
                             kind="rows") as rid, self._lock:
            self._start_group("rows", option)
            self._ids.append(ids)
            self._deltas.append(deltas)
            ticket = self._buffered(_nbytes(deltas))
            self._maybe_flush_locked()
            return PendingHandle(self, ticket, rid)

    def add_sparse(self, rows: Any, cols: Any, values: Any,
                   option: Optional[AddOption] = None) -> PendingHandle:
        """Buffer a COO batch; duplicate (row, col) pairs pre-sum at
        flush."""
        if isinstance(rows, torch.Tensor) or isinstance(cols, torch.Tensor):
            dev = rows.device if isinstance(rows, torch.Tensor) \
                else cols.device
            rows = torch.as_tensor(rows, device=dev).long()
            cols = torch.as_tensor(cols, device=dev).long()
        else:
            rows = np.asarray(rows, dtype=np.int64)
            cols = np.asarray(cols, dtype=np.int64)
        values = self._values(values)
        if not (tuple(rows.shape) == tuple(cols.shape)
                == tuple(values.shape)) or rows.ndim != 1:
            raise ValueError("COO arrays must be same-length 1-D")
        with tracing.request("client.add", table=self._lbl,
                             kind="coo") as rid, self._lock:
            self._start_group("coo", option)
            # flat (row, col) key — split back at flush
            self._ids.append(rows * self._table.num_cols + cols)
            self._deltas.append(values)
            ticket = self._buffered(_nbytes(values))
            self._maybe_flush_locked()
            return PendingHandle(self, ticket, rid)

    # -- flush -------------------------------------------------------------

    def _unique(self, ids: List[Any], device: torch.device):
        """The buffered ids concatenated and unique'd: ``(uniq, inv)``,
        numpy when every part is (``np.unique``), else tensors on
        ``device`` (``torch.unique``; KV keys sorted as unsigned)."""
        if not any(isinstance(i, torch.Tensor) for i in ids):
            return np.unique(np.concatenate(ids), return_inverse=True)
        cat = torch.cat([torch.as_tensor(
            i.view(np.int64) if isinstance(i, np.ndarray)
            and i.dtype == np.uint64 else i, device=device).long()
            for i in ids])
        flip = self._kind == "kv"
        uniq, inv = torch.unique(cat ^ _SIGN if flip else cat, sorted=True,
                                 return_inverse=True)
        return (uniq ^ _SIGN if flip else uniq), inv

    def _summed_unique(self):
        """Concatenate the buffered (ids, deltas) parts and pre-sum
        duplicates: the ONE batch the flush dispatches. Returns ``(uniq,
        summed)``: ``uniq`` numpy or a tensor, ``summed`` numpy when every
        part was a host array, else a tensor on the parts' device."""
        tensors = [d for d in self._deltas + self._ids
                   if isinstance(d, torch.Tensor)]
        if not tensors:
            uniq, inv = self._unique(self._ids, None)
            deltas = np.concatenate(self._deltas, axis=0)
            summed = np.zeros((len(uniq),) + deltas.shape[1:], deltas.dtype)
            np.add.at(summed, inv, deltas)
            return uniq, summed
        cards = [t.device for t in tensors if t.device.type != "cpu"]
        device = cards[0] if cards else torch.device("cpu")
        uniq, inv = self._unique(self._ids, device)
        deltas = torch.cat([torch.as_tensor(d, device=device)
                            for d in self._deltas])
        n = len(uniq)
        summed = torch.zeros((n,) + tuple(deltas.shape[1:]),
                             dtype=deltas.dtype, device=device)
        presum(summed.view(n, -1), torch.as_tensor(inv, device=device),
               deltas.reshape(len(deltas), -1))
        return uniq, summed

    def _flush_locked(self):
        if self._count == 0:
            return None
        kind, opt = self._kind, self._option
        t0 = time.monotonic()
        # one flush serves MANY requests: the span lists every request
        # id that buffered into this group
        with tracing.span("client.flush", table=self._lbl, kind=kind,
                          n=self._count, reqs=list(self._req_ids)):
            if kind == "dense":
                handle = self._table.add(self._acc, opt)
            else:
                uniq, summed = self._summed_unique()
                if isinstance(uniq, torch.Tensor):
                    uniq = uniq.cpu().numpy()
                if kind == "kv":
                    handle = self._table.add(uniq.view(np.uint64), summed,
                                             opt)
                else:
                    # the row and COO adds take host arrays
                    if isinstance(summed, torch.Tensor):
                        summed = summed.cpu().numpy()
                    if kind == "rows":
                        handle = self._table.add_rows(
                            uniq.astype(np.int32), summed, opt)
                    else:   # coo
                        ncols = self._table.num_cols
                        handle = self._table.add_sparse(
                            (uniq // ncols).astype(np.int32),
                            (uniq % ncols).astype(np.int32), summed, opt)
        self._h_flush.observe(time.monotonic() - t0)
        self._acc = None
        self._ids, self._deltas = [], []
        self._req_ids = []
        self._count = 0
        self._bytes = 0
        self._first_ts = None
        self._qg.sample(0, 0.0)
        self._flush_gen += 1
        self._last_handle = handle
        self._m_flushes.inc()
        return handle

    def flush(self):
        """Dispatch the buffered group as one add. Returns that add's
        table Handle (None when nothing was buffered)."""
        with self._lock:
            return self._flush_locked()

    def maybe_flush(self):
        """Apply the byte/age/count budgets without buffering anything —
        for callers that want the age trigger honored between adds."""
        with self._lock:
            self._maybe_flush_locked()

    def flush_through(self, ticket: int) -> None:
        """Ensure the flush carrying ``ticket`` has been dispatched
        (PendingHandle.wait's entry point)."""
        with self._lock:
            if self._flush_gen <= ticket:
                self._flush_locked()

    # flush-on-exit context manager
    def __enter__(self) -> "CoalescingBuffer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.flush()
