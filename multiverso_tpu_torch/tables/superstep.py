"""Fused superstep: the supported way for an app to run a custom update
over table storage, with the table contract kept (step and generation
counters, handles).

Counterpart of ``multiverso_tpu/tables/superstep.py``, with the same body
contract::

    body(params, states, locals_, options, *inputs)
        -> (new_params, new_states, new_locals, aux)

where ``params``/``states``/``options`` are tuples aligned with the
``tables`` argument, ``locals_`` is the app-local carry tuple, ``inputs``
are per-call operands and ``aux`` is any other output (losses) or None.

The reference compiles the body into one donated XLA program. Here the
body runs eagerly on each table's live tensors: the reference's donation
becomes an in-place update of each table's tensor (the scatter kernels
write into it), and whatever tensors the body returns become the tables'
storage. Bodies that gather, scatter or COO-add into table storage call
:func:`gather_rows` / :func:`row_scatter_add` / :func:`coo_scatter_add`,
the port's CUDA kernels.

Tables split over the model axis take part too: the body gets each such
table's storage as a
:class:`~multiverso_tpu_torch.ops.table_kernels.ShardedParam` (the
shards, read like one global array), on which the three functional forms
launch the gather and the scatter-adds once per card over the shards it
holds, the counterpart of the reference's ``kernel_mesh_scope`` around
its dispatch.

On a mesh whose data axis D is above 1 (tables replicated over ``data``)
the body runs once per replica, each on a host thread of its own bound
to the replica's first device. The threads take turns on the host, from
one exchange to the next (the GIL would let one queue work at a time
anyway), and the replicas' queued work runs on their cards at once.
Replica ``d`` gets its
own copy of each table (a tensor, or a ShardedParam of data row ``d``'s
shards), part ``d`` of every input the app split with
:class:`DataSplit` (the reference's ``P(None, DATA_AXIS, ...)``) or gave
each replica with :class:`Replicated`, and every other input whole, on
its device. The app-local carries ``locals_`` are each a
:class:`Replicated` (a whole value every replica keeps, the reference's
``P()``) or a :class:`DataSplit` (the part each replica owns, the
reference's ``P(DATA_AXIS)``): replica ``d`` gets part ``d`` and returns
its new part, and the call hands each local back in the kind it came
(off a data axis a wrapped local is its one part; a plain one goes as it
is). A whole local's moves over every lane of a step are the body's to
apply on every replica, each lane once: from lanes every replica holds,
or from lanes exchanged with :func:`replica_cat`. On a view:

- :func:`gather_rows` reads the replica's own copy and exchanges nothing;
- :func:`row_scatter_add` and :func:`coo_scatter_add` are the port's
  counterpart of the psum XLA puts after the reference's scatter: each
  replica posts its lanes, waits until every replica of that step has
  posted, and scatters all of them, concatenated in replica order (the
  global lane order), into its own copy through the same kernel. Every
  replica applies the same lanes in the same order, so the replicas stay
  bit-identical, and the lanes equal those a one-replica run on the whole
  batch scatters;
- :func:`replica_sum` sums a tensor over the replicas through the same
  exchange, wherever the reference's global arrays imply a sum over the
  whole batch (a loss);
- :func:`replica_cat` concatenates every replica's tensor in replica
  order, where the reference's XLA gathers a value split over ``data``
  (the row blocks each replica updated under ``shard_update``);
  :func:`replica_index` is the running replica's ``d``.

Over several processes (``core``'s module doc) each process runs the
threads of its own replicas only (the data rows in which it owns a
cell); ``DataSplit`` / ``Replicated`` parts are this process's
replicas', and :func:`replica_index` is the global data row. An
exchange round completes when the local replicas have posted and one
cross-process all-gather of the local posts
(:func:`~multiverso_tpu_torch.parallel.multihost.allgather_tensors`)
has returned; every replica then reads every replica's tensors in
global replica order, each row's from the first process that owns a
cell of it (a row two processes share is read once), so each row's
float32 sum is taken in the order of the one-process run on the same
global mesh, and the tables equal that run bit for bit.

When the model axis crosses processes a replica's view holds only the
shards of this process's cells (a ShardedParam with None for the
others): its scatter-adds write those shards only (every process of the
row applies the same lanes), and its gathers, and
:meth:`~multiverso_tpu_torch.ops.table_kernels.ShardedParam.whole`,
merge the partials of the row's processes by a bitwise OR in an
exchange round of their own (off a data axis, over the whole group), in
lockstep with the others.

``aux`` is the first local replica's (replica 0's on one process). A
replica that raises aborts the exchange, the
call re-raises its exception and no table advances; a replica that waits
longer than ``EXCHANGE_TIMEOUT`` seconds for its turn raises
``TimeoutError``.
The body's lanes on a view are taken to be the replica's share of the
batch: a scatter of lanes every replica holds whole would be applied D
times (a body whose replicas each hold every lane applies them with the
kernels of ``ops.table_kernels`` directly, as LightLDA's does).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.core import DATA_AXIS, Mesh
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.ops.table_kernels import ShardedParam, gather_rows
from multiverso_tpu_torch.tables.base import Handle, Table
from multiverso_tpu_torch.telemetry import health as _health
from multiverso_tpu_torch.telemetry.profiling import profiled
from multiverso_tpu_torch.updaters import AddOption

__all__ = ["DataSplit", "FusedSuperstep", "Replicated", "ShardedParam",
           "coo_scatter_add", "gather_rows", "local_replica_index",
           "make_superstep", "replica_cat", "replica_index", "replica_sum",
           "row_scatter_add"]

#: seconds a replica waits for its turn before the call fails
EXCHANGE_TIMEOUT = 300.0


class DataSplit:
    """A superstep input split over the data axis: ``parts[d]`` is the
    block replica ``d`` gets (the reference's ``P(None, DATA_AXIS,
    ...)``)."""

    def __init__(self, parts: Sequence[Any]) -> None:
        self.parts = list(parts)

    @classmethod
    def of(cls, value, mesh: Mesh, axis: int = 0) -> "DataSplit":
        """``value`` (numpy or tensor) cut along ``axis`` into the mesh's
        D contiguous equal blocks, block ``d`` on replica ``d``'s first
        device (this process's replicas' blocks only)."""
        n = mesh.shape[DATA_AXIS]
        size = value.shape[axis]
        if size % n:
            raise ValueError(f"axis {axis} of size {size} does not split "
                             f"over a data axis of {n}")
        step, parts = size // n, []
        for d in mesh.local_rows:
            index = [slice(None)] * value.ndim
            index[axis] = slice(d * step, (d + 1) * step)
            block, dev = value[tuple(index)], mesh.row_device(d)
            if isinstance(block, np.ndarray):
                parts.append(torch.as_tensor(np.ascontiguousarray(block),
                                             device=dev))
            else:
                parts.append(block.to(dev).contiguous())
        return cls(parts)


class Replicated:
    """A superstep input or app-local carry that every replica of a data
    axis holds whole: ``parts[d]`` is replica ``d``'s own copy, on its
    device (the reference's ``P()`` placement)."""

    def __init__(self, parts: Sequence[Any]) -> None:
        self.parts = list(parts)

    @classmethod
    def of(cls, value: torch.Tensor, mesh: Mesh) -> "Replicated":
        """``value`` on each (local) replica's first device: the first
        part may share its storage, every other part is a copy."""
        return cls([value.to(mesh.row_device(d), copy=i > 0)
                    for i, d in enumerate(mesh.local_rows)])


#: what a superstep hands replica ``d`` of an input or local: part ``d``
_PER_REPLICA = (DataSplit, Replicated)


class _Aborted(Exception):
    """Raised in a replica waiting at an exchange that another replica's
    failure ended; the call re-raises that failure instead."""


class _Exchange:
    """The lane exchange among the D replica threads of one superstep
    call. Round ``k`` of a replica is its ``k``-th exchange; a round
    completes when every replica has posted to it.

    The threads take turns: one runs at a time, from its start or an
    exchange to its next exchange (or its end), then hands the turn to
    the next replica in order, so a replica that gets the turn back at an
    exchange finds the round complete. The GIL would let only one of
    them queue work at a time anyway; taking turns keeps the others off
    it (threads contending for the GIL at every torch call slowed a step
    many times over on the card) and fixes the order in which the
    replicas queue their work."""

    def __init__(self, n: int, timeout: float,
                 mesh: Optional[Mesh] = None) -> None:
        # n local replicas: global data rows self.rows
        self.n, self.timeout = n, timeout
        self.rows = list(mesh.local_rows) if mesh is not None \
            else list(range(n))
        self.processes = mesh.processes if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        if self.processes > 1:
            self.rows_of = rows_of = [mesh.rows_of(p)
                                      for p in range(self.processes)]
            # each row's lanes come from the first process owning a cell
            # of it
            self.source = {g: min(p for p, rows in enumerate(rows_of)
                                  if g in rows)
                           for g in range(mesh.shape[DATA_AXIS])}
            self.same_shapes = not mesh.rows_split
        self._remote: dict = {}       # round -> every process's posts
        self._lock = threading.Lock()
        # one condition a replica: a hand-over wakes the next one only
        self._conds = [threading.Condition(self._lock) for _ in range(n)]
        self._turn = 0                # the replica that may run
        self._posts: dict = {}        # round -> [(tensors, stream)] * n
        self._reads: dict = {}        # round -> replicas that read it
        self._rounds = [0] * n        # each replica's next round
        self._done = [False] * n
        self.error: Optional[BaseException] = None
        self.bytes = 0                # bytes replicas read from others
        self.gather_s = 0.0           # seconds in cross-process gathers

    def _hand_on(self, replica: int) -> None:
        """Give the turn to the next replica after ``replica`` that has
        not finished (holding the lock)."""
        for step in range(1, self.n + 1):
            nxt = (replica + step) % self.n
            if not self._done[nxt]:
                self._turn = nxt
                self._conds[nxt].notify()
                break

    def _wake_all(self) -> None:
        for cond in self._conds:
            cond.notify_all()

    def _fail(self, error: BaseException) -> None:
        # holding the lock
        if self.error is None:
            self.error = error
        self._wake_all()
        raise _Aborted() from error

    def _wait(self, replica: int, posts: Optional[list] = None,
              k: int = 0) -> None:
        """Block until it is ``replica``'s turn (and, given the posts of
        round ``k``, until the round is complete), holding the lock."""
        deadline = time.monotonic() + self.timeout
        while True:
            if self.error is not None:
                raise _Aborted()
            if self._turn == replica:
                missing = [] if posts is None else \
                    [r for r, p in enumerate(posts) if p is None]
                if not missing:
                    return
                # every other replica had its turn since: they finished
                self._fail(RuntimeError(
                    f"superstep replica {missing[0]} returned after "
                    f"{self._rounds[missing[0]]} exchanges while replica "
                    f"{replica} waits at exchange {k + 1}: every replica "
                    "must scatter and sum the same number of times"))
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(TimeoutError(
                    f"superstep replica {replica} waited {self.timeout} s "
                    f"for its turn (replica {self._turn} holds it)"))
            self._conds[replica].wait(left)

    def start(self, replica: int) -> None:
        with self._lock:
            self._wait(replica)

    def finish(self, replica: int) -> None:
        with self._lock:
            self._done[replica] = True
            self._hand_on(replica)

    def abort(self, replica: int, error: BaseException) -> None:
        """End every wait: the first error is the call's."""
        with self._lock:
            if self.error is None and not isinstance(error, _Aborted):
                self.error = error
            self._done[replica] = True
            self._wake_all()

    def _gather_processes(self, posts: list, merge: bool) -> dict:
        """The other processes' posts of a round (complete here), as
        ``{(process, data row): tensors}`` (CPU tensors). One collective,
        started by the first local reader of the round while it holds the
        turn, so every process starts its rounds' gathers in the same
        order. A lane round (``merge`` False) sends the posts of the rows
        this process is the source of, a merge round every local post
        (each holds the partial of this process's cells of its row). On
        whole rows every process posts the same shapes (lockstep lanes),
        so the gather takes them from the local posts (``same_shapes``)."""
        from multiverso_tpu_torch.parallel import multihost
        t0 = time.perf_counter()
        m = len(posts[0][0])
        mine = []
        for i, (tensors, posted) in enumerate(posts):
            if merge or self.source[self.rows[i]] == self.rank:
                if posted is not None:
                    posted.synchronize()
                mine.extend(tensors)
        out = {}
        got = multihost.allgather_tensors(mine,
                                          same_shapes=self.same_shapes)
        for p, theirs in enumerate(got):
            if p == self.rank:
                continue
            rows = [g for g in self.rows_of[p]
                    if merge or self.source[g] == p]
            for i, g in enumerate(rows):
                out[(p, g)] = tuple(theirs[i * m:(i + 1) * m])
        self.gather_s += time.perf_counter() - t0
        return out

    def _round(self, replica: int, tensors: tuple, merge: bool) -> tuple:
        """Post ``tensors`` to this replica's next round and wait until it
        is complete; returns ``(posts, remote, stream)``: the local
        replicas' ``(tensors, stream)``, the other processes' posts
        (:meth:`_gather_processes`; empty on one process) and this
        replica's current stream (None on the CPU)."""
        dev, stream = tensors[0].device, None
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
        with self._lock:
            k = self._rounds[replica]
            self._rounds[replica] += 1
            posts = self._posts.setdefault(k, [None] * self.n)
            posts[replica] = (tensors, stream)
            self._hand_on(replica)
            self._wait(replica, posts, k)
            remote = {}
            if self.processes > 1:
                if k not in self._remote:
                    try:
                        self._remote[k] = self._gather_processes(posts,
                                                                 merge)
                    except BaseException as e:
                        self._fail(e)
                remote = self._remote[k]
            self._reads[k] = self._reads.get(k, 0) + 1
            if self._reads[k] == self.n:
                del self._posts[k], self._reads[k]
                self._remote.pop(k, None)
        return posts, remote, stream

    def all_gather(self, replica: int, tensors: tuple) -> List[tuple]:
        """Post ``tensors`` (this replica's, made on its current stream)
        and return every replica's, in global replica order, on
        ``tensors``' device. The replicas take turns, so a reader whose
        stream on the poster's card is another stream makes it wait for
        all the poster has queued so far (a reader on the same stream
        needs nothing: the poster queued its work first); a copy to
        another card then follows that stream (``Tensor.to``). Over
        several processes the round's first reader also gathers the
        other processes' posts (:meth:`_gather_processes`), a row this
        process holds read from its own replica."""
        dev = tensors[0].device
        posts, remote, stream = self._round(replica, tensors, False)
        glob = list(range(len(self.source))) if self.processes > 1 \
            else self.rows
        out, foreign = [], 0
        for g in glob:
            if g not in self.rows:
                theirs = remote[(self.source[g], g)]
                foreign += sum(t.numel() * t.element_size() for t in theirs)
                out.append(tuple(t.to(dev) for t in theirs))
                continue
            r = self.rows.index(g)
            theirs, posted = posts[r]
            if r == replica:
                out.append(tensors)
                continue
            if posted is not None:
                src = theirs[0].device
                mine = stream if src == dev \
                    else torch.cuda.current_stream(src)
                if mine != posted:
                    mine.wait_stream(posted)
                    for t in theirs:
                        # read on this stream too: keep its memory until
                        # the reads are done
                        t.record_stream(mine)
            foreign += sum(t.numel() * t.element_size() for t in theirs)
            out.append(tuple(t.to(dev) for t in theirs))
        self.bytes += foreign
        return out

    def or_merge(self, replica: int, outs: tuple) -> None:
        """OR into ``outs`` (this replica's partials of a read of a view
        whose shards lie in several processes) the partials of the other
        processes that own cells of its data row, in process order."""
        from multiverso_tpu_torch.ops.table_kernels import _or_merge
        _, remote, _ = self._round(replica, tuple(outs), True)
        row = self.rows[replica]
        for (p, g), theirs in sorted(remote.items()):
            if g != row:
                continue
            self.bytes += sum(t.numel() * t.element_size() for t in theirs)
            _or_merge(outs, theirs)


class _Replica:
    """The replica a superstep thread runs: its exchange, its local
    index, its global data row and the table views its body got."""

    def __init__(self, exchange: _Exchange, index: int, views,
                 row: int) -> None:
        self.exchange, self.index, self.views = exchange, index, views
        self.row = row


_LOCAL = threading.local()


def _replica(param=None) -> Optional[_Replica]:
    """The running replica, when this thread runs one (and, given
    ``param``, when ``param`` is one of its table views)."""
    rep = getattr(_LOCAL, "replica", None)
    if rep is None or param is None:
        return rep
    return rep if any(param is v for v in rep.views) else None


def _gathered(rep: _Replica, tensors: tuple) -> List[torch.Tensor]:
    """Every replica's ``tensors`` concatenated in replica order."""
    posts = rep.exchange.all_gather(
        rep.index, tuple(t.contiguous() for t in tensors))
    return [torch.cat(parts) for parts in zip(*posts)]


def row_scatter_add(param, ids: torch.Tensor, deltas: torch.Tensor):
    """:func:`~multiverso_tpu_torch.ops.table_kernels.row_scatter_add`;
    on a replica's table view, over every replica's lanes (module doc)."""
    rep = _replica(param)
    if rep is not None:
        ids, deltas = _gathered(rep, (ids, deltas.reshape(ids.shape[0], -1)))
    return tk.row_scatter_add(param, ids, deltas)


def coo_scatter_add(param, rows: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor):
    """:func:`~multiverso_tpu_torch.ops.table_kernels.coo_scatter_add`;
    on a replica's table view, over every replica's lanes (module doc)."""
    rep = _replica(param)
    if rep is not None:
        rows, cols, vals = _gathered(rep, (rows, cols, vals))
    return tk.coo_scatter_add(param, rows, cols, vals)


def replica_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the replicas of a superstep over a data axis, in
    replica order (the same bits on every replica); ``x`` itself
    elsewhere."""
    rep = _replica()
    if rep is None:
        return x
    parts = rep.exchange.all_gather(rep.index, (x.contiguous(),))
    total = parts[0][0]
    for (part,) in parts[1:]:
        total = total + part
    return total


def replica_cat(x: torch.Tensor) -> torch.Tensor:
    """Every replica's ``x`` concatenated along dim 0 in replica order (the
    same bits on every replica); ``x`` itself elsewhere."""
    rep = _replica()
    if rep is None:
        return x
    return _gathered(rep, (x,))[0]


def replica_index() -> int:
    """The index ``d`` of the replica this superstep body runs, its data
    row of the global mesh; 0 off a data axis."""
    rep = _replica()
    return 0 if rep is None else rep.row


def local_replica_index() -> int:
    """The position of the running replica among this process's (its
    part of a ``DataSplit`` / ``Replicated``); 0 off a data axis."""
    rep = _replica()
    return 0 if rep is None else rep.index


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _part0(value):
    """What the one replica off a data axis gets of an input or local."""
    return value.parts[0] if isinstance(value, _PER_REPLICA) else value


def _input_for(value, replica: int, device: torch.device):
    """What replica ``replica`` gets of a superstep input."""
    if isinstance(value, _PER_REPLICA):
        return value.parts[replica]
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return value


class FusedSuperstep:
    """A fused update bound to one or more tables that share one mesh:
    one shard each on one device, or split the same way over the model
    axis, and on a data axis above 1 replicated over it (module doc)."""

    def __init__(self, tables: Sequence[Table],
                 body: Callable[..., Tuple[Any, Any, Any, Any]], *,
                 name: str = "superstep") -> None:
        if not tables:
            raise ValueError("FusedSuperstep needs at least one table")
        self.tables = tuple(tables)
        self.name = name
        self._body = body
        # profiled: profile.calls{fn=superstep.<name>} counts calls (the
        # reference's name). Nothing inside a call records telemetry: the
        # reference traces its body once, so it records nothing per step
        self._run = profiled(self._run_body, f"superstep.{name}")
        self._last_generation: Optional[int] = None
        #: bytes the replicas read from one another in the last call, and
        #: the seconds its cross-process gathers took (0 on one process)
        self.exchange_bytes = 0
        self.exchange_seconds = 0.0
        self.mesh = self.tables[0].mesh
        self.data = self.mesh.shape[DATA_AXIS]
        for t in self.tables:
            if not isinstance(t, Table):
                raise NotImplementedError(
                    f"superstep {name!r}: {type(t).__name__} {t.name!r} is "
                    "not a dense table; the reference's superstep takes "
                    "dense tables only (it reads a table's param and "
                    "shardings, which a KVTable has not)")
        devs0 = self.tables[0].replica_devices
        for t in self.tables[1:]:
            if t.replica_devices != devs0:
                raise ValueError(
                    f"superstep {name!r}: tables {self.tables[0].name!r} "
                    f"and {t.name!r} live on different devices "
                    f"({[[str(d) for d in r] for r in devs0]} and "
                    f"{[[str(d) for d in r] for r in t.replica_devices]})")

    def __call__(self, locals_: Any = (), *inputs: Any,
                 options: Optional[Sequence[Optional[AddOption]]] = None
                 ) -> Tuple[Any, Any]:
        """Run one fused update. Returns ``(new_locals, aux)``; table
        params/states are written back and each table's step/generation
        advances. The device work is queued, not awaited: use
        ``table.wait()`` or a returned value to fence."""
        if options is None:
            options = (None,) * len(self.tables)
        # client pipeline: buffered coalesced deltas must land BEFORE the
        # body reads each table's storage — applying them after would
        # reorder updates across the superstep
        for t in self.tables:
            t.flush_coalesced()
        opts = tuple(t._resolve_option(o)
                     for t, o in zip(self.tables, options))
        locals_ = tuple(locals_) if locals_ is not None else ()
        if self.data > 1:
            for x in locals_:
                if not isinstance(x, _PER_REPLICA):
                    raise ValueError(
                        f"superstep {self.name!r}: on a data axis of "
                        f"{self.data} an app-local carry is Replicated or "
                        f"a DataSplit, got {type(x).__name__}")
        outs = self._run(locals_, opts, inputs)
        for d, (new_params, new_states, _, _) in enumerate(outs):
            for t, p, s in zip(self.tables, new_params, new_states):
                t.superstep_update(p, s, replica=d)
        for t in self.tables:
            # a superstep's update never passes through add(), so the
            # numerics audit samples the written-back storage here: once a
            # call, on this thread, replica 0's (stride-gated inside
            # observe_param; a no-op when health is off)
            _health.observe_param(t)
            gen = t._bump_step()
            if t is self.tables[0]:
                self._last_generation = gen
        # each local handed back as it came: a Replicated or DataSplit of
        # every replica's returned part, anything else replica 0's
        new_locals = tuple(
            type(x)([out[2][i] for out in outs])
            if isinstance(x, _PER_REPLICA) else outs[0][2][i]
            for i, x in enumerate(locals_))
        return new_locals, outs[0][3]

    def _run_body(self, locals_, opts, inputs) -> list:
        """The body once (or once per replica on a data axis); returns
        each replica's ``(params, states, locals, aux)``."""
        if self.data > 1:
            return self._run_replicas(locals_, opts, inputs)
        views = [t.superstep_view() for t in self.tables]
        return [self._body(
            tuple(v[0] for v in views), tuple(v[1] for v in views),
            tuple(_part0(x) for x in locals_), opts,
            *(_part0(x) for x in inputs))]

    def _run_replicas(self, locals_, opts, inputs) -> list:
        """The body once per replica, each on a thread of its own;
        returns each replica's ``(params, states, locals, aux)``."""
        rows = self.mesh.local_rows
        exchange = _Exchange(len(rows), EXCHANGE_TIMEOUT, self.mesh)
        outs: list = [None] * len(rows)

        def run(d: int) -> None:
            dev = self.mesh.row_device(rows[d])
            try:
                views = [t.superstep_view(d) for t in self.tables]
                if self.mesh.rows_split:
                    # the view's reads merge among the row's processes
                    # (every replica's, so that every process takes part
                    # in the same rounds)
                    merge = lambda outs, d=d: exchange.or_merge(d, outs)
                    for v in views:
                        for x in (v[0], *v[1].values()):
                            if isinstance(x, ShardedParam):
                                x.merge = merge
                params = tuple(v[0] for v in views)
                _LOCAL.replica = _Replica(exchange, d, params, rows[d])
                exchange.start(d)
                with _on(dev):
                    outs[d] = self._body(
                        params, tuple(v[1] for v in views),
                        tuple(x.parts[d] for x in locals_), opts,
                        *(_input_for(x, d, dev) for x in inputs))
            except BaseException as e:      # re-raised by the caller
                exchange.abort(d, e)
            else:
                exchange.finish(d)
            finally:
                _LOCAL.replica = None

        threads = [threading.Thread(target=run, args=(d,), daemon=True,
                                    name=f"{self.name}-replica{rows[d]}")
                   for d in range(len(rows))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if exchange.error is not None:
            raise exchange.error
        self.exchange_bytes = exchange.bytes
        self.exchange_seconds = exchange.gather_s
        return outs

    def handle(self) -> Handle:
        """An add-handle for this superstep's latest run on the first
        table (all tables in one superstep advance together)."""
        if self._last_generation is None:
            raise RuntimeError(f"superstep {self.name!r} has not been "
                               "dispatched yet")
        return Handle(table=self.tables[0],
                      generation=self._last_generation)


def make_superstep(tables: Sequence[Table], body: Callable, *,
                   name: str = "superstep") -> FusedSuperstep:
    """Build a :class:`FusedSuperstep` over ``tables`` (see module doc)."""
    return FusedSuperstep(tables, body, name=name)
