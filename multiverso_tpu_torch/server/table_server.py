"""TableServer: one process owning the table fleet behind a wire.

The reference framework's server role (`src/server.cpp`: ZeroMQ/MPI
recv loop → ProcessGet/ProcessAdd on the owned table shards) mapped
onto this port: a :class:`TableServer` listens on one or more wire
addresses, worker *processes* connect through
:mod:`multiverso_tpu_torch.client.transport`, and every table op funnels
into ONE dispatch thread — the same single-dispatch-thread contract the
rest of the port keeps for the devices.

Counterpart of the serving core of
``multiverso_tpu/server/table_server.py``: the same threads, admission,
fusion, dedup, deadlines and replicas, answering the same frames. The
tables live on ``device`` (default ``cuda:0``; the tests pass ``"cpu"``)
or on a given ``mesh``, and the dispatch thread enters
``torch.cuda.device`` of the tables' first device, so a ``kv_add``
launches the KV probe + commit kernels and a ``kv_get`` the KV lookup
kernel on the card. Each op hands the table numpy and gets numpy back,
as the reference's does. The replication stream (``repl``, ``promote``,
``adopt``), live resharding (the ``migrate_*`` ops) and fleet files wait
for ROADMAP queue A item 11b: those ops get an ``{ok: false}`` reply
that says so, and the constructor refuses their arguments.

Thread topology per server::

    accept thread ──► per-conn reader ──┬─(staleness get: replica hit,
                      per-conn reader ──┤  answered right here)
                      per-conn reader ──┼─► ADMISSION ─► fair dispatch
                                        │   (classify,     queue ─► ONE
                                        │    bucket,        dispatch
                                        │    bound —        thread (table
                                        │    shed replies   ops, FUSED up
                                        │    answered       to MVTPU_
                                        │    right here)    SERVER_FUSE)
                      per-conn writer ◄─┴──── replies (per-conn queues)

Overload is a first-class state, not a failure (see
:mod:`multiverso_tpu_torch.server.admission`): reader threads run every data
frame through the admission controller — per-client token buckets and
a bounded queue shed excess load with a structured
``{ok:false, shed:true, retry_after_ms}`` reply the client transport
honors (sleep, resend identical bytes, dedup keeps it exactly-once) —
and the dispatch queue itself is weighted-fair across QoS classes
(``MVTPU_SERVER_QOS``), so one flooding client saturates its own lane
while well-behaved classes keep their share of the dispatch thread.
Client-stamped ``deadline`` headers are checked at dequeue: an expired
request is answered ``{ok:false, expired:true}`` instead of executed.
While mutations are being shed the server runs *degraded*:
bounded-staleness reads divert to the replica path even past their
bound (stale beats shed).

The hot path is batched like the reference's server loop processes its
message queue: each dispatch cycle drains up to ``MVTPU_SERVER_FUSE``
queued frames (default 1 = off), groups compatible ops by (table, op
kind, AddOption, sync), concatenates the payloads host-side with
cross-request duplicate pre-summing (the CoalescingBuffer grouping
rules; only for linear updaters — stateful-updater groups run per-frame
inside the cycle so fusion never changes their math), executes ONE
``apply``/``lookup`` per group, and fans per-request replies back — K
workers' small adds become one device dispatch. Reads that carry a
``staleness`` bound never enter the queue at all: they are served from
per-table snapshot replicas on the reader threads
(:mod:`multiverso_tpu_torch.server.replica`).

Fault containment is the design center, not an afterthought:

- A connection dying (worker SIGKILL, chaos ``drop``/``torn``) kills
  its reader/writer pair and nothing else — the dispatch thread and
  every other connection keep going. This holds on the shm transport
  too: the doorbell socket's EOF is the death signal.
- A handler error (bad table id, shape mismatch) becomes an
  ``{ok: false, error: ...}`` reply; the dispatch thread never dies on
  a request. A fault mid-fusion-cycle (chaos ``server.fuse``) falls
  back to per-frame execution, so only genuinely-failing requests fail.
- Mutating ops are **deduplicated** by ``(client id, request id)``: the
  client transport resends unacked adds after a reconnect
  (at-least-once delivery), and this table keeps replay from becoming
  double-apply (exactly-once effect) — the property the chaos-storm
  bit-identical test pins down. Both dedup layers are bounded LRUs
  (``MVTPU_WIRE_DEDUP`` replies per client, floor ``96`` so the window
  always exceeds the client's 64-deep pipeline;
  ``MVTPU_WIRE_DEDUP_CLIENTS`` client entries) so a long-lived server
  cannot grow without limit.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import os
import queue
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.control import knobs as _knobs
from multiverso_tpu_torch.ft import chaos as _chaos
from multiverso_tpu_torch.io import wiresock
from multiverso_tpu_torch.server import admission as _admission_mod
from multiverso_tpu_torch.server import wire
from multiverso_tpu_torch.server.replica import (TableReplica, host_array,
                                                 host_dtype, to_wire,
                                                 wire_dtype)
from multiverso_tpu_torch.tables import hashing as _hashing
from multiverso_tpu_torch.telemetry import attribution as _attribution
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry import trace as _trace
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import log

#: AddOption fields a client may set over the wire (``step`` stays
#: server-owned: each table's option advances it per applied add)
_OPTION_FIELDS = ("learning_rate", "momentum", "rho", "lam")

FUSE_ENV = "MVTPU_SERVER_FUSE"
DEDUP_ENV = "MVTPU_WIRE_DEDUP"
DEDUP_CLIENTS_ENV = "MVTPU_WIRE_DEDUP_CLIENTS"
EXEMPLARS_ENV = "MVTPU_SERVER_EXEMPLARS"

#: default size of the slow-request exemplar ring: the top-N slowest
#: fully-settled requests (queue + execute), kept per server so a p999
#: violation names the actual requests and stages behind it
_EXEMPLARS = 8

#: default replies cached per client for dedup replay
_DEDUP_CACHE = 256
#: hard floor for ``MVTPU_WIRE_DEDUP``: the replay window must exceed
#: the client transport's max pipelined-unacked window (64) with slack,
#: or a plain reconnect resend would fall outside it
_DEDUP_FLOOR = 96
#: default bound on distinct clients carrying a dedup cache
_DEDUP_CLIENTS = 1024

#: ops the dispatch thread may fuse across requests
_FUSABLE = ("add", "kv_add", "get", "kv_get")

#: updaters whose apply is linear in the delta: pre-summing K requests
#: into one apply is exact for them (the CoalescingBuffer dense rule).
#: Stateful updaters (adagrad/adam/momentum/ftrl) are nonlinear — their
#: groups execute per-frame inside the cycle instead, so fusion never
#: changes their math
_PRESUM_UPDATERS = ("default", "sgd")

#: frames-per-cycle histogram bounds (server.fuse.batch)
_FUSE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

#: synthetic frames one ``server.flood`` chaos firing injects ahead of
#: the real frame (each is a ``noop`` from client ``chaos-flood``, so a
#: QoS class can target and shed them like any real flooder)
_FLOOD_BURST = 32
_FLOOD_CLIENT = "chaos-flood"

#: the ops of the replication stream and of live resharding, which wait
#: for ROADMAP queue A item 11b: answered ``{ok: false}`` by name
_NOT_PORTED_OPS = ("repl", "promote", "adopt") + wire.MIGRATE_OPS
_NOT_PORTED = "not ported (ROADMAP A11b)"


# -- the reference's host arithmetic in the table's type --------------------
#
# The reference pre-sums fused deltas with numpy in the table's dtype
# (``astype(table.dtype)``, ``np.add.at``). float32 and float16 are
# numpy's own types here too; bfloat16 is not, so its sums run in
# float32 and round to bfloat16 after every add, as ml_dtypes' adds do.

def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _in_table_dtype(delta: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """``delta.astype(table.dtype)`` (bfloat16: float32 values rounded to
    it, which the table takes without another rounding)."""
    if dtype == torch.bfloat16:
        return _round_bf16(delta)
    return np.asarray(delta).astype(host_dtype(dtype), copy=False)


def _presum_dense(deltas: List[np.ndarray],
                  dtype: torch.dtype) -> np.ndarray:
    """The dense rule: ``delta.astype(table.dtype)`` summed one after
    another in the table's type."""
    total: Optional[np.ndarray] = None
    for delta in deltas:
        delta = _in_table_dtype(delta, dtype)
        if total is None:
            total = delta.copy()
        elif delta.shape != total.shape:
            raise ValueError(f"fused add shape mismatch {delta.shape} vs "
                             f"{total.shape}")
        elif dtype == torch.bfloat16:
            total = _round_bf16(total + delta)
        else:
            total += delta
    return total


def _presum(n: int, inverse: np.ndarray, deltas: np.ndarray,
            dtype: torch.dtype) -> np.ndarray:
    """``np.add.at(zeros(n), inverse, deltas)`` in the table's type:
    each row's adds in lane order."""
    summed = np.zeros((n,) + deltas.shape[1:], deltas.dtype)
    if dtype != torch.bfloat16:
        np.add.at(summed, inverse, deltas)
        return summed
    # add r of every row at once, each rounded: a row's adds stay in
    # lane order, rows are independent
    counts = np.bincount(inverse, minlength=n)
    rank = np.empty(len(inverse), np.int64)
    order = np.argsort(inverse, kind="stable")
    rank[order] = np.arange(len(inverse)) \
        - np.repeat(np.cumsum(counts) - counts, counts)
    for r in range(int(counts.max(initial=0))):
        sel = rank == r
        rows = inverse[sel]
        summed[rows] = _round_bf16(summed[rows] + deltas[sel])
    return summed


def _kv_lookup(table, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A KV Get on the host: (values in the table's host form, found)."""
    values, found = table.get_tensor(keys)
    return host_array(values), host_array(found)


class _FloodConn:
    """Stand-in connection for chaos-injected synthetic frames: never
    alive, so replies (and shed replies) to the phantom are skipped."""

    conn_id = 0
    client_id = _FLOOD_CLIENT
    alive = False

#: live servers in this process, for the /statusz transport section
_SERVERS: List["TableServer"] = []


def status_all() -> List[Dict[str, Any]]:
    """One status row per live server (statusz hook)."""
    return [s.status() for s in list(_SERVERS)]


class _Conn:
    """One client connection: its channel + writer queue + identity."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, sock: socket.socket, scheme: str,
                 listen_path: Optional[str]) -> None:
        self.sock = sock
        self.scheme = scheme
        self.listen_path = listen_path
        self.chan: Optional[Any] = None     # set by the conn thread's
        # accept_channel handshake, before the read/write loops run
        with _Conn._ids_lock:
            self.conn_id = next(_Conn._ids)
        self.client_id: str = f"conn{self.conn_id}"
        self.sendq: "queue.Queue" = queue.Queue()
        self.alive = True

    def close(self) -> None:
        self.alive = False
        chan = self.chan
        if chan is not None:
            try:
                chan.close()
            except OSError:
                pass
            return
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _Unit:
    """One executable unit of a fusion cycle: either a singleton
    (control op / unfusable) or a group of same-(table, op, option,
    sync) frames."""

    __slots__ = ("key", "items")

    def __init__(self, key: Optional[tuple], item: tuple) -> None:
        self.key = key
        self.items = [item]     # (batch_idx, conn, header, arrays)


class TableServer:
    """Serve the table fleet over one or more wire addresses.

    ``address`` may be a comma-separated list (e.g.
    ``"unix:/run/a.sock,tcp:127.0.0.1:0,shm:///run/b.sock"``) — one
    listener each, one shared dispatch thread. ``start()`` binds + spins
    the threads and returns the dialable address list (resolving
    ``tcp:host:0``'s ephemeral ports); ``stop()`` drains everything.
    ``fuse`` (default: ``MVTPU_SERVER_FUSE``, else 1 = off) caps how
    many queued frames one dispatch cycle may drain and fuse. Usable
    in-process (tests run a TableServer on a thread next to the pytest
    client) or as its own process via ``python -m multiverso_tpu_torch.server``.
    """

    def __init__(self, address: str, *, name: str = "tables",
                 fuse: Optional[int] = None,
                 qos: Optional[str] = None,
                 queue_bound: Optional[int] = None,
                 partition: Optional[Any] = None,
                 fleet_file: Optional[str] = None,
                 follower: bool = False,
                 replica_idx: Optional[int] = None,
                 replicate_to: Optional[List[str]] = None,
                 device: core.DeviceLike = "cuda:0",
                 mesh: Optional[core.Mesh] = None) -> None:
        for arg, value in (("fleet_file", fleet_file),
                           ("follower", follower or None),
                           ("replica_idx", replica_idx),
                           ("replicate_to", replicate_to or None)):
            if value is not None:
                raise NotImplementedError(
                    f"TableServer({arg}=...): replication and fleet "
                    f"files are {_NOT_PORTED}")
        self.name = name
        # the tables' home: a mesh when given, else the (1, 1) mesh of
        # ``device`` (no fallback: a missing card fails the first create)
        self._mesh = mesh
        self._device = core.resolve(device) if mesh is None \
            else mesh.replica_devices(0)[0]
        # fleet membership: a server/partition.PartitionMember makes
        # this process rank r of an N-server fleet — every create
        # instantiates only the local shard, and hello refuses clients
        # claiming a different map (see _execute). None = the whole
        # table lives here.
        self._partition = partition
        self._table_parts: Dict[int, Dict[str, Any]] = {}
        self._addresses = [a.strip() for a in str(address).split(",")
                           if a.strip()]
        if not self._addresses:
            raise ValueError("TableServer needs at least one address")
        self.address = ",".join(self._addresses)
        self._listeners: List[socket.socket] = []
        self._conns: Dict[int, _Conn] = {}
        self._conns_lock = threading.Lock()
        # the dispatch queue IS the admission controller: per-class
        # weighted-fair lanes + token buckets + the MVTPU_SERVER_QUEUE
        # bound, with the plain-Queue surface the dispatch loop drains
        self._admission = _admission_mod.AdmissionController(
            qos=qos, queue_bound=queue_bound, server=name)
        self._dispatchq = self._admission
        self._flood_conn = _FloodConn()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._tables: Dict[int, Any] = {}
        self._by_name: Dict[str, int] = {}
        self._replicas: Dict[int, TableReplica] = {}
        self._next_table = 0
        self._fuse = max(int(fuse) if fuse is not None
                         else _knobs.initial("server.fuse"), 1)
        self._dedup_depth = max(_knobs.initial("server.dedup",
                                               _DEDUP_CACHE),
                                _DEDUP_FLOOR)
        self._dedup_clients = max(
            _knobs.initial("server.dedup_clients", _DEDUP_CLIENTS), 1)
        # the dispatch loop re-reads self._fuse every drain cycle, so
        # a controller write takes effect on the next batch
        _knobs.bind("server.fuse", self, "_fuse", label=self.name)
        # LRU of LRUs: client_id -> OrderedDict(rid -> reply)
        self._dedup: "collections.OrderedDict[str, collections.OrderedDict]" \
            = collections.OrderedDict()
        self._g_conns = telemetry.gauge("wire.connections",
                                        server=self.name)
        self._g_depth = telemetry.gauge("server.queue.depth",
                                        server=self.name)
        self._h_batch = telemetry.histogram("server.fuse.batch",
                                            _FUSE_BUCKETS,
                                            server=self.name)
        self._h_age = telemetry.histogram("server.queue.age",
                                          telemetry.LATENCY_BUCKETS,
                                          server=self.name)
        self._c_fuse_groups = telemetry.counter("server.fuse.groups",
                                                server=self.name)
        self._c_fuse_frames = telemetry.counter("server.fuse.frames",
                                                server=self.name)
        # slow-request exemplars: a min-heap of (total_s, seq, row)
        # keeps the top-N slowest settled requests with their per-stage
        # breakdown (surfaced via status() -> /statusz)
        self._exemplar_cap = max(
            _knobs.initial("server.exemplars", _EXEMPLARS), 1)
        self._exemplars: List[tuple] = []
        self._exemplar_seq = 0
        self._exemplar_lock = threading.Lock()
        self._ops = 0
        # usage attribution: who (client, table, op) and where (range
        # heat) — None when killed via MVTPU_TOPK_K=0
        self._attr = _attribution.plane()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> str:
        bound = []
        for addr in self._addresses:
            parsed = wiresock.parse_address(addr)
            listener = wiresock.listen_socket(addr)
            self._listeners.append(listener)
            bound.append(wiresock.bound_address(listener, addr))
            path = parsed[1] if parsed[0] in ("unix", "shm") else None
            self._spawn(self._accept_loop,
                        f"wire-accept{len(bound)}", listener,
                        parsed[0], path)
        self.address = ",".join(bound)
        self._spawn(self._dispatch_loop, "wire-dispatch")
        _SERVERS.append(self)
        log.info("table server %r listening on %s (fuse=%d)",
                 self.name, self.address, self._fuse)
        return self.address

    def _spawn(self, fn, name: str, *args) -> threading.Thread:
        t = threading.Thread(target=fn, args=args,
                             name=f"{name}-{self.name}", daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        for listener in self._listeners:
            # shutdown-then-close (wire._close_socket rationale): a
            # plain close does NOT wake a thread blocked in accept()
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                listener.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns.values())
        for conn in conns:
            conn.sendq.put(None)
            conn.close()
        for rep in self._replicas.values():
            rep.stop()
        self._dispatchq.put(None)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        if self in _SERVERS:
            _SERVERS.remove(self)
        log.info("table server %r stopped (%d ops served)", self.name,
                 self._ops)

    def serve_forever(self) -> None:
        """Block until :meth:`stop` (signal handlers call it)."""
        self._stop.wait()

    def status(self) -> Dict[str, Any]:
        with self._conns_lock:
            n_conns = len(self._conns)
        part = None
        if self._partition is not None:
            part = self._partition.describe()
            part["tables"] = list(self._table_parts.values())
        # the reference's keys: "migration" and "replication" stay None
        # until ROADMAP A11b
        return {"name": self.name, "address": self.address,
                "connections": n_conns, "tables": len(self._tables),
                "migration": None,
                "ops": self._ops, "fuse": self._fuse,
                "fused": {"groups": int(self._c_fuse_groups.value),
                          "frames": int(self._c_fuse_frames.value)},
                "queued": self._dispatchq.qsize(),
                "partition": part,
                "replication": None,
                "admission": self._admission.status(),
                "replicas": [rep.status()
                             for rep in self._replicas.values()],
                "slow": self.slow_exemplars(),
                # top talkers + range heat ride the stats wire op, so
                # an operator probe sees attribution without an HTTP
                # port (the flood smoke's scorer path)
                "topk": (self._attr.topk_doc(n=8)
                         if self._attr is not None else None)}

    def slow_exemplars(self) -> List[Dict[str, Any]]:
        """The exemplar ring, slowest first: one row per settled
        request with its per-stage (queue/execute) breakdown."""
        with self._exemplar_lock:
            entries = sorted(self._exemplars, key=lambda e: -e[0])
        return [row for _total, _seq, row in entries]

    def _note_exemplar(self, total_s: float,
                       row: Dict[str, Any]) -> None:
        with self._exemplar_lock:
            self._exemplar_seq += 1
            entry = (total_s, self._exemplar_seq, row)
            if len(self._exemplars) < self._exemplar_cap:
                heapq.heappush(self._exemplars, entry)
            elif total_s > self._exemplars[0][0]:
                heapq.heapreplace(self._exemplars, entry)

    # -- accept / read / write threads -------------------------------------

    def _accept_loop(self, listener: socket.socket, scheme: str,
                     listen_path: Optional[str]) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = listener.accept()
            except OSError:
                if self._stop.is_set():
                    return
                continue
            try:
                _chaos.chaos_point("wire.accept")
            except _chaos.ChaosError as exc:
                # injected accept fault: the worker's dial dies at the
                # handshake and its RetryPolicy redials — the server
                # just sheds the connection
                log.warn("wire.accept chaos: %s", exc)
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            if sock.family == socket.AF_INET:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            conn = _Conn(sock, scheme, listen_path)
            with self._conns_lock:
                self._conns[conn.conn_id] = conn
                self._g_conns.set(len(self._conns))
            self._spawn(self._conn_main, f"wire-read{conn.conn_id}",
                        conn)

    def _conn_main(self, conn: _Conn) -> None:
        """Per-connection thread: channel handshake (shm listeners
        negotiate rings off the accept thread, so a stalled client
        cannot block other accepts), then the read loop."""
        try:
            conn.chan = wire.accept_channel(
                conn.sock, conn.scheme, listen_path=conn.listen_path,
                role="server")
        except (ConnectionError, wire.WireProtocolError, OSError,
                ValueError) as exc:
            if not self._stop.is_set():
                log.debug("conn %d handshake failed: %s", conn.conn_id,
                          exc)
            self._drop_conn(conn)
            return
        self._spawn(self._write_loop, f"wire-write{conn.conn_id}",
                    conn)
        self._read_loop(conn)

    def _drop_conn(self, conn: _Conn) -> None:
        with self._conns_lock:
            live = self._conns.pop(conn.conn_id, None)
            self._g_conns.set(len(self._conns))
        if live is not None:
            conn.sendq.put(None)
            conn.close()

    def _read_loop(self, conn: _Conn) -> None:
        """Reader: frames off this connection into the dispatch queue —
        except staleness-tolerant reads, answered HERE from the table's
        replica when fresh enough (never a tensor; see replica.py).
        ANY wire failure here is this connection's problem only."""
        while conn.alive and not self._stop.is_set():
            try:
                header, arrays, _ = conn.chan.recv()
            except (ConnectionError, wire.WireProtocolError, OSError,
                    ValueError) as exc:
                if conn.alive and not self._stop.is_set():
                    log.debug("conn %d reader closing: %s",
                              conn.conn_id, exc)
                break
            if header.get("staleness") is not None \
                    and header.get("op") in ("get", "kv_get"):
                t_rep = time.time()
                try:
                    # degraded-mode routing: while writes are being
                    # shed, serve from the replica even past the
                    # requested bound — a stale read beats a shed one
                    reply = self._serve_replica(
                        header, arrays,
                        relax=self._admission.degraded())
                except Exception:   # noqa: BLE001 — containment: a
                    reply = None    # replica bug degrades to dispatch
                ctx = wire.trace_ctx(header)
                if ctx is not None and _trace.active():
                    # reader-thread replica span, parented under the
                    # originating client request (hit -> answered
                    # here; miss -> the dispatch spans follow)
                    with _trace.adopt_remote(ctx):
                        _trace.emit_span(
                            "server.replica.get", t_rep,
                            time.time() - t_rep, server=self.name,
                            op=str(header.get("op")),
                            hit=reply is not None)
                if reply is not None:
                    rheader, rarrays = reply
                    rheader.setdefault("rid", header.get("rid"))
                    conn.sendq.put((rheader, rarrays))
                    continue
            self._intake(conn, header, arrays)
        self._drop_conn(conn)

    def _intake(self, conn: _Conn, header: Dict[str, Any],
                arrays: List[np.ndarray]) -> None:
        """Admission front-end for one frame (reader thread): chaos
        flood injection, then classify → bucket → bound. Admitted
        frames enter the fair queue; shed frames are answered right
        here with the structured retry-after reply — the dispatch
        thread never sees them."""
        try:
            _chaos.chaos_point("server.flood")
        except _chaos.ChaosError as exc:
            log.warn("server.flood chaos: %d synthetic frames ahead "
                     "of conn %d: %s", _FLOOD_BURST, conn.conn_id, exc)
            for _ in range(_FLOOD_BURST):
                fh = {"op": "noop", "flood": True}
                self._admission.offer(
                    _FLOOD_CLIENT, fh,
                    (self._flood_conn, fh, [], time.monotonic()))
        shed = self._admission.offer(
            conn.client_id, header,
            (conn, header, arrays, time.monotonic()))
        if shed is not None:
            if self._attr is not None:
                self._attr.shed(conn.client_id,
                                self._table_name(header),
                                str(header.get("op", "?")))
            shed["rid"] = header.get("rid")
            # shed replies name the shedder and echo the trace id, so
            # the client's retry-wait span says which server/class
            # shed it
            shed.setdefault("server", self.name)
            ctx = wire.trace_ctx(header)
            if ctx is not None and ctx.get("req") is not None:
                shed.setdefault("req", ctx["req"])
            if conn.alive:
                conn.sendq.put((shed, []))

    def _serve_replica(self, header: Dict[str, Any],
                       arrays: List[np.ndarray],
                       relax: bool = False) -> Optional[tuple]:
        rep = self._replicas.get(int(header.get("table", -1)))
        if rep is None:
            return None
        return rep.serve(header, arrays, relax=relax)

    def _write_loop(self, conn: _Conn) -> None:
        while True:
            item = conn.sendq.get()
            if item is None:
                return
            header, arrays = item
            try:
                conn.chan.send(header, arrays)
            except (ConnectionError, OSError) as exc:
                if conn.alive and not self._stop.is_set():
                    log.debug("conn %d writer closing: %s",
                              conn.conn_id, exc)
                self._drop_conn(conn)
                return

    # -- the single dispatch thread ----------------------------------------

    def _dispatch_loop(self) -> None:
        # every table op runs on this thread: pin the tables' card, so
        # the kernels launch on its current stream
        pin = torch.cuda.device(self._device) \
            if self._device.type == "cuda" else contextlib.nullcontext()
        with pin:
            self._dispatch_cycles()

    def _dispatch_cycles(self) -> None:
        h_dispatch = telemetry.histogram("wire.dispatch.seconds",
                                         telemetry.LATENCY_BUCKETS,
                                         server=self.name)
        while True:
            item = self._dispatchq.get()
            if item is None:
                return
            try:
                # latency here models a slow dispatch thread (the
                # overload the admission layer absorbs); error/drop
                # are contained — a chaos fault at dequeue must never
                # kill the one dispatch thread
                _chaos.chaos_point("server.dequeue")
            except _chaos.ChaosError as exc:
                log.warn("server.dequeue chaos contained: %s", exc)
            batch = [item]
            stop_after = False
            while len(batch) < self._fuse:
                try:
                    nxt = self._dispatchq.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop_after = True
                    break
                batch.append(nxt)
            self._g_depth.set(float(self._dispatchq.qsize()))
            self._h_batch.observe(float(len(batch)))
            now = time.monotonic()
            for _, _, _, enq_ts in batch:
                self._h_age.observe(max(now - enq_ts, 0.0))
            # client-stamped deadlines check at DEQUEUE: an expired
            # request is dead work — answer it, don't execute it
            batch = [it for it in batch if not self._drop_expired(it)]
            if len(batch) == 1:
                conn, header, arrays, enq_ts = batch[0]
                op = str(header.get("op", "?"))
                t0 = time.monotonic()
                reply = self._safe_execute(conn, op, header, arrays)
                self._finish(conn, op, header, reply, t0,
                             h_dispatch, enq_ts,
                             n_bytes=sum(int(a.nbytes)
                                         for a in arrays))
            elif batch:
                self._run_fused_batch(batch, h_dispatch)
            if stop_after:
                return

    def _drop_expired(self, item: tuple) -> bool:
        """Drop one already-expired frame at dequeue: reply a
        structured expired error (never applied, never cached — a
        resend with a fresh deadline would be a NEW request to the
        dedup layer only if the client re-rids it; the transport does
        not resend expired requests at all)."""
        conn, header, _arrays, _ts = item
        if not wire.deadline_expired(header):
            return False
        self._admission.note_expired()
        if conn.alive:
            reply = {"ok": False, "expired": True,
                     "rid": header.get("rid"),
                     "server": self.name,
                     "error": "deadline exceeded before "
                              "dispatch (op "
                              f"{header.get('op')!r})"}
            # expired replies echo the trace id like shed replies do:
            # the client can pin the loss to this server's queue
            ctx = wire.trace_ctx(header)
            if ctx is not None and ctx.get("req") is not None:
                reply["req"] = ctx["req"]
            conn.sendq.put((reply, []))
        return True

    def _safe_execute(self, conn: _Conn, op: str,
                      header: Dict[str, Any], arrays: List[np.ndarray],
                      force_sync: bool = False) -> Optional[tuple]:
        try:
            return self._execute(conn, op, header, arrays,
                                 force_sync=force_sync)
        except Exception as exc:      # noqa: BLE001 — reply, don't die
            telemetry.counter("wire.server.errors", op=op).inc()
            log.warn("wire op %s failed: %s: %s", op,
                     type(exc).__name__, exc)
            return ({"ok": False, "rid": header.get("rid"),
                     "error": f"{type(exc).__name__}: {exc}"}, [])

    def _finish(self, conn: _Conn, op: str, header: Dict[str, Any],
                reply: Optional[tuple], t0: float, h_dispatch,
                enq_ts: Optional[float] = None,
                n_bytes: int = 0) -> None:
        now = time.monotonic()
        h_dispatch.observe(now - t0)
        self._ops += 1
        telemetry.counter("wire.requests", op=op).inc()
        rid = header.get("rid")
        rheader = rarrays = None
        if reply is not None:
            rheader, rarrays = reply
        exec_s = max(now - t0, 0.0)
        wait_s = max(t0 - enq_ts, 0.0) if enq_ts is not None else 0.0
        ctx = wire.trace_ctx(header)
        if ctx is not None and _trace.active():
            # server-side spans for this settled request, parent-linked
            # under the originating client request: the queue wait
            # (measured at dequeue, so emitted retroactively) and the
            # dispatch/execute stage (fused cycles span the group).
            # Sink-gated: with nowhere to write, the record assembly
            # is pure tax on the dispatch thread.
            fused = (rheader or {}).get("fused")
            with _trace.adopt_remote(ctx):
                t_wall = time.time()
                if enq_ts is not None:
                    _trace.emit_span("server.queue.wait",
                                     t_wall - exec_s - wait_s, wait_s,
                                     server=self.name, op=op)
                attrs = {"server": self.name, "op": op}
                if fused:
                    attrs["fused"] = int(fused)
                _trace.emit_span(f"server.dispatch.{op}",
                                 t_wall - exec_s, exec_s, **attrs)
        if self._attr is not None \
                and op not in _admission_mod.CONTROL_OPS:
            if rarrays:
                n_bytes += sum(int(a.nbytes) for a in rarrays)
            self._attr.record(conn.client_id, self._table_name(header),
                              op, n_bytes=n_bytes,
                              queue_ms=wait_s * 1e3)
        if op not in _admission_mod.CONTROL_OPS:
            row = {"rid": rid, "op": op, "client": conn.client_id,
                   "class": self._admission.class_name(conn.client_id,
                                                       header),
                   "ts": time.time(),
                   "total_ms": round((wait_s + exec_s) * 1e3, 3),
                   "stages": {"queue_ms": round(wait_s * 1e3, 3),
                              "execute_ms": round(exec_s * 1e3, 3)}}
            if ctx is not None and ctx.get("req") is not None:
                row["req"] = ctx["req"]
            if (rheader or {}).get("fused"):
                row["fused"] = int(rheader["fused"])
            if rheader is not None and not rheader.get("ok", True):
                row["error"] = str(rheader.get("error", ""))[:120]
            self._note_exemplar(wait_s + exec_s, row)
        if reply is not None and conn.alive:
            rheader.setdefault("rid", rid)
            conn.sendq.put((rheader, rarrays))

    # -- request fusion ----------------------------------------------------

    def _run_fused_batch(self, batch: List[tuple],
                         h_dispatch) -> None:
        """One fusion cycle: plan units in arrival order, execute each
        (groups get ONE table op), then fan replies back in arrival
        order — per-connection reply order is what the client's
        in-order ack matching relies on."""
        t0 = time.monotonic()
        replies: Dict[int, Optional[tuple]] = {}
        for unit in self._plan_units(batch):
            if unit.key is None or len(unit.items) == 1:
                for idx, conn, header, arrays in unit.items:
                    op = str(header.get("op", "?"))
                    replies[idx] = self._safe_execute(conn, op, header,
                                                      arrays)
            else:
                replies.update(self._execute_group(unit))
        for idx, (conn, header, arrays, enq_ts) in enumerate(batch):
            self._finish(conn, str(header.get("op", "?")),
                         header, replies.get(idx), t0,
                         h_dispatch, enq_ts,
                         n_bytes=sum(int(a.nbytes) for a in arrays))

    def _plan_units(self, batch: List[tuple]) -> List[_Unit]:
        """Group the cycle's frames. A frame may only join a group that
        is still OPEN for its table — any interleaved different op /
        option / sync on the same table seals the group — so per-table
        op order is preserved exactly (frames only ever execute
        *earlier* than they would have, never later than a subsequent
        same-table op). Control ops are singleton units in sequence."""
        units: List[_Unit] = []
        open_by_table: Dict[int, _Unit] = {}
        for idx, (conn, header, arrays, _ts) in enumerate(batch):
            op = str(header.get("op", "?"))
            item = (idx, conn, header, arrays)
            tid = header.get("table")
            if op in _FUSABLE and tid is not None:
                try:
                    tid = int(tid)
                    key = self._group_key(op, tid, header)
                except (TypeError, ValueError):
                    units.append(_Unit(None, item))
                    continue
                unit = open_by_table.get(tid)
                if unit is not None and unit.key == key:
                    unit.items.append(item)
                    continue
                unit = _Unit(key, item)
                open_by_table[tid] = unit
                units.append(unit)
            else:
                units.append(_Unit(None, item))
        return units

    @staticmethod
    def _group_key(op: str, tid: int, header: Dict[str, Any]) -> tuple:
        opt = header.get("option") or {}
        return (op, tid, bool(header.get("sync")),
                tuple(sorted((str(k), float(v))
                             for k, v in opt.items())))

    def _execute_group(self, unit: _Unit) -> Dict[int, tuple]:
        """Execute one fused group. Dedup replays answer from the
        cache first (a resend inside a fusion cycle must not
        re-apply); a fault mid-group falls back to per-frame execution
        so only genuinely-failing requests fail."""
        op = unit.key[0]
        mutating = op in ("add", "kv_add")
        out: Dict[int, tuple] = {}
        fresh: List[tuple] = []
        for item in unit.items:
            idx, conn, header, _arrays = item
            if mutating:
                cached = self._dedup_get(conn.client_id,
                                         header.get("rid"))
                if cached is not None:
                    telemetry.counter("wire.dedup.replays",
                                      op=op).inc()
                    out[idx] = cached
                    continue
            fresh.append(item)
        if not fresh:
            return out
        if len(fresh) == 1:
            idx, conn, header, arrays = fresh[0]
            out[idx] = self._safe_execute(conn, op, header, arrays)
            return out
        if mutating:
            try:
                upd = self._table(fresh[0][2]).updater.name
            except Exception:   # noqa: BLE001 — bad table id etc.:
                upd = None      # per-frame path replies the error
            if upd not in _PRESUM_UPDATERS:
                # Nonlinear updater state: a merged delta is NOT K
                # sequential applies. Run the group per-frame — same
                # cycle, zero semantic drift.
                telemetry.counter("server.fuse.stateful_bypass",
                                  op=op).inc()
                for idx, conn, header, arrays in fresh:
                    out[idx] = self._safe_execute(conn, op, header,
                                                  arrays)
                return out
        try:
            _chaos.chaos_point("server.fuse")
            fused = self._apply_group(op, fresh)
            self._c_fuse_groups.inc()
            self._c_fuse_frames.inc(len(fresh))
        except Exception as exc:    # noqa: BLE001 — containment
            telemetry.counter("server.fuse.fallbacks", op=op).inc()
            log.warn("fused %s x%d fell back to per-frame: %s: %s",
                     op, len(fresh), type(exc).__name__, exc)
            # kv_add fallback forces sync so every request gets its OWN
            # commit/overflow verdict (a fused overflow names no
            # culprit)
            for idx, conn, header, arrays in fresh:
                out[idx] = self._safe_execute(
                    conn, op, header, arrays,
                    force_sync=(op == "kv_add"))
            return out
        for idx, conn, header, _arrays in fresh:
            reply = fused[idx]
            if mutating:
                self._dedup_put(conn.client_id, header.get("rid"),
                                reply)
            out[idx] = reply
        return out

    def _apply_group(self, op: str,
                     items: List[tuple]) -> Dict[int, tuple]:
        """The fused table op for one group: K compatible frames, ONE
        device dispatch."""
        header0 = items[0][2]
        table = self._table(header0)
        option = self._option(header0)
        sync = bool(header0.get("sync"))
        k = len(items)
        if op == "add":
            # CoalescingBuffer dense rule: pre-sum the deltas in table
            # dtype, apply once
            total = _presum_dense(
                [wire.decode_delta(header.get("quant"), arrays)
                 for _idx, _conn, header, arrays in items], table.dtype)
            self._heat_touch_dense(header0, table, weight=float(k))
            handle = table.add(total, option, sync=sync)
            reply = {"ok": True, "gen": handle.generation, "fused": k}
            return {idx: (dict(reply), []) for idx, *_ in items}
        if op == "kv_add":
            all_keys, all_deltas = [], []
            for _idx, _conn, header, arrays in items:
                keys = np.ascontiguousarray(arrays[0]) \
                    .astype(np.uint64, copy=False)
                delta = _in_table_dtype(
                    wire.decode_delta(header.get("quant"), arrays[1:]),
                    table.dtype)
                if len(delta) != len(keys):
                    raise ValueError(
                        f"kv_add keys/delta length mismatch "
                        f"{len(keys)} vs {len(delta)}")
                all_keys.append(keys)
                all_deltas.append(delta)
            cat_keys = np.concatenate(all_keys)
            cat_deltas = np.concatenate(all_deltas, axis=0)
            self._heat_touch_keys(header0, cat_keys)
            # CoalescingBuffer KV rule: cross-request duplicates
            # pre-sum so the stateful-updater unique-ids contract
            # holds for the ONE fused batch
            uniq, inverse = np.unique(cat_keys, return_inverse=True)
            summed = _presum(len(uniq), inverse.reshape(-1), cat_deltas,
                             table.dtype)
            handle = table.add(uniq, summed, option, sync=sync)
            # per-request overflow verdict: the fused batch drops
            # atomically on overflow, so ONE readback per cycle buys a
            # truthful reply for every request in it (the raise lands
            # in _execute_group's fallback, which re-runs per frame)
            table._check_overflow()
            reply = {"ok": True, "gen": handle.generation, "fused": k}
            return {idx: (dict(reply), []) for idx, *_ in items}
        if op == "get":
            for _idx, _conn, header, _arrays in items:
                self._maybe_arm_replica(header)
            self._heat_touch_dense(header0, table, weight=float(k))
            values = to_wire(host_array(table.get_tensor()), table.dtype)
            return {idx: ({"ok": True, "fused": k}, [values])
                    for idx, *_ in items}
        if op == "kv_get":
            lens = []
            all_keys = []
            for _idx, _conn, header, arrays in items:
                self._maybe_arm_replica(header)
                keys = np.ascontiguousarray(arrays[0]) \
                    .astype(np.uint64, copy=False)
                all_keys.append(keys)
                lens.append(len(keys))
            cat_keys = np.concatenate(all_keys)
            self._heat_touch_keys(header0, cat_keys)
            values, found = _kv_lookup(table, cat_keys)
            out: Dict[int, tuple] = {}
            off = 0
            for (idx, *_), n in zip(items, lens):
                out[idx] = ({"ok": True, "fused": k},
                            [to_wire(values[off:off + n], table.dtype),
                             np.ascontiguousarray(found[off:off + n])])
                off += n
            return out
        raise ValueError(f"unfusable op {op!r}")

    # -- request execution (single-frame path) ------------------------------

    def _execute(self, conn: _Conn, op: str, header: Dict[str, Any],
                 arrays: List[np.ndarray], force_sync: bool = False
                 ) -> Optional[Tuple[Dict[str, Any], list]]:
        if op == "hello":
            requested = str(header.get("client") or conn.client_id)
            claim = header.get("partition")
            if self._partition is not None and claim is not None:
                # fleet handshake: a client claiming a DIFFERENT map
                # would silently route rows to the wrong owner — refuse
                # before any data op flows. (A claimless client is
                # operator tooling — stats, smoke probes — and may
                # talk to the shard directly.)
                err = self._partition.map.mismatch(claim)
                if err is not None:
                    telemetry.counter("wire.hello.refused",
                                      server=self.name).inc()
                    log.warn("server %r refused hello from %r: %s",
                             self.name, requested, err)
                    return ({"ok": False, "error": err,
                             "partition":
                                 self._partition.map.to_wire()}, [])
            conn.client_id = requested
            self._dedup_cache(requested)
            reply = {"ok": True, "client_id": requested,
                     "server": self.name,
                     "quant": wire.quant_mode_from_env()}
            if self._partition is not None:
                reply["partition"] = self._partition.describe()
            return (reply, [])
        if op == "ping":
            # the clock-alignment probe: echo this process's wall
            # clock + identity; the client puts t_server at the RTT
            # midpoint to estimate the per-connection offset
            return ({"ok": True, "t_server": time.time(),
                     "host": telemetry.host_index(),
                     "pid": os.getpid()}, [])
        if op == "noop":
            # admission-controlled no-op: what the server.flood chaos
            # point injects (a control op would jump the fair queue)
            return ({"ok": True}, [])
        if op == "stats":
            return ({"ok": True, "status": self.status()}, [])
        if op == "shutdown":
            # reply first (queued), then stop — the writer drains the
            # queue before the socket closes under it
            conn.sendq.put(({"ok": True, "rid": header.get("rid")}, []))
            threading.Thread(target=self.stop, daemon=True).start()
            return None

        if op in _NOT_PORTED_OPS:
            return ({"ok": False, "server": self.name,
                     "error": f"wire op {op!r} is {_NOT_PORTED}"}, [])

        # mutating ops replay from the dedup cache: a resend after a
        # reconnect must not re-apply
        mutating = op in ("create", "add", "kv_add")
        if mutating:
            cached = self._dedup_get(conn.client_id, header.get("rid"))
            if cached is not None:
                telemetry.counter("wire.dedup.replays", op=op).inc()
                return cached

        if op == "create":
            reply = self._op_create(header)
        elif op == "get":
            reply = self._op_get(header)
        elif op == "kv_get":
            reply = self._op_kv_get(header, arrays)
        elif op == "add":
            reply = self._op_add(header, arrays, force_sync=force_sync)
        elif op == "kv_add":
            reply = self._op_kv_add(header, arrays,
                                    force_sync=force_sync)
        else:
            raise ValueError(f"unknown wire op {op!r}")
        if mutating:
            self._dedup_put(conn.client_id, header.get("rid"), reply)
        return reply

    # -- dedup cache (bounded LRU of bounded LRUs) --------------------------

    def _dedup_cache(self, client: str) -> "collections.OrderedDict":
        cache = self._dedup.get(client)
        if cache is None:
            cache = self._dedup[client] = collections.OrderedDict()
            while len(self._dedup) > self._dedup_clients:
                self._dedup.popitem(last=False)
        else:
            self._dedup.move_to_end(client)
        return cache

    def _dedup_get(self, client: str, rid) -> Optional[tuple]:
        if rid is None:
            return None
        entry = self._dedup_cache(client).get(int(rid))
        if entry is not None:
            header, arrays = entry
            return (dict(header), list(arrays))
        return None

    def _dedup_put(self, client: str, rid, reply: tuple) -> None:
        if rid is None:
            return
        cache = self._dedup_cache(client)
        cache[int(rid)] = reply
        while len(cache) > self._dedup_depth:
            cache.popitem(last=False)

    # -- table ops ---------------------------------------------------------

    def _table(self, header: Dict[str, Any]):
        tid = int(header.get("table", -1))
        table = self._tables.get(tid)
        if table is None:
            raise KeyError(f"no table {tid} on this server")
        return table

    def _table_name(self, header: Dict[str, Any]) -> str:
        try:
            tid = int(header.get("table", -1))
        except (TypeError, ValueError):
            return "?"
        t = self._tables.get(tid)
        name = getattr(t, "name", None) if t is not None else None
        return str(name) if name else (str(header.get("name"))
                                       if header.get("name") else "?")

    # -- range heat (attribution plane) -------------------------------------

    def _heat_touch_dense(self, header: Dict[str, Any], table,
                          weight: float = 1.0) -> None:
        """Attribute one dense whole-table op across the member's
        OWNED element range (the PartitionMap dense split): a
        whole-table add/get warms every owned element equally."""
        if self._attr is None:
            return
        tid = int(header.get("table", -1))
        part = self._table_parts.get(tid)
        if part is not None and "range" in part:
            lo, hi = part["range"]
        else:
            lo, hi = 0, int(getattr(table, "size", 1) or 1)
        name = self._table_name(header)
        self._attr.heat(name, "element", lo, hi) \
            .touch_span(lo, hi, weight)

    def _heat_touch_keys(self, header: Dict[str, Any],
                         keys: np.ndarray) -> None:
        """Attribute one KV op's keys into the member's owned
        splitmix64 bucket range — the SAME logical bucket space
        :class:`server.partition.PartitionMap` routes on, so fleet
        members' heat vectors concatenate into one aligned strip.
        Unpartitioned servers hash into their own heat-bucket space
        (lo=0, hi=heat_buckets) with the same splitmix64 finalizer."""
        if self._attr is None or len(keys) == 0:
            return
        name = self._table_name(header)
        if self._partition is not None:
            lo, hi = self._partition.bucket_range()
            pos = self._partition.map.kv_bucket(keys)
            heat = self._attr.heat(name, "bucket", lo, hi)
        else:
            nb = self._attr.heat_buckets
            pos = _hashing._hash_u64(keys) % np.uint64(nb)
            heat = self._attr.heat(name, "bucket", 0, nb)
        span = heat.hi - heat.lo
        rel = pos.astype(np.int64) - heat.lo
        rel = rel[(rel >= 0) & (rel < span)]
        if len(rel) == 0:
            return
        idx = np.minimum(rel * heat.buckets // span, heat.buckets - 1)
        counts = np.bincount(idx, minlength=heat.buckets)
        for b in np.nonzero(counts)[0]:
            heat.counts[int(b)] += float(counts[b])

    def _op_create(self, header: Dict[str, Any]) -> tuple:
        name = str(header["name"])
        kind = str(header.get("kind", "array"))
        spec = dict(header.get("spec") or {})
        if name in self._by_name:
            # idempotent by name: N workers all issue the same creates
            # at startup; first one builds, the rest attach
            tid = self._by_name[name]
            table = self._tables[tid]
        else:
            table = self._build_table(name, kind, spec)
            tid = self._next_table
            self._next_table += 1
            self._tables[tid] = table
            self._by_name[name] = tid
            if self._partition is not None:
                self._table_parts[tid] = self._part_info(name, kind,
                                                         spec)
            if kind in ("array", "kv"):
                # dormant until the first staleness-tolerant read;
                # tiered tables excluded (device arrays are one tier,
                # a snapshot of them would serve partial data)
                self._replicas[tid] = TableReplica(table, kind,
                                                   server=self.name)
            log.info("server %r created table %d %r kind=%s", self.name,
                     tid, name, kind)
        meta = {"ok": True, "table": tid, "name": name, "kind": kind,
                "dtype": wire_dtype(table.dtype)}
        value_dim = getattr(table, "value_dim", None)
        if value_dim is not None:
            meta["value_dim"] = int(value_dim)
        size = getattr(table, "size", None)
        if size is not None:
            meta["size"] = int(size)
        return (meta, [])

    def _build_table(self, name: str, kind: str, spec: Dict[str, Any]):
        """Instantiate a table from its GLOBAL create spec, on the
        server's device (or mesh). A fleet member builds only its local
        shard: the contiguous element range of a dense table, or
        ceil(capacity/n) KV slots (the router never sends this rank a
        key it doesn't own, so local bucket identity is free to differ
        from the fleet's logical bucket space)."""
        common: Dict[str, Any] = {"name": name}
        for key in ("dtype", "updater"):
            if key in spec:
                common[key] = spec[key]
        if self._mesh is not None:
            common["mesh"] = self._mesh
        else:
            common["device"] = self._device
        member = self._partition
        if kind == "array":
            from multiverso_tpu_torch.tables.array_table import ArrayTable
            size = int(spec["size"])
            if member is not None:
                size = member.local_dense_size(size)
            return ArrayTable(size,
                              init_value=spec.get("init_value", 0),
                              **common)
        if kind == "kv":
            from multiverso_tpu_torch.tables.kv_table import KVTable
            capacity = int(spec["capacity"])
            if member is not None:
                capacity = member.local_kv_capacity(capacity)
            return KVTable(capacity,
                           int(spec.get("value_dim", 0)), **common)
        if kind == "tiered_kv":
            from multiverso_tpu_torch.storage.tiered_kv import \
                TieredKVTable
            capacity = int(spec["capacity"])
            if member is not None:
                capacity = member.local_kv_capacity(capacity)
            return TieredKVTable(capacity,
                                 int(spec.get("value_dim", 0)),
                                 **common)
        raise ValueError(f"unknown table kind {kind!r} "
                         "(array | kv | tiered_kv)")

    def _part_info(self, name: str, kind: str,
                   spec: Dict[str, Any]) -> Dict[str, Any]:
        """Per-table ownership row for status() (what THIS rank holds
        of the global table)."""
        member = self._partition
        info: Dict[str, Any] = {"name": name, "kind": kind}
        if kind == "array":
            size = int(spec["size"])
            lo, hi = member.dense_range(size)
            info.update(size=size, range=[lo, hi], local=hi - lo)
        else:
            capacity = int(spec["capacity"])
            lo, hi = member.bucket_range()
            info.update(capacity=capacity, buckets=[lo, hi],
                        local=member.local_kv_capacity(capacity))
        return info

    @staticmethod
    def _option(header: Dict[str, Any]) -> Optional[AddOption]:
        raw = header.get("option")
        if not raw:
            return None
        fields = {k: float(raw[k]) for k in _OPTION_FIELDS if k in raw}
        return AddOption(**fields)

    def _maybe_arm_replica(self, header: Dict[str, Any]) -> None:
        """A staleness-tolerant read that reached the dispatch thread
        is a replica miss: arm the table's replica (first use) and
        kick a refresh so the NEXT one hits on the reader thread."""
        if header.get("staleness") is None:
            return
        rep = self._replicas.get(int(header.get("table", -1)))
        if rep is not None:
            rep.arm()
            rep.refresh()

    def _op_get(self, header: Dict[str, Any]) -> tuple:
        table = self._table(header)
        self._maybe_arm_replica(header)
        self._heat_touch_dense(header, table)
        values = host_array(table.get_tensor())
        return ({"ok": True}, [to_wire(values, table.dtype)])

    def _op_kv_get(self, header: Dict[str, Any],
                   arrays: List[np.ndarray]) -> tuple:
        table = self._table(header)
        self._maybe_arm_replica(header)
        keys = np.ascontiguousarray(arrays[0]).astype(np.uint64,
                                                      copy=False)
        self._heat_touch_keys(header, keys)
        values, found = _kv_lookup(table, keys)
        return ({"ok": True}, [to_wire(values, table.dtype),
                               np.ascontiguousarray(found)])

    def _op_add(self, header: Dict[str, Any],
                arrays: List[np.ndarray],
                force_sync: bool = False) -> tuple:
        table = self._table(header)
        self._heat_touch_dense(header, table)
        # dequant-before-apply: the table layer only ever sees floats
        delta = wire.decode_delta(header.get("quant"), arrays)
        handle = table.add(delta, self._option(header),
                           sync=bool(header.get("sync")) or force_sync)
        return ({"ok": True, "gen": handle.generation}, [])

    def _op_kv_add(self, header: Dict[str, Any],
                   arrays: List[np.ndarray],
                   force_sync: bool = False) -> tuple:
        table = self._table(header)
        keys = np.ascontiguousarray(arrays[0]).astype(np.uint64,
                                                      copy=False)
        self._heat_touch_keys(header, keys)
        delta = wire.decode_delta(header.get("quant"), arrays[1:])
        handle = table.add(keys, delta, self._option(header),
                           sync=bool(header.get("sync")) or force_sync)
        return ({"ok": True, "gen": handle.generation}, [])
