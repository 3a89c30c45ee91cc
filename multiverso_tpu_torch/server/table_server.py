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
as the reference's does. A fleet member also carries the reference's
replication stream (``repl``, ``promote``, ``adopt``; see
:mod:`multiverso_tpu_torch.server.replication`) and its live
resharding (the ``migrate_*`` ops): a follower applies each forwarded
frame through the same kernels, and a reshard moves KV rows in and out
of the port's tables bucket by bucket (device slots, host arena and
spill file of a tiered table alike).

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
from multiverso_tpu_torch.server import partition as _partition_mod
from multiverso_tpu_torch.server import replication as _replication
from multiverso_tpu_torch.server import wire
from multiverso_tpu_torch.server.replica import (TableReplica, host_array,
                                                 host_dtype, to_wire,
                                                 wire_dtype)
from multiverso_tpu_torch.tables import hashing as _hashing
from multiverso_tpu_torch.tables.kv_table import host_values
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

#: live-reshard chunking: elements per dense ``migrate_chunk`` (1 MiB
#: at fp32) and key rows per KV chunk — sized so the
#: ``server.migrate.rate`` knob's unit (chunks/s) maps to a
#: predictable wire rate
_MIG_DENSE_CHUNK = 1 << 18
_MIG_KV_CHUNK = 4096

#: sentinel for :meth:`TableServer._build_table`'s member override
_DEFAULT_MEMBER = object()

#: an empty KV lane: both uint32 key words all ones
_EMPTY_WORD = np.uint32(0xFFFFFFFF)


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


def _live_lanes(hk: np.ndarray) -> np.ndarray:
    """Which lanes of (..., S, 2) uint32 key planes hold a key."""
    return ~(hk == _EMPTY_WORD).all(-1)


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


def fleet_info() -> Optional[Tuple[str, int]]:
    """(fleet_file, rank) of the first live fleet-member server in this
    process — the ``/statusz?fleet=1`` aggregator's anchor. None when
    no server here belongs to a fleet."""
    for s in list(_SERVERS):
        if s._fleet_file and s._partition is not None:
            return s._fleet_file, s._partition.rank
    return None


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


class _Migration:
    """Live state of one v→v+1 reshard on this member (the elastic-
    fleet tentpole; frame contract in ``server/wire.py``).

    One re-entrant lock serializes the donor's streaming thread
    against the dispatch thread's apply+forward path. The exactly-once
    invariant it buys: every write either lands BEFORE its range's
    chunk is extracted (the chunk carries it) or is forwarded AFTER
    the chunk, on the same FIFO link — never both, never neither."""

    def __init__(self, plan: str, old_map, new_map,
                 members: Dict[int, str], rank: int,
                 ctx: Optional[Dict[str, Any]] = None) -> None:
        self.plan = str(plan)
        self.old = old_map          # None on a member born at v+1
        self.new = new_map
        self.members = dict(members)    # rank -> wire address (NEW fleet)
        self.rank = int(rank)
        self.ctx = ctx              # the begin frame's trace context
        self.lock = threading.RLock()
        # begin -> streaming|shipped -> committed, or failed/aborted
        self.state = "begin"
        self.error: Optional[str] = None
        self.donor = False
        self.staging: Dict[int, Any] = {}       # tid -> new-geometry shard
        self.dense_segs: Dict[int, list] = {}   # tid -> [(rcpt, lo, hi)]
        self.kv_segs: Dict[int, list] = {}      # tid -> [(rcpt, blo, bhi)]
        self.shipped: Dict[int, list] = {}      # tid -> [(lo, hi)] handed off
        self.links: Dict[int, Any] = {}         # recipient rank -> WireClient
        self.seq = 0
        self.chunks = 0
        self.chunks_in = 0
        self.forwards = 0
        self.forwards_in = 0
        self.moved_bytes = 0
        self.t0 = time.time()

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def mark_shipped(self, tid: int, lo: int, hi: int) -> None:
        self.shipped.setdefault(tid, []).append((int(lo), int(hi)))

    def shipped_overlaps(self, tid: int, lo: int,
                         hi: int) -> List[Tuple[int, int]]:
        out = []
        for a, b in self.shipped.get(tid, ()):
            x, y = max(a, lo), min(b, hi)
            if x < y:
                out.append((x, y))
        return out

    def status(self) -> Dict[str, Any]:
        return {"plan": self.plan, "state": self.state,
                "from": self.old.version if self.old is not None
                else None,
                "to": self.new.version, "donor": self.donor,
                "chunks": self.chunks, "chunks_in": self.chunks_in,
                "forwards": self.forwards,
                "forwards_in": self.forwards_in,
                "moved_bytes": self.moved_bytes,
                "elapsed_s": round(time.time() - self.t0, 3),
                "error": self.error}


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
        self.name = name
        # the tables' home: a mesh when given, else the (1, 1) mesh of
        # ``device`` (no fallback: a missing card fails the first create)
        if mesh is not None:
            core.refuse_model_split(mesh, "the table server")
        self._mesh = mesh
        self._device = core.resolve(device) if mesh is None \
            else mesh.replica_devices(0)[0]
        # fleet membership: a server/partition.PartitionMember makes
        # this process rank r of an N-server fleet — every create
        # instantiates only the local shard, and hello refuses clients
        # claiming a different map (see _execute). None = the whole
        # table lives here.
        self._partition = partition
        self._fleet_file = fleet_file
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
        # -- cross-process shard replication (server/replication.py) --
        # follower=True makes this process a read-only replica of its
        # rank's primary: mutations arrive only as op="repl" stream
        # frames, client reads are staleness-gated against the stream,
        # and "promote" flips it to primary on failover. A PRIMARY in
        # a fleet with replicas>1 (or with an explicit replicate_to
        # override) owns a ReplicationTap that forwards every applied
        # mutation and drains follower acks before client acks.
        self._follower = bool(follower)
        self._replica_idx = replica_idx
        self._repl_slack = _knobs.initial("server.repl.slack")
        _knobs.bind("server.repl.slack", self, "_repl_slack",
                    label=self.name)
        # -- live resharding (elastic fleet) ---------------------------
        # one in-flight _Migration at most; _table_specs remembers each
        # create's (name, kind, spec) so migrate_begin can build the
        # new-geometry staging shard and manifest-create on recipients
        self._migration: Optional[_Migration] = None
        self._table_specs: Dict[int, Tuple[str, str, Dict[str, Any]]] = {}
        self._migrate_rate = _knobs.initial("server.migrate.rate")
        _knobs.bind("server.migrate.rate", self, "_migrate_rate",
                    label=self.name)
        self._c_mig_bytes = telemetry.counter("reshard.moved_bytes",
                                              server=self.name)
        self._c_mig_chunks = telemetry.counter("reshard.chunks",
                                               server=self.name)
        self._c_mig_fwds = telemetry.counter("reshard.forwards",
                                             server=self.name)
        self._c_mig_aborts = telemetry.counter("reshard.aborts",
                                               server=self.name)
        self._fstate = _replication.FollowerState(self.name) \
            if self._follower else None
        self._tap: Optional[_replication.ReplicationTap] = None
        if not self._follower and (replicate_to or
                                   (fleet_file is not None
                                    and partition is not None)):
            self._tap = _replication.ReplicationTap(
                self.name, member=partition, fleet_file=fleet_file,
                replicate_to=replicate_to)

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
        if self._tap is not None:
            self._tap.close()
        mig = self._migration
        if mig is not None:
            for link in list(mig.links.values()):
                with contextlib.suppress(Exception):
                    link.abort()
                with contextlib.suppress(Exception):
                    link.close()
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
        repl = None
        if self._tap is not None:
            repl = self._tap.status()
        elif self._fstate is not None:
            repl = self._fstate.status()
        if repl is not None:
            repl["follower"] = self._follower
            repl["slack"] = int(self._repl_slack)
            if not self._follower:
                # a promoted ex-follower reports its NEW role (its
                # FollowerState survives as the apply history)
                repl["role"] = "primary"
        mig = self._migration
        return {"name": self.name, "address": self.address,
                "connections": n_conns, "tables": len(self._tables),
                "migration": mig.status() if mig is not None else None,
                "ops": self._ops, "fuse": self._fuse,
                "fused": {"groups": int(self._c_fuse_groups.value),
                          "frames": int(self._c_fuse_frames.value)},
                "queued": self._dispatchq.qsize(),
                "partition": part,
                "replication": repl,
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
            if self._fstate is not None \
                    and header.get("op") == "repl":
                # follower staleness reference advances at INTAKE: repl
                # frames ride the strict-FIFO control lane, so by the
                # time a read dispatches, every frame noted ahead of it
                # is already applied
                self._fstate.note(header)
            # a follower answers on the reader thread too: its
            # replicas carry the FollowerState stream, so the
            # snapshot's staleness is measured against the newest
            # primary generation the stream has announced at intake
            # (never the local one). Unbounded reads (staleness None)
            # still go to dispatch, where a follower refuses them
            # structurally.
            if header.get("staleness") is not None \
                    and header.get("op") in ("get", "kv_get") \
                    and self._relay_mode(header) is None:
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
                # zero-loss invariant: follower acks drain BEFORE the
                # client's ack is queued, so an acked write is on
                # every live follower (no-op without a tap)
                if self._tap is not None:
                    self._tap.barrier()
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
        # sync-before-ack (see _dispatch_cycles): one barrier per fusion
        # cycle covers every forwarded frame in it
        if self._tap is not None:
            self._tap.barrier()
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
            # follower reads stay singleton units: each carries its
            # own staleness bound, checked (and annotated) per frame
            if op in _FUSABLE and tid is not None \
                    and not (self._follower
                             and op in ("get", "kv_get")) \
                    and self._relay_mode(header) is None:
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
            origins = [(c.client_id, h.get("rid"))
                       for _i, c, h, _a in items]
            mig = self._mig_forwarding()
            if mig is not None:
                # donor mid-reshard: apply + forward under the
                # migration lock so the fused delta can never fall
                # between a shipped chunk and its forward
                with mig.lock:
                    handle = table.add(total, option, sync=sync)
                    self._mig_forward_dense(
                        mig, int(header0["table"]), total,
                        header0.get("option"), origins)
            else:
                handle = table.add(total, option, sync=sync)
            if self._tap is not None:
                # a fused group forwards as its ONE pre-summed apply:
                # K original frames would desync generation counts and
                # float rounding on the follower
                self._tap.forward_fused(
                    "add", int(header0["table"]), [total],
                    origins=origins, pgen=handle.generation,
                    option=header0.get("option"))
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
            origins = [(c.client_id, h.get("rid"))
                       for _i, c, h, _a in items]
            mig = self._mig_forwarding()
            if mig is not None:
                with mig.lock:
                    handle = table.add(uniq, summed, option, sync=sync)
                    table._check_overflow()
                    self._mig_forward_kv(
                        mig, int(header0["table"]), uniq, summed,
                        header0.get("option"), origins)
            else:
                handle = table.add(uniq, summed, option, sync=sync)
                # per-request overflow verdict: the fused batch drops
                # atomically on overflow, so ONE readback per cycle
                # buys a truthful reply for every request in it (the
                # raise lands in _execute_group's fallback, which
                # re-runs per frame)
                table._check_overflow()
            if self._tap is not None:
                # forwarded AFTER the overflow check: a batch the
                # primary dropped must never reach a follower
                self._tap.forward_fused(
                    "kv_add", int(header0["table"]), [uniq, summed],
                    origins=origins, pgen=handle.generation,
                    option=header0.get("option"))
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

        if op == "promote":
            return self._op_promote(header)
        if op == "adopt":
            return self._op_adopt(header)
        # a follower is read-only to clients: its state is the primary's
        # delta stream, verbatim — a direct client mutation would fork it
        if self._follower and op in ("create", "add", "kv_add"):
            return ({"ok": False, "follower": True,
                     "server": self.name,
                     "error": "follower replica is read-only: "
                              "mutations go to the primary"}, [])
        follower_lag: Optional[int] = None
        if self._follower and op in ("get", "kv_get"):
            refused, follower_lag = self._follower_read_check(header)
            if refused is not None:
                return refused

        # mutating ops replay from the dedup cache: a resend after a
        # reconnect must not re-apply ("repl" included: the tap's link
        # replays its unacked window after a reconnect like any
        # client; migrate chunk/fwd/manifest for the same reason — a
        # donor's link redial replays its unacked window)
        mutating = op in ("create", "add", "kv_add", "repl",
                          wire.MIGRATE_CHUNK, wire.MIGRATE_FWD,
                          wire.MIGRATE_MANIFEST)
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
            reply = self._op_add(header, arrays, force_sync=force_sync,
                                 origin=conn.client_id)
        elif op == "kv_add":
            reply = self._op_kv_add(header, arrays,
                                    force_sync=force_sync,
                                    origin=conn.client_id)
        elif op == "repl":
            reply = self._op_repl(header, arrays)
        elif op in wire.MIGRATE_OPS:
            reply = self._op_migrate(op, header, arrays)
        else:
            raise ValueError(f"unknown wire op {op!r}")
        if follower_lag is not None and reply[0].get("ok"):
            # a follower-served read names its real lag so clients
            # (and tests) can hold the staleness bound to account
            reply[0]["follower"] = True
            reply[0]["lag"] = follower_lag
        if self._tap is not None and reply[0].get("ok") \
                and (op in ("create", "add", "kv_add")
                     or (op in wire.MIGRATE_OPS
                         and op != wire.MIGRATE_STATE)):
            # migrate frames replicate too (state polls excepted): a
            # follower builds/fills the same staging shard and swaps
            # it in lockstep at commit, so failover composes with a
            # mid-flight reshard
            self._tap.forward(conn.client_id, header, arrays, reply[0])
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

    # -- replication ops (see server/replication.py) -------------------------

    def _follower_read_check(self, header: Dict[str, Any]
                             ) -> Tuple[Optional[tuple], int]:
        """Staleness gate for a client read on a FOLLOWER: serve iff
        this table lags the stream's newest primary generation by at
        most ``staleness + server.repl.slack``. Returns
        ``(refusal_reply | None, lag)``."""
        try:
            tid = int(header.get("table", -1))
        except (TypeError, ValueError):
            tid = -1
        table = self._tables.get(tid)
        local_gen = int(getattr(table, "generation", 0) or 0) \
            if table is not None else 0
        lag = self._fstate.lag(tid, local_gen) \
            if self._fstate is not None else 0
        staleness = header.get("staleness")
        if staleness is None:
            # an unbounded (read-your-writes) read cannot be answered
            # honestly here: structured refusal, router uses the primary
            return ({"ok": False, "stale": True, "follower": True,
                     "server": self.name,
                     "error": "follower serves bounded-staleness "
                              "reads only"}, []), lag
        bound = max(int(staleness), 0) + max(int(self._repl_slack), 0)
        if lag > bound:
            telemetry.counter("replication.stale_refusals",
                              server=self.name).inc()
            return ({"ok": False, "stale": True, "follower": True,
                     "lag": lag, "server": self.name,
                     "error": f"follower lags {lag} generations, "
                              f"past the bound {bound}"}, []), lag
        return None, lag

    def _op_repl(self, header: Dict[str, Any],
                 arrays: List[np.ndarray]) -> tuple:
        """Apply one replicated mutation: the original frame's bytes,
        decoded and applied exactly as the primary did (bit parity),
        then recorded under every ORIGINATING (client, rid) — the
        promotion replay window that keeps a post-failover client
        resend exactly-once."""
        if not self._follower:
            raise ValueError("repl frame at a non-follower server")
        orig, origins, pgen, tid = wire.repl_unwrap(header)
        op = str(orig.get("op", "?"))
        t0 = time.time()
        if op == "create":
            reply = self._op_create(orig, force_tid=tid)
        elif op == "add":
            reply = self._op_add(orig, arrays)
        elif op == "kv_add":
            reply = self._op_kv_add(orig, arrays)
        elif op in wire.MIGRATE_OPS:
            # a mid-reshard primary streams its migrate frames too: the
            # follower mirrors begin/chunks/forwards into its own
            # staging and swaps at commit in lockstep (it never donates
            # or forwards itself — _mig_forwarding gates on donor)
            reply = self._op_migrate(op, orig, arrays)
        else:
            raise ValueError(f"unknown replicated op {op!r}")
        # FRESH dicts per replay key: _finish bakes the STREAMER's rid
        # into the reply object it returns, and a shared dict would
        # leak that rid into the origin-keyed replay entries
        for oc, orid in origins:
            if orid is not None:
                self._dedup_put(oc, orid,
                                (dict(reply[0]), list(reply[1])))
        t = tid
        if t is None:
            try:
                t = int(orig.get("table"))
            except (TypeError, ValueError):
                t = None
        if self._fstate is not None and t is not None:
            self._fstate.applied(t, int(reply[0].get("gen") or 0))
        ctx = wire.trace_ctx(orig)
        if ctx is not None and _trace.active():
            # the apply span chains under the ORIGINATING client
            # request, so a traced write shows its replication hop
            with _trace.adopt_remote(ctx):
                _trace.emit_span("server.repl.apply", t0,
                                 time.time() - t0, server=self.name,
                                 op=op, origins=len(origins))
        return reply

    def _op_promote(self, header: Dict[str, Any]) -> tuple:
        """Flip this FOLLOWER to primary for its rank (failover). Bumps
        the partition map version — the hello-refusal machinery then
        refuses every router still claiming the old map, whose refresh
        (via the refusal's map + the rewritten fleet file) lands on
        this server. Idempotent: a second promote reports the map."""
        if not self._follower:
            wire_map = self._partition.map.to_wire() \
                if self._partition is not None else None
            return ({"ok": True, "already": True,
                     "partition": wire_map, "server": self.name}, [])
        self._follower = False
        # the snapshot replicas' staleness reference reverts to the
        # LOCAL generation: the repl stream is over, and a frozen
        # stream high-water mark would clamp their lag to zero while
        # direct writes advance the table underneath them
        for rep in self._replicas.values():
            rep.stream = None
        wire_map = None
        if self._partition is not None:
            old = self._partition.map
            new_map = _partition_mod.PartitionMap(
                old.n, version=old.version + 1,
                kv_buckets=old.kv_buckets, replicas=old.replicas)
            self._partition = _partition_mod.PartitionMember(
                new_map, self._partition.rank)
            wire_map = new_map.to_wire()
            if self._fleet_file:
                try:
                    doc = _partition_mod.read_fleet_file(
                        self._fleet_file)
                    if doc is not None:
                        new_doc = _partition_mod.promote_in_doc(
                            doc, self._partition.rank,
                            self._replica_idx or 0)
                        _partition_mod.write_fleet_file(
                            self._fleet_file, new_map,
                            new_doc["members"])
                except Exception as exc:    # noqa: BLE001 — promotion
                    log.warn("server %r: fleet-file rewrite failed "
                             "on promote: %s", self.name, exc)
            # R>2: the new primary keeps streaming to the remaining
            # followers of this rank (the rewritten fleet file no
            # longer lists us; with none left the tap stays dormant)
            if self._tap is None and self._fleet_file:
                self._tap = _replication.ReplicationTap(
                    self.name, member=self._partition,
                    fleet_file=self._fleet_file)
        telemetry.counter("replication.promotions",
                          server=self.name).inc()
        log.info("server %r PROMOTED to primary (map v%s)", self.name,
                 self._partition.map.version
                 if self._partition is not None else "-")
        return ({"ok": True, "promoted": True, "server": self.name,
                 "partition": wire_map}, [])

    def _op_adopt(self, header: Dict[str, Any]) -> tuple:
        """Adopt a newer partition map in place (broadcast to the
        surviving members after a promotion): monotonic and idempotent;
        live connections are untouched — the version only gates future
        hellos."""
        wire_map = header.get("map")
        if self._partition is None or not isinstance(wire_map, dict):
            return ({"ok": True, "ignored": True}, [])
        new = _partition_mod.PartitionMap.from_wire(wire_map)
        cur = self._partition.map
        if new.version > cur.version:
            self._partition = _partition_mod.PartitionMember(
                new, self._partition.rank)
            if self._tap is not None:
                self._tap.update_claim(new.to_wire())
            telemetry.counter("wire.map.adopted",
                              server=self.name).inc()
            log.info("server %r adopted partition map v%d", self.name,
                     new.version)
        return ({"ok": True,
                 "version": self._partition.map.version}, [])

    # -- live resharding (elastic fleet; frame contract in wire.py) --------

    def _op_migrate(self, op: str, header: Dict[str, Any],
                    arrays: List[np.ndarray]) -> tuple:
        if op == wire.MIGRATE_BEGIN:
            return self._op_migrate_begin(header)
        if op == wire.MIGRATE_STATE:
            return self._op_migrate_state(header)
        if op == wire.MIGRATE_COMMIT:
            return self._op_migrate_commit(header)
        if op == wire.MIGRATE_ABORT:
            return self._op_migrate_abort(header)
        if op == wire.MIGRATE_MANIFEST:
            return self._op_migrate_manifest(header)
        if op == wire.MIGRATE_CHUNK:
            return self._op_migrate_chunk(header, arrays)
        if op == wire.MIGRATE_FWD:
            return self._op_migrate_fwd(header, arrays)
        if op == wire.MIGRATE_FIN:
            return self._op_migrate_fin(header)
        raise ValueError(f"unknown migrate op {op!r}")

    def _op_migrate_begin(self, header: Dict[str, Any]) -> tuple:
        plan = str(header.get("plan", ""))
        mig = self._migration
        if mig is not None and mig.plan != plan \
                and mig.state not in ("committed", "aborted"):
            return ({"ok": False, "server": self.name,
                     "error": f"reshard {mig.plan!r} already in "
                              "flight"}, [])
        if self._partition is None:
            return ({"ok": False, "server": self.name,
                     "error": "reshard needs a fleet member "
                              "(no partition)"}, [])
        new_map = _partition_mod.PartitionMap.from_wire(header["map"])
        cur = self._partition.map
        if mig is not None and mig.plan == plan:
            if mig.old is None or mig.state != "receiving":
                # a redelivered begin (admin retry) is a no-op
                return ({"ok": True, "already": True,
                         "state": mig.state}, [])
            # else: the donor's manifest beat the admin's begin here
            # (streams start as soon as each donor hears begin) —
            # upgrade the receive-only stub in place, keeping its
            # staging and whatever chunks already landed
        elif new_map.version != cur.version + 1:
            return ({"ok": False, "server": self.name,
                     "error": f"reshard targets v{new_map.version}, "
                              f"this member serves v{cur.version}"},
                    [])
        else:
            mig = _Migration(plan, cur, new_map, {},
                             self._partition.rank,
                             ctx=wire.trace_ctx(header))
        mig.members = {int(r): str(a) for r, a
                       in (header.get("members") or {}).items()}
        diff = _partition_mod.map_diff(cur, new_map)
        rank = mig.rank
        mig.donor = rank in diff.donor_ranks() and not self._follower
        if mig.donor:
            for tid, (_name, kind, spec) in sorted(
                    self._table_specs.items()):
                if kind == "array":
                    segs = [(r, lo, hi) for d, r, lo, hi
                            in diff.dense_moves(int(spec["size"]))
                            if d == rank]
                    if segs:
                        mig.dense_segs[tid] = segs
                else:
                    segs = [(r, lo, hi) for d, r, lo, hi
                            in diff.bucket_moves if d == rank]
                    if segs:
                        mig.kv_segs[tid] = segs
        if rank < new_map.n:
            new_member = _partition_mod.PartitionMember(new_map, rank)
            for tid in sorted(self._table_specs):
                if tid not in mig.staging:
                    mig.staging[tid] = self._mig_build_staging(
                        tid, new_member)
        self._migration = mig
        mig.state = "streaming" if mig.donor else "shipped"
        if mig.donor:
            self._spawn(self._mig_stream, "mig-stream", mig)
        log.info("server %r: reshard %r begin v%d→v%d donor=%s "
                 "(%d dense segs, %d kv segs)", self.name, plan,
                 cur.version, new_map.version, mig.donor,
                 sum(len(v) for v in mig.dense_segs.values()),
                 sum(len(v) for v in mig.kv_segs.values()))
        return ({"ok": True, "plan": plan, "donor": mig.donor,
                 "state": mig.state}, [])

    def _op_migrate_manifest(self, header: Dict[str, Any]) -> tuple:
        plan = str(header.get("plan", ""))
        new_map = _partition_mod.PartitionMap.from_wire(header["map"])
        mig = self._migration
        if mig is None or mig.state in ("committed", "aborted"):
            if self._partition is None:
                return ({"ok": False, "server": self.name,
                         "error": "manifest at a partitionless "
                                  "server"}, [])
            cur = self._partition.map
            if cur.version == new_map.version:
                # a member BORN at v+1: its live tables already have
                # the new geometry; chunks/forwards apply directly
                old = None
            elif cur.version + 1 == new_map.version:
                # existing member, donor's stream raced ahead of the
                # admin's begin: stage now, merge when begin arrives
                old = cur
            else:
                return ({"ok": False, "server": self.name,
                         "error": f"manifest targets v"
                                  f"{new_map.version}, this member "
                                  f"serves v{cur.version}"}, [])
            mig = _Migration(plan, old, new_map, {},
                             self._partition.rank,
                             ctx=wire.trace_ctx(header))
            mig.state = "receiving"
            self._migration = mig
        elif mig.plan != plan:
            return ({"ok": False, "server": self.name,
                     "error": f"manifest for plan {plan!r} but "
                              f"{mig.plan!r} is in flight"}, [])
        new_member = _partition_mod.PartitionMember(mig.new, mig.rank)
        for row in header.get("tables") or ():
            tid = int(row["table"])
            if mig.old is None:
                # new member: create the live table itself (idempotent
                # by name, force_tid keeps the id space aligned)
                self._op_create({"name": row["name"],
                                 "kind": row["kind"],
                                 "spec": row["spec"]},
                                force_tid=tid, staging_ok=True)
            else:
                self._table_specs.setdefault(
                    tid, (str(row["name"]), str(row["kind"]),
                          dict(row["spec"] or {})))
                if tid not in mig.staging:
                    mig.staging[tid] = self._mig_build_staging(
                        tid, new_member)
        return ({"ok": True, "plan": plan, "state": mig.state}, [])

    def _op_migrate_chunk(self, header: Dict[str, Any],
                          arrays: List[np.ndarray]) -> tuple:
        mig = self._mig_of(header)
        if int(header.get("crc", -1)) != wire.migrate_crc(arrays):
            # torn chunk: abort LOUDLY — the donor's drain raises, its
            # stream fails, and the admin's abort wave rolls back to v
            raise ValueError(
                f"reshard {mig.plan!r}: torn migrate chunk (crc "
                f"mismatch) for table {header.get('table')}")
        tid = int(header["table"])
        lo, hi = (int(x) for x in header["range"])
        target = self._mig_target(mig, tid)
        if str(header.get("kind")) == "dense":
            name, _kind, spec = self._table_specs[tid]
            nlo, nhi = self._mig_new_member(mig).dense_range(
                int(spec["size"]))
            if lo < nlo or hi > nhi:
                raise ValueError(
                    f"reshard {mig.plan!r}: chunk [{lo},{hi}) outside "
                    f"this rank's new range [{nlo},{nhi}) of "
                    f"table {name!r}")
            values = np.asarray(arrays[0])
            if len(values) != hi - lo:
                raise ValueError(
                    f"reshard {mig.plan!r}: chunk [{lo},{hi}) carries "
                    f"{len(values)} elements")
            # set semantics, idempotent: a replayed chunk (donor link
            # redial) overwrites with the same bytes
            target._put_range(lo - nlo, values)
        else:
            keys = np.ascontiguousarray(arrays[0]).astype(np.uint64,
                                                          copy=False)
            self._mig_kv_inject(target, keys,
                                host_values(arrays[1], target.dtype))
        mig.chunks_in += 1
        return ({"ok": True, "seq": header.get("seq")}, [])

    def _op_migrate_fwd(self, header: Dict[str, Any],
                        arrays: List[np.ndarray]) -> tuple:
        mig = self._mig_of(header)
        orig, origins = wire.migrate_fwd_unwrap(header)
        op = str(orig.get("op"))
        tid = int(orig["table"])
        target = self._mig_target(mig, tid)
        option = self._option(orig)
        if op == "add":
            glo, ghi = (int(x) for x in orig["range"])
            _name, _kind, spec = self._table_specs[tid]
            nlo, nhi = self._mig_new_member(mig).dense_range(
                int(spec["size"]))
            delta = np.asarray(arrays[0])
            local = np.zeros(nhi - nlo, dtype=target.np_dtype)
            local[glo - nlo: ghi - nlo] = delta
            handle = target.add(local, option, sync=False)
        elif op == "kv_add":
            keys = np.ascontiguousarray(arrays[0]).astype(np.uint64,
                                                          copy=False)
            handle = target.add(keys, np.asarray(arrays[1]), option,
                                sync=False)
        else:
            raise ValueError(f"unforwardable op {op!r}")
        reply = ({"ok": True, "gen": handle.generation,
                  "fwd": True}, [])
        # exactly-once note: the ORIGIN (client, rid) pairs in the
        # frame are trace breadcrumbs, NOT a dedup key here — rids are
        # per-connection, so a client resend always replays at the
        # DONOR (whose dedup caches the relay reply and never forwards
        # twice), and the donor's link resends replay from this
        # member's own wire dedup under the link's client id. Caching
        # origin rids here would poison the client's direct rid space
        # on this connection.
        mig.forwards_in += 1
        return reply

    def _op_migrate_state(self, header: Dict[str, Any]) -> tuple:
        mig = self._migration
        if mig is None:
            return ({"ok": True, "state": "idle"}, [])
        return ({"ok": True, **mig.status()}, [])

    def _op_migrate_commit(self, header: Dict[str, Any]) -> tuple:
        mig = self._mig_of(header)
        if mig.state == "committed":
            return ({"ok": True, "already": True,
                     "version": mig.new.version}, [])
        if mig.state in ("failed", "aborted", "begin", "streaming"):
            return ({"ok": False, "state": mig.state,
                     "server": self.name, "error": mig.error
                     or f"cannot commit from state {mig.state!r}"},
                    [])
        t0 = time.time()
        with mig.lock:
            # drain every outstanding chunk/forward ack first: an
            # unacked frame at the swap could be lost — a dead link
            # raises here, failing the commit (admin then aborts)
            for link in mig.links.values():
                link.drain()
            if mig.rank < mig.new.n:
                new_member = _partition_mod.PartitionMember(
                    mig.new, mig.rank)
                old_member = self._partition
                for tid in sorted(mig.staging):
                    self._mig_commit_table(mig, tid, mig.staging[tid],
                                           old_member, new_member)
                self._partition = new_member
                for tid, (name, kind, spec) in \
                        self._table_specs.items():
                    self._table_parts[tid] = self._part_info(
                        name, kind, spec)
                if self._tap is not None:
                    self._tap.update_claim(mig.new.to_wire())
            # an EVICTED rank (shrink) never flips: it keeps relaying
            # old-map frames by the new map until the admin shuts it
            # down after the linger window
            mig.staging.clear()
            mig.state = "committed"
        if mig.ctx is not None and _trace.active():
            with _trace.adopt_remote(mig.ctx):
                _trace.emit_span("server.migrate.commit", t0,
                                 time.time() - t0, server=self.name,
                                 plan=mig.plan,
                                 version=mig.new.version)
        log.info("server %r: reshard %r COMMITTED at v%d "
                 "(%d chunks in, %d forwards in)", self.name,
                 mig.plan, mig.new.version, mig.chunks_in,
                 mig.forwards_in)
        return ({"ok": True, "version": mig.new.version}, [])

    def _op_migrate_abort(self, header: Dict[str, Any]) -> tuple:
        mig = self._migration
        plan = str(header.get("plan", ""))
        if mig is None or mig.plan != plan:
            return ({"ok": True, "idle": True}, [])
        if mig.state == "committed":
            return ({"ok": False, "server": self.name,
                     "error": "cannot abort a committed reshard"}, [])
        with mig.lock:
            mig.state = "aborted"
            # live tables were never touched by the migration (donors
            # stream FROM them, recipients write STAGING) — dropping
            # staging leaves v serving bit-exactly
            mig.staging.clear()
            links = list(mig.links.values())
            mig.links.clear()
        for link in links:
            with contextlib.suppress(Exception):
                link.abort()
            with contextlib.suppress(Exception):
                link.close()
        self._c_mig_aborts.inc()
        self._migration = None
        log.warn("server %r: reshard %r ABORTED (%s)", self.name,
                 plan, header.get("reason") or mig.error or "admin")
        return ({"ok": True, "aborted": True}, [])

    def _op_migrate_fin(self, header: Dict[str, Any]) -> tuple:
        log.info("server %r: reshard %r stream from rank %s done "
                 "(%s chunks, %s bytes)", self.name,
                 header.get("plan"), header.get("from_rank"),
                 header.get("chunks"), header.get("bytes"))
        return ({"ok": True}, [])

    # -- resharding internals ----------------------------------------------

    def _mig_of(self, header: Dict[str, Any]) -> _Migration:
        mig = self._migration
        plan = str(header.get("plan", ""))
        if mig is None or mig.plan != plan:
            raise ValueError(
                f"no reshard plan {plan!r} on server {self.name!r}")
        return mig

    def _mig_new_member(self, mig: _Migration):
        if mig.rank >= mig.new.n:
            raise ValueError(
                f"rank {mig.rank} is evicted by v{mig.new.version} "
                "and owns nothing under the new map")
        return _partition_mod.PartitionMember(mig.new, mig.rank)

    def _mig_build_staging(self, tid: int, new_member):
        """A NEW-geometry shard for one table. The name gets a version
        suffix so a tiered staging table never shares the live one's
        disk spill path (the registry is a list — no name key to
        collide on)."""
        name, kind, spec = self._table_specs[tid]
        return self._build_table(f"{name}.v{new_member.map.version}",
                                 kind, dict(spec), member=new_member)

    def _mig_target(self, mig: _Migration, tid: int):
        """Where a chunk/forward lands: the staging shard, or (on a
        member born at v+1, whose live tables ARE the new geometry)
        the live table."""
        st = mig.staging.get(tid)
        if st is not None:
            return st
        table = self._tables.get(tid)
        if table is None:
            raise KeyError(
                f"no table {tid} for reshard {mig.plan!r}")
        return table

    def _mig_link(self, mig: _Migration, rcpt: int):
        """This donor's FIFO link to one recipient (caller holds
        ``mig.lock``): dialed once, manifest first — so every chunk
        and forward to that rank rides ONE ordered stream, which is
        what makes chunk-then-forward ordering free."""
        link = mig.links.get(int(rcpt))
        if link is not None:
            return link
        addr = mig.members.get(int(rcpt))
        if not addr:
            raise ValueError(
                f"reshard {mig.plan!r}: no address for rank {rcpt}")
        from multiverso_tpu_torch.client import transport as _transport
        link = _transport.WireClient(
            addr, client=f"mig:{self.name}", quant=None,
            retry_policy=_replication.repl_retry_policy(
                f"mig-{self.name}"),
            deadline_s=None)
        mig.links[int(rcpt)] = link
        rows = [{"table": tid, "name": name, "kind": kind,
                 "spec": spec}
                for tid, (name, kind, spec)
                in sorted(self._table_specs.items())]
        link.submit({"op": wire.MIGRATE_MANIFEST, "plan": mig.plan,
                     "from_rank": mig.rank,
                     "map": mig.new.to_wire(), "tables": rows}, [])
        return link

    def _mig_rate_sleep(self, chunks: int = 1) -> None:
        rate = float(self._migrate_rate or 0.0)
        if rate > 0.0:
            time.sleep(chunks / rate)

    def _mig_forwarding(self) -> Optional[_Migration]:
        """The in-flight migration IF this member must forward writes
        alongside its applies (pre-commit donor primary)."""
        mig = self._migration
        if mig is not None and mig.donor \
                and mig.state in ("streaming", "shipped"):
            return mig
        return None

    def _relay_mode(self, header: Dict[str, Any]
                    ) -> Optional[_Migration]:
        """Post-commit old-map frame detection: clients stamp every
        frame with the map version it was built against (``pv``,
        frozen at build so reconnect replays stay identical); anything
        below the committed TARGET version addresses geometry this
        member no longer serves. Comparing against the target (not the
        live partition) covers the evicted rank too, whose partition
        never flips."""
        mig = self._migration
        if mig is None or mig.state != "committed" \
                or mig.old is None:
            return None
        pv = header.get("pv")
        if pv is None:
            return None
        return mig if int(pv) < mig.new.version else None

    def _mig_remap_refusal(self, mig: _Migration) -> Dict[str, Any]:
        return {"ok": False, "remap": True, "server": self.name,
                "partition": mig.new.to_wire(),
                "error": f"partition map advanced to "
                         f"v{mig.new.version}: re-read the fleet "
                         "file and re-split"}

    def _mig_forward_dense(self, mig: _Migration, tid: int,
                           delta: np.ndarray, option_raw,
                           origins: List[Tuple[str, Any]],
                           shipped_only: bool = True) -> None:
        """Forward the moved slices of one APPLIED dense delta (caller
        holds ``mig.lock``). Pre-commit: only already-shipped spans —
        the not-yet-extracted rest rides its chunk. Post-commit relay
        (``shipped_only=False``): every donated span."""
        segs = mig.dense_segs.get(tid)
        if not segs:
            return
        _name, _kind, spec = self._table_specs[tid]
        olo, _ohi = _partition_mod.PartitionMember(
            mig.old, mig.rank).dense_range(int(spec["size"]))
        for rcpt, slo, shi in segs:
            spans = [(slo, shi)] if not shipped_only \
                else mig.shipped_overlaps(tid, slo, shi)
            for lo, hi in spans:
                sl = np.ascontiguousarray(
                    np.asarray(delta)[lo - olo: hi - olo])
                if sl.size == 0:
                    continue
                orig = {"op": "add", "table": tid,
                        "range": [int(lo), int(hi)]}
                if option_raw:
                    orig["option"] = dict(option_raw)
                link = self._mig_link(mig, rcpt)
                link.submit(wire.migrate_fwd_wrap(
                    orig, plan=mig.plan, from_rank=mig.rank,
                    origins=origins), [sl])
                mig.forwards += 1
                self._c_mig_fwds.inc()
                try:
                    _chaos.chaos_point("reshard.handoff")
                except _chaos.ChaosError as exc:
                    # CONTAINED: the forward is already on the link;
                    # an error reply here would be dedup-cached and
                    # replayed to every client resend as a permanent
                    # failure
                    log.warn("reshard.handoff chaos (forward, "
                             "contained): %s", exc)

    def _mig_forward_kv(self, mig: _Migration, tid: int,
                        keys: np.ndarray, delta: np.ndarray,
                        option_raw, origins: List[Tuple[str, Any]],
                        shipped_only: bool = True) -> None:
        """KV counterpart of :meth:`_mig_forward_dense` (caller holds
        ``mig.lock``); keys filter by OLD-map logical bucket, which is
        version-invariant (the bucket space is pinned across a
        reshard)."""
        segs = mig.kv_segs.get(tid)
        if not segs:
            return
        keys = np.ascontiguousarray(keys).astype(np.uint64,
                                                 copy=False)
        if len(keys) == 0:
            return
        kb = mig.old.kv_bucket(keys)
        for rcpt, blo, bhi in segs:
            spans = [(blo, bhi)] if not shipped_only \
                else mig.shipped_overlaps(tid, blo, bhi)
            for lo, hi in spans:
                sel = (kb >= lo) & (kb < hi)
                if not sel.any():
                    continue
                ck = np.ascontiguousarray(keys[sel])
                cv = np.ascontiguousarray(np.asarray(delta)[sel])
                orig = {"op": "kv_add", "table": tid}
                if option_raw:
                    orig["option"] = dict(option_raw)
                link = self._mig_link(mig, rcpt)
                link.submit(wire.migrate_fwd_wrap(
                    orig, plan=mig.plan, from_rank=mig.rank,
                    origins=origins), [ck, cv])
                mig.forwards += 1
                self._c_mig_fwds.inc()
                try:
                    _chaos.chaos_point("reshard.handoff")
                except _chaos.ChaosError as exc:
                    log.warn("reshard.handoff chaos (forward, "
                             "contained): %s", exc)

    def _mig_relay_add(self, mig: _Migration, header: Dict[str, Any],
                       arrays: List[np.ndarray],
                       origin: Optional[str],
                       force_sync: bool) -> tuple:
        """A post-commit dense write built against the OLD map:
        dropping it loses an update the client already paid for, so
        apply the retained overlap locally and forward the donated
        slices — then tell the client to re-split (``remap``)."""
        tid = int(header.get("table", -1))
        if tid not in self._table_specs:
            raise KeyError(f"no table {tid} on this server")
        _name, _kind, spec = self._table_specs[tid]
        size = int(spec["size"])
        olo, ohi = _partition_mod.PartitionMember(
            mig.old, mig.rank).dense_range(size)
        delta = np.asarray(
            wire.decode_delta(header.get("quant"), arrays))
        if len(delta) != ohi - olo:
            raise ValueError(
                f"relayed add length {len(delta)} != old-map local "
                f"range {ohi - olo}")
        gen = 0
        if mig.rank < mig.new.n:
            nlo, nhi = _partition_mod.PartitionMember(
                mig.new, mig.rank).dense_range(size)
            table = self._tables[tid]
            local = np.zeros(nhi - nlo, dtype=table.np_dtype)
            x, y = max(olo, nlo), min(ohi, nhi)
            if x < y:
                local[x - nlo: y - nlo] = delta[x - olo: y - olo]
            handle = table.add(
                local, self._option(header),
                sync=bool(header.get("sync")) or force_sync)
            gen = handle.generation
        if not self._follower:
            with mig.lock:
                self._mig_forward_dense(
                    mig, tid, delta, header.get("option"),
                    [(origin or "?", header.get("rid"))],
                    shipped_only=False)
                for link in mig.links.values():
                    link.drain()
        return ({"ok": True, "gen": gen, "relay": True,
                 "remap": True,
                 "partition": mig.new.to_wire()}, [])

    def _mig_relay_kv_add(self, mig: _Migration,
                          header: Dict[str, Any],
                          arrays: List[np.ndarray],
                          origin: Optional[str],
                          force_sync: bool) -> tuple:
        """KV counterpart of :meth:`_mig_relay_add`: split by NEW-map
        ownership, apply mine, forward the rest."""
        tid = int(header.get("table", -1))
        keys = np.ascontiguousarray(arrays[0]).astype(np.uint64,
                                                      copy=False)
        delta = np.asarray(
            wire.decode_delta(header.get("quant"), arrays[1:]))
        gen = 0
        mine = (mig.new.kv_owner(keys) == mig.rank) \
            if mig.rank < mig.new.n and len(keys) \
            else np.zeros(len(keys), bool)
        if mine.any():
            handle = self._tables[tid].add(
                keys[mine], delta[mine], self._option(header),
                sync=bool(header.get("sync")) or force_sync)
            gen = handle.generation
        if not self._follower and len(keys) and not mine.all():
            with mig.lock:
                self._mig_forward_kv(
                    mig, tid, keys[~mine], delta[~mine],
                    header.get("option"),
                    [(origin or "?", header.get("rid"))],
                    shipped_only=False)
                for link in mig.links.values():
                    link.drain()
        return ({"ok": True, "gen": gen, "relay": True,
                 "remap": True,
                 "partition": mig.new.to_wire()}, [])

    def _mig_stream(self, mig: _Migration) -> None:
        """Donor streaming thread: walk every donated range, ship it
        chunk by chunk (each chunk under ``mig.lock``, the rate sleep
        outside), then FIN + drain and flip to "shipped". Any error —
        dead recipient, chaos, torn-chunk reply — marks the migration
        failed; the admin's poll sees it and aborts fleet-wide."""
        t0 = time.time()
        ctx = _trace.adopt_remote(mig.ctx) \
            if mig.ctx is not None and _trace.active() \
            else contextlib.nullcontext()
        try:
            with ctx:
                self._mig_stream_ranges(mig)
                with mig.lock:
                    if mig.state != "streaming":
                        return
                    for link in mig.links.values():
                        link.submit({"op": wire.MIGRATE_FIN,
                                     "plan": mig.plan,
                                     "from_rank": mig.rank,
                                     "chunks": mig.chunks,
                                     "bytes": mig.moved_bytes}, [])
                    for link in mig.links.values():
                        link.drain()
                    mig.state = "shipped"
                if _trace.active():
                    _trace.emit_span(
                        "server.migrate.stream", t0,
                        time.time() - t0, server=self.name,
                        plan=mig.plan, chunks=mig.chunks,
                        bytes=mig.moved_bytes)
        except Exception as exc:    # noqa: BLE001 — any stream fault
            mig.error = f"{type(exc).__name__}: {exc}"  # fails the
            with mig.lock:                              # reshard, not
                if mig.state in ("begin", "streaming"):  # the server
                    mig.state = "failed"
            log.warn("server %r: reshard %r stream FAILED: %s",
                     self.name, mig.plan, mig.error)

    def _mig_stream_ranges(self, mig: _Migration) -> None:
        for tid in sorted(set(mig.dense_segs) | set(mig.kv_segs)):
            _name, _kind, spec = self._table_specs[tid]
            table = self._tables[tid]
            if tid in mig.dense_segs:
                olo, _ohi = _partition_mod.PartitionMember(
                    mig.old, mig.rank).dense_range(int(spec["size"]))
                for rcpt, seg_lo, seg_hi in mig.dense_segs[tid]:
                    pos = seg_lo
                    while pos < seg_hi:
                        hi = min(pos + _MIG_DENSE_CHUNK, seg_hi)
                        with mig.lock:
                            if mig.state != "streaming":
                                return
                            _chaos.chaos_point("reshard.handoff")
                            link = self._mig_link(mig, rcpt)
                            # read the live storage EVERY chunk, under
                            # the lock: concurrent writes land between
                            # chunks, never inside one
                            vals = table._host_range(pos - olo, hi - olo)
                            link.submit(wire.migrate_chunk_header(
                                mig.plan, table=tid, kind="dense",
                                lo=pos, hi=hi, seq=mig.next_seq(),
                                from_rank=mig.rank,
                                arrays=[vals]), [vals])
                            mig.mark_shipped(tid, pos, hi)
                            mig.chunks += 1
                            mig.moved_bytes += int(vals.nbytes)
                            self._c_mig_chunks.inc()
                            self._c_mig_bytes.inc(int(vals.nbytes))
                        self._mig_rate_sleep()
                        pos = hi
            for rcpt, blo, bhi in mig.kv_segs.get(tid, ()):
                sent = 0
                # one lock hold per donated bucket SEGMENT: the live
                # rows are enumerated and every chunk submitted before
                # any concurrent write can land between them, so
                # mark_shipped flips the whole segment atomically
                with mig.lock:
                    if mig.state != "streaming":
                        return
                    _chaos.chaos_point("reshard.handoff")
                    link = self._mig_link(mig, rcpt)
                    keys, rows = self._mig_kv_rows(table)
                    if len(keys):
                        kb = mig.old.kv_bucket(keys)
                        sel = (kb >= blo) & (kb < bhi)
                        mkeys = keys[sel]
                        mrows = rows[sel]
                        for s in range(0, len(mkeys), _MIG_KV_CHUNK):
                            ck = np.ascontiguousarray(
                                mkeys[s:s + _MIG_KV_CHUNK])
                            cv = to_wire(mrows[s:s + _MIG_KV_CHUNK],
                                         table.dtype)
                            link.submit(wire.migrate_chunk_header(
                                mig.plan, table=tid, kind="kv",
                                lo=blo, hi=bhi, seq=mig.next_seq(),
                                from_rank=mig.rank,
                                arrays=[ck, cv]), [ck, cv])
                            nb = int(ck.nbytes + cv.nbytes)
                            mig.chunks += 1
                            mig.moved_bytes += nb
                            sent += 1
                            self._c_mig_chunks.inc()
                            self._c_mig_bytes.inc(nb)
                    mig.mark_shipped(tid, blo, bhi)
                self._mig_rate_sleep(max(sent, 1))

    def _mig_kv_rows(self, table) -> Tuple[np.ndarray, np.ndarray]:
        """Every live ``(key u64, value row)`` pair this shard holds, in
        bucket then lane order (values in the table's host form).
        Tier-aware: device rows come off the live shards (only their
        live lanes leave the device); warm/cold rows come from the
        host/disk tiers' records via ``peek`` (never faults in) — a
        tiered donor demotes-and-forwards with device memory flat."""
        out_k: List[np.ndarray] = []
        out_v: List[np.ndarray] = []

        def collect(hk: np.ndarray, hv: np.ndarray) -> None:
            live = _live_lanes(hk)
            if live.any():
                out_k.append(_hashing._join_keys(hk[live]))
                out_v.append(np.asarray(hv)[live])

        tiers = getattr(table, "tiers", None)
        if tiers is None:
            for keys, vals in zip(table.key_shards, table.value_shards):
                live = (keys != -1).any(-1)
                if bool(live.any()):
                    out_k.append(_hashing._join_keys(
                        keys[live].cpu().numpy().view(np.uint32)))
                    out_v.append(host_array(vals[live]))
        else:
            from multiverso_tpu_torch.storage import manager as _tm
            slots = np.flatnonzero(np.asarray(tiers.bucket_at) >= 0)
            if len(slots):
                hk, hv, _state = table._gather_slots(slots)
                collect(hk, hv)
            for b in list(tiers.host.buckets()):
                if tiers.tier[int(b)] == _tm.TIER_HOST:
                    rec = tiers.host.peek(int(b))
                    collect(rec.keys[None], rec.values[None])
            for b in list(tiers.disk.buckets()):
                if tiers.tier[int(b)] == _tm.TIER_DISK:
                    rec = tiers.disk.peek(int(b))
                    collect(rec.keys[None], rec.values[None])
        if not out_k:
            vd = int(getattr(table, "value_dim", 0) or 0)
            return (np.zeros(0, np.uint64),
                    np.zeros((0, vd) if vd else (0,),
                             host_dtype(table.dtype)))
        return (np.concatenate(out_k),
                np.concatenate([np.asarray(v) for v in out_v], axis=0))

    @staticmethod
    def _mig_set_row(bk: np.ndarray, bv: np.ndarray, k2: np.ndarray,
                     row, name: str, key: int) -> None:
        """Overwrite key ``k2``'s lane in one bucket's HOST copy
        (``bk``: (S, 2) u32, ``bv``: (S[, V])), claiming the first
        empty lane for a new key."""
        hit = np.flatnonzero((bk == k2).all(-1))
        if len(hit):
            bv[int(hit[0])] = row
            return
        empty = np.flatnonzero((bk == _EMPTY_WORD).all(-1))
        if not len(empty):
            raise ValueError(
                f"kv table {name!r}: migrated key {key} overflows "
                f"its bucket ({len(bk)} slots)")
        lane = int(empty[0])
        bk[lane] = k2
        bv[lane] = row

    @staticmethod
    def _mig_set_rows(hk: np.ndarray, hv: np.ndarray, pos: np.ndarray,
                      k2: np.ndarray, rows, name: str,
                      keys: np.ndarray) -> None:
        """:meth:`_mig_set_row` over distinct keys at once: key i goes to
        bucket row ``pos[i]``; a present key's lane is overwritten, and
        the new keys of a bucket, in their given order, take its empty
        lanes in lane order — where the one-by-one loop puts them."""
        match = (hk[pos] == k2[:, None, :]).all(-1)         # (n, S)
        hit = match.any(1)
        if hit.any():
            hv[pos[hit], match[hit].argmax(1)] = rows[hit]
        miss = np.flatnonzero(~hit)
        if not len(miss):
            return
        order = miss[np.argsort(pos[miss], kind="stable")]
        mp = pos[order]
        starts = np.flatnonzero(np.concatenate([[True], mp[1:] != mp[:-1]]))
        nth = np.arange(len(order)) - np.repeat(
            starts, np.diff(np.append(starts, len(order))))
        empty = (hk == _EMPTY_WORD).all(-1)                  # (m, S)
        room = empty.sum(1)
        over = nth >= room[mp]
        if over.any():
            i = int(order[np.flatnonzero(over)[0]])
            raise ValueError(
                f"kv table {name!r}: migrated key {int(keys[i])} "
                f"overflows its bucket ({hk.shape[1]} slots)")
        lane = (empty[mp] & (np.cumsum(empty[mp], 1)
                             == (nth + 1)[:, None])).argmax(1)
        hk[mp, lane] = k2[order]
        hv[mp, lane] = rows[order]

    def _mig_kv_install(self, table, buckets: np.ndarray, hk: np.ndarray,
                        hv: np.ndarray) -> None:
        """ONE install of edited bucket rows on every replica and shard
        (the reference reinstalls the whole table; only these rows
        changed), with a generation bump so outstanding handles read
        superseded."""
        table._put_bucket_rows(buckets, hk, hv)
        with table._option_lock:
            table.generation += 1
        table._notify_views()

    def _mig_kv_inject(self, table, keys: np.ndarray,
                       rows: np.ndarray) -> None:
        """Set-semantics install of migrated (key, value-row) pairs —
        idempotent, so a replayed chunk is harmless. Plain KV: edit the
        host copies of the touched bucket rows (keys in the given order,
        each into its bucket's first empty lane), ONE install. Tiered:
        each bucket is edited in its CURRENT tier (device slot / host
        arena / disk record / virgin→host-or-disk), so injection never
        inflates device memory either."""
        if len(keys) == 0:
            return
        keys = np.ascontiguousarray(keys).astype(np.uint64, copy=False)
        k2 = _hashing._split_keys(keys)
        tiers = getattr(table, "tiers", None)
        if tiers is None:
            buckets = table._buckets_of(keys).astype(np.int64)
            ub = np.unique(buckets)
            pos = np.searchsorted(ub, buckets)
            hk, hv = table._bucket_rows(ub)
            if len(np.unique(keys)) == len(keys):
                self._mig_set_rows(hk, hv, pos, k2, rows, table.name,
                                   keys)
            else:
                for i in range(len(keys)):
                    self._mig_set_row(hk[pos[i]], hv[pos[i]], k2[i],
                                      rows[i], table.name, int(keys[i]))
            self._mig_kv_install(table, ub, hk, hv)
            return
        from multiverso_tpu_torch.storage import manager as _tm
        from multiverso_tpu_torch.storage.tiers import BucketRecord
        logical = table._buckets_of(keys)
        order = np.argsort(logical, kind="stable")
        device: List[Tuple[int, np.ndarray]] = []   # (bucket, key idxs)
        i = 0
        while i < len(order):
            b = int(logical[order[i]])
            j = i
            while j < len(order) and int(logical[order[j]]) == b:
                j += 1
            idxs = order[i:j]
            i = j
            code = int(tiers.tier[b])
            if code == _tm.TIER_DEVICE:
                device.append((b, idxs))
                continue
            if code == _tm.TIER_HOST:
                rec = tiers._host_take(b)
            elif code == _tm.TIER_DISK:
                rec = tiers.disk.peek(b)
            else:   # TIER_VIRGIN
                rec = tiers.spec.empty()
            for t in idxs:
                self._mig_set_row(rec.keys, rec.values, k2[t],
                                  rows[t], table.name, int(keys[t]))
            if code == _tm.TIER_DISK:
                tiers.disk.spill(b, rec)    # re-spill overwrites the
            elif code == _tm.TIER_HOST \
                    or not tiers.host.full:  # slot in place
                tiers._host_put(b, rec)
                tiers.tier[b] = _tm.TIER_HOST
            else:
                tiers.disk.spill(b, rec)
                tiers.tier[b] = _tm.TIER_DISK
            tiers._live[b] = rec.live()
        if device:
            slots = np.array([tiers.slot_of[b] for b, _ in device],
                             np.int64)
            hk, hv, hs = table._gather_slots(slots)
            recs = []
            for n, (b, idxs) in enumerate(device):
                for t in idxs:
                    self._mig_set_row(hk[n], hv[n], k2[t], rows[t],
                                      table.name, int(keys[t]))
                tiers._live[b] = int(_live_lanes(hk[n]).sum())
                recs.append(BucketRecord(keys=hk[n], values=hv[n],
                                         state=[leaf[n] for leaf in hs]))
            table._scatter_slots(slots, recs)
            with table._option_lock:
                table.generation += 1
            table._notify_views()

    def _mig_commit_table(self, mig: _Migration, tid: int, st,
                          old_member, new_member) -> None:
        """Swap one table to its new-geometry staging shard: copy the
        RETAINED intersection from the live shard (the moved part
        arrived as chunks/forwards), then replace the live table and
        rebuild its read replica."""
        name, kind, spec = self._table_specs[tid]
        old_table = self._tables[tid]
        if kind == "array":
            size = int(spec["size"])
            olo, ohi = old_member.dense_range(size)
            nlo, nhi = new_member.dense_range(size)
            x, y = max(olo, nlo), min(ohi, nhi)
            if x < y:
                st._put_range(x - nlo,
                              old_table._host_range(x - olo, y - olo))
        else:
            keys, rows = self._mig_kv_rows(old_table)
            if len(keys):
                blo, bhi = new_member.bucket_range()
                kb = mig.new.kv_bucket(keys)
                sel = (kb >= blo) & (kb < bhi)
                if sel.any():
                    self._mig_kv_inject(st, keys[sel], rows[sel])
        self._tables[tid] = st
        rep = self._replicas.pop(tid, None)
        if rep is not None:
            rep.stop()
        if kind in ("array", "kv"):
            self._replicas[tid] = TableReplica(
                st, kind, server=self.name, tid=tid,
                stream=self._fstate if self._follower else None)

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

    def _op_create(self, header: Dict[str, Any],
                   force_tid: Optional[int] = None,
                   staging_ok: bool = False) -> tuple:
        name = str(header["name"])
        kind = str(header.get("kind", "array"))
        spec = dict(header.get("spec") or {})
        mig = self._migration
        if name not in self._by_name and not staging_ok \
                and mig is not None and mig.old is not None \
                and mig.state in ("begin", "streaming", "shipped"):
            # a brand-new table mid-reshard would miss the stream plan
            # (begin precomputed the donated segments from the tables
            # that existed then) — refuse, the client retries after
            # the commit. Idempotent attaches above are unaffected.
            return ({"ok": False, "retry": True, "server": self.name,
                     "error": f"reshard {mig.plan!r} in flight: "
                              "retry create after commit"}, [])
        if name in self._by_name:
            # idempotent by name: N workers all issue the same creates
            # at startup; first one builds, the rest attach
            tid = self._by_name[name]
            if force_tid is not None and force_tid != tid:
                raise ValueError(
                    f"replicated create {name!r}: primary id "
                    f"{force_tid} != local id {tid}")
            table = self._tables[tid]
        else:
            table = self._build_table(name, kind, spec)
            # a replicated create carries the PRIMARY's table id so the
            # follower's id space stays aligned (clients reuse their
            # primary handles against followers verbatim)
            tid = self._next_table if force_tid is None \
                else int(force_tid)
            if tid in self._tables:
                raise ValueError(f"table id {tid} already in use")
            self._next_table = max(self._next_table, tid + 1)
            self._tables[tid] = table
            self._by_name[name] = tid
            # the GLOBAL spec survives for migrate_begin: staging
            # shards and recipient manifests rebuild from it
            self._table_specs[tid] = (name, kind, dict(spec))
            if self._partition is not None:
                self._table_parts[tid] = self._part_info(name, kind,
                                                         spec)
            if kind in ("array", "kv"):
                # dormant until the first staleness-tolerant read;
                # tiered tables excluded (device arrays are one tier,
                # a snapshot of them would serve partial data). On a
                # follower the snapshot's staleness is measured
                # against the repl stream's noted primary generation,
                # not the local one.
                self._replicas[tid] = TableReplica(
                    table, kind, server=self.name, tid=tid,
                    stream=self._fstate if self._follower else None)
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

    def _build_table(self, name: str, kind: str, spec: Dict[str, Any],
                     member: Any = _DEFAULT_MEMBER):
        """Instantiate a table from its GLOBAL create spec, on the
        server's device (or mesh). A fleet member builds only its local
        shard: the contiguous element range of a dense table, or
        ceil(capacity/n) KV slots (the router never sends this rank a
        key it doesn't own, so local bucket identity is free to differ
        from the fleet's logical bucket space). ``member`` overrides the
        geometry — how a reshard builds its NEW-map staging shard while
        the live one keeps serving the old map."""
        common: Dict[str, Any] = {"name": name}
        for key in ("dtype", "updater"):
            if key in spec:
                common[key] = spec[key]
        if self._mesh is not None:
            common["mesh"] = self._mesh
        else:
            common["device"] = self._device
        if member is _DEFAULT_MEMBER:
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
        mig = self._relay_mode(header)
        if mig is not None:
            # post-commit, old-map frame: the live table is already
            # the NEW geometry — a slice would be the wrong length.
            # Structured refusal carrying the new map; the router
            # re-splits and retries (reads are idempotent).
            return (self._mig_remap_refusal(mig), [])
        table = self._table(header)
        self._maybe_arm_replica(header)
        self._heat_touch_dense(header, table)
        values = host_array(table.get_tensor())
        return ({"ok": True}, [to_wire(values, table.dtype)])

    def _op_kv_get(self, header: Dict[str, Any],
                   arrays: List[np.ndarray]) -> tuple:
        mig = self._relay_mode(header)
        if mig is not None:
            return (self._mig_remap_refusal(mig), [])
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
                force_sync: bool = False,
                origin: Optional[str] = None) -> tuple:
        relay = self._relay_mode(header)
        if relay is not None:
            # post-commit, old-map WRITE: dropping it loses an update
            # the client already paid for — relay it by the new map
            # instead (apply the retained overlap, forward the moved
            # slices) and tell the client to re-split
            return self._mig_relay_add(relay, header, arrays, origin,
                                       force_sync)
        table = self._table(header)
        self._heat_touch_dense(header, table)
        # dequant-before-apply: the table layer only ever sees floats
        delta = wire.decode_delta(header.get("quant"), arrays)
        sync = bool(header.get("sync")) or force_sync
        mig = self._mig_forwarding()
        if mig is None:
            handle = table.add(delta, self._option(header), sync=sync)
        else:
            # donor mid-reshard: apply + forward under the migration
            # lock (see _Migration) so this delta can never fall
            # between a shipped chunk and its forward
            with mig.lock:
                handle = table.add(delta, self._option(header),
                                   sync=sync)
                self._mig_forward_dense(
                    mig, int(header["table"]), np.asarray(delta),
                    header.get("option"),
                    [(origin or "?", header.get("rid"))])
        return ({"ok": True, "gen": handle.generation}, [])

    def _op_kv_add(self, header: Dict[str, Any],
                   arrays: List[np.ndarray],
                   force_sync: bool = False,
                   origin: Optional[str] = None) -> tuple:
        relay = self._relay_mode(header)
        if relay is not None:
            return self._mig_relay_kv_add(relay, header, arrays,
                                          origin, force_sync)
        table = self._table(header)
        keys = np.ascontiguousarray(arrays[0]).astype(np.uint64,
                                                      copy=False)
        self._heat_touch_keys(header, keys)
        delta = wire.decode_delta(header.get("quant"), arrays[1:])
        sync = bool(header.get("sync")) or force_sync
        mig = self._mig_forwarding()
        if mig is None:
            handle = table.add(keys, delta, self._option(header),
                               sync=sync)
        else:
            with mig.lock:
                handle = table.add(keys, delta, self._option(header),
                                   sync=sync)
                self._mig_forward_kv(
                    mig, int(header["table"]), keys, np.asarray(delta),
                    header.get("option"),
                    [(origin or "?", header.get("rid"))])
        return ({"ok": True, "gen": handle.generation}, [])
