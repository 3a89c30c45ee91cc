"""Client-side scatter-gather router over a sharded server fleet.

Counterpart of ``multiverso_tpu/client/router.py``: the same routing,
follower reads, failover and re-split, over the port's torch-free
transport, so it drives a fleet of either package's servers.

One :class:`~multiverso_tpu_torch.client.transport.WireClient` talks to ONE
table server. A fleet (``python -m multiverso_tpu_torch.server --fleet N``)
is N such servers, each owning a contiguous partition of every table
(:mod:`multiverso_tpu_torch.server.partition`). :class:`FleetClient` makes
the fleet look like one server: it wraps N ``WireClient``\\ s and the
fleet tables split every get/add HOST-side by ownership, pipeline the
per-server sub-requests concurrently, and reassemble replies by the
inverse index — the client half of the reference's multi-server
``ProcessGet``/``ProcessAdd`` partitioning (`src/server.cpp` routes by
row hash; we route by the PartitionMap's contiguous blocks).

Why throughput scales with N: each sub-request rides its OWN
connection, so the existing ≤``MAX_PIPELINE``-unacked windows run in
parallel across servers, and each server runs its own dispatch thread,
fusion cycle, replica publisher, and admission controller over a table
1/N the size.

Layering is deliberate: :class:`FleetArrayTable` / :class:`FleetKVTable`
are thin routers over per-server ``RemoteArrayTable`` /
``RemoteKVTable`` subtables, so everything the transport already does
— pipelined windows, at-least-once resend + server dedup
(exactly-once), shed honoring, quantize-once-at-submit — applies
per shard unchanged. Each per-server ``WireClient`` owns its own
``ResidualStore``, so 1-bit error feedback stays correct *per
connection* (a shared residual across servers would leak one shard's
quantization error into another's stream). KV duplicates are pre-summed
per shard before submit (``np.unique`` + ``np.add.at``, the same
associativity CoalescingBuffer leans on), so a key appearing twice in
one batch costs one wire row and applies once.

The fleet tables present the same duck-typed surface as the remote
tables (``table_id``/``name``/``dtype``/``num_cols``/
``_attach_coalescer``/``add``/``get``/``wait``), so
``client/coalesce.py``'s CoalescingBuffer and the transport's
``DeltaBatcher`` stack on top unchanged.

Partial failure is partial: a SIGKILLed member costs ONLY its
partition. Ops routed to surviving shards keep completing (their
connections never notice); ops touching the dead shard block in that
one client's standard reconnect/replay loop and resume exactly-once
when the member returns. ``get_shard(rank)`` exposes the per-rank
subtable for exactly that kind of surviving-partition work.

Replicated ranks (``--replicas R``, ``server/replication.py``) add two
client-side behaviours on top, both read-path-only by construction:

* **Follower read routing.** When the PartitionMap carries ``replicas
  > 1`` and the fleet file lists follower addresses, bounded-staleness
  reads (``staleness=K``) are served by a STICKY replica pick —
  ``crc32(client_id) % R`` so a worker fleet spreads itself across the
  replica set while each worker keeps one warm connection — with
  fallback to the primary when the follower refuses (lag past the
  bound, structured ``stale`` refusal) or is unreachable. Unbounded
  reads (``staleness=None``) and every mutation always go to the
  primary; follower table ids are valid verbatim because followers
  build tables from the primary's forced-tid replicated creates.

* **Failover.** A shard call that exhausts its retry budget (dead
  primary) or is hello-refused with a NEWER map (someone else already
  failed over) triggers :meth:`FleetClient._recover`: re-read the
  fleet file, ``promote`` the rank's first live follower (idempotent —
  a second promote just reports the bumped map), adopt the v+1 map,
  ``rebind`` the rank's WireClient at the successor (the unacked
  pipeline window survives and replays — the follower's
  origin-(client, rid) dedup records keep the replay exactly-once),
  and broadcast ``adopt`` to the survivors so their next hellos are
  not refused. In-flight mutations that already sat in the pending
  window are NOT resubmitted — the rebind replay is their redelivery.

**Elastic fleet (live resharding).** A reshard (``--grow``/``--shrink``)
bumps the map v→v+1 with a DIFFERENT n. Committed members answer
old-map reads with a structured ``remap`` refusal (carrying the new
map) and RELAY old-map writes — applied locally where retained,
forwarded to the new owner, exactly-once via the origin dedup — so
nothing is lost while this router catches up. On the first ``remap``
(or a hello refusal claiming a different n) the router re-reads the
fleet file with jittered backoff (an N-worker fleet must not
thundering-herd the file at the flip), rebinds surviving rank clients
under the new claim, dials joining ranks, drops evicted ones, re-splits
every fleet table's bounds, and retries the interrupted operation under
the new ownership.

torch-free and file-path loadable (:func:`load_router`) like the
transport — this is worker-process code.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _dep(modname: str, *relpath: str):
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    if "multiverso_tpu_torch" in sys.modules:
        import importlib
        return importlib.import_module(modname)
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, *relpath)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(modname, None)
        raise
    return mod


transport = _dep("multiverso_tpu_torch.client.transport",
                 "client", "transport.py")
partition = _dep("multiverso_tpu_torch.server.partition",
                 "server", "partition.py")
_trace = _dep("multiverso_tpu_torch.telemetry.trace", "telemetry",
              "trace.py")


#: faults that mean "the peer may be gone", not "the request is bad":
#: connection-level errors and an exhausted retry budget trigger the
#: failover path; RemoteError (an application refusal) never does
_DEAD = (ConnectionError, OSError, transport._retry.RetryError)
#: a hello refusal — carries the server's CURRENT map on ``.header``
_REFUSED = transport.wire.WireProtocolError
#: how long a follower stays benched after a hard (transport) miss
#: before reads probe it again
_REPLICA_RETRY_S = 5.0


class _Remapped(Exception):
    """Internal: the fleet changed SHAPE (n) under this operation; the
    tables were re-split — re-run the whole op under the new map."""


def _count(name: str, n: float = 1, **labels) -> None:
    m = sys.modules.get("multiverso_tpu_torch.telemetry.metrics")
    if m is not None:
        try:
            m.counter(name, **labels).inc(n)
        except Exception:
            pass


def _pick_addr(addrs: Sequence[str],
               scheme: Optional[str] = None) -> Optional[str]:
    """First address, or the first matching ``scheme`` when given."""
    addrs = list(addrs or [])
    if not addrs:
        return None
    if scheme:
        for a in addrs:
            if a.split(":", 1)[0].rstrip("/") == scheme \
                    or a.startswith(scheme + "://"):
                return a
    return addrs[0]


def _clone_sub(sub: Any, client: "transport.WireClient") -> Any:
    """A follower-facing twin of a primary subtable: same table id
    (forced-tid replicated creates keep follower id spaces aligned),
    same dtype/geometry, different connection."""
    meta: Dict[str, Any] = {"table": sub.table_id, "name": sub.name,
                            "kind": sub.kind,
                            "dtype": np.dtype(sub.dtype).str}
    if hasattr(sub, "value_dim"):
        meta["value_dim"] = sub.value_dim
        return transport.RemoteKVTable(client, meta)
    meta["size"] = sub.size
    return transport.RemoteArrayTable(client, meta)


def load_router(package_dir: str):
    """File-path load this module (canonical name, no package import)
    from a bare worker script. ``package_dir`` is the
    ``multiverso_tpu_torch`` directory."""
    modname = "multiverso_tpu_torch.client.router"
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    import importlib.util
    path = os.path.join(package_dir, "client", "router.py")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


class FleetHandle:
    """Handle-compatible future over the per-shard handles of one
    logical mutation. ``done()``/``wait()`` quantify over every shard
    the op actually touched. When built by a fleet table the wait path
    runs through the fleet's failover guard, so waiting out a window
    that straddles a primary death completes against the promoted
    follower instead of raising."""

    def __init__(self, handles: Sequence[Any],
                 fleet: Optional["FleetClient"] = None,
                 ranks: Optional[Sequence[int]] = None) -> None:
        self._handles = list(handles)
        self._fleet = fleet
        self._ranks = list(ranks) if ranks is not None \
            else list(range(len(self._handles)))

    def done(self) -> bool:
        return all(h.done() for h in self._handles)

    def wait(self) -> None:
        if self._fleet is None:
            for h in self._handles:
                h.wait()
            return
        for rank, h in zip(self._ranks, self._handles):
            self._fleet._guard_wait(rank, h)

    def result(self) -> None:
        return self.wait()


class _FleetTable:
    """Shared router surface (the CoalescingBuffer duck type, same as
    ``transport._RemoteTable``)."""

    def __init__(self, fleet: "FleetClient", subs: Sequence[Any]) -> None:
        self.fleet = fleet
        self.subs = list(subs)          # rank-ordered per-server tables
        head = self.subs[0]
        self.table_id = head.table_id   # names the table in coalescers
        self.name = head.name
        self.kind = head.kind
        self.dtype = head.dtype
        self._coalescers: List[Any] = []

    @property
    def pmap(self) -> "partition.PartitionMap":
        return self.fleet.pmap

    def get_shard(self, rank: int):
        """The per-rank remote subtable — the surface that keeps
        serving a surviving partition while another member is down."""
        return self.subs[rank]

    def _attach_coalescer(self, buf: Any) -> None:
        self._coalescers.append(buf)

    def flush_coalesced(self) -> None:
        for buf in self._coalescers:
            buf.flush()

    def _resplit(self) -> None:
        """Rebind this table to the fleet's CURRENT client list after
        a reshard: one subtable per new rank (same table id — forced-
        tid manifests keep every member's id space aligned), bounds
        recomputed by the subclass."""
        head = self.subs[0]
        self.subs = [_clone_sub(head, c) for c in self.fleet.clients]

    def _retry_remap(self, thunk: Any) -> Any:
        """Run one whole-table op, re-running it when a reshard
        re-split the table underneath it (bounded — a second flip
        mid-retry is a second re-split, not a loop)."""
        for _ in range(3):
            try:
                return thunk()
            except _Remapped:
                _count("fleet.reshard.resplit", table=self.name)
        raise RuntimeError(
            f"fleet table {self.name!r}: partition map kept moving "
            "across 3 re-splits — aborting this op")

    def wait(self) -> None:
        for rank in range(len(self.subs)):
            self.fleet._guard_drain(rank)

    def _shard_get(self, rank: int, *args: Any,
                   staleness: Optional[int] = None) -> Any:
        """One shard's read, replica-routed: try the sticky follower
        when the read is bounded-staleness and the rank has one, fall
        back to the primary on a structured ``stale`` refusal (lag past
        the bound) or any transport fault — a lagging or dead follower
        costs one extra hop, never an error. The primary leg runs under
        the failover guard."""
        fleet = self.fleet
        rsub = fleet._replica_sub(self, rank, staleness)
        if rsub is not None:
            try:
                out = rsub.get(*args, staleness=staleness)
                fleet._replica_served(rank)
                return out
            except transport.RemoteError as exc:
                header = getattr(exc, "header", None) or {}
                if not (header.get("stale") or header.get("follower")
                        or header.get("remap")):
                    raise       # a real application error, not routing
                # remap: the follower committed a reshard this router
                # hasn't seen — the primary leg will refuse too and
                # drive the re-split through the guard
                fleet._replica_miss(rank, soft=True)
            except (_REFUSED,) + _DEAD:
                fleet._replica_miss(rank, soft=False)
        return fleet._guard(
            rank,
            lambda: self.subs[rank].get(*args, staleness=staleness))


class FleetArrayTable(_FleetTable):
    """Dense 1-D table scattered across the fleet by contiguous
    element ranges (rank r serves global elements [bounds[r],
    bounds[r+1]) as ITS local rows 0..len)."""

    def __init__(self, fleet: "FleetClient", subs: Sequence[Any],
                 size: int) -> None:
        super().__init__(fleet, subs)
        self.size = int(size)
        self.num_cols = 1
        self._bounds = fleet.pmap.dense_bounds(self.size)

    def _resplit(self) -> None:
        super()._resplit()
        self._bounds = self.fleet.pmap.dense_bounds(self.size)

    def get(self, staleness: Optional[int] = None) -> np.ndarray:
        """Whole-table scatter-gather: each server returns its shard
        concurrently; concat in rank order is the inverse map (the
        zero-index-math payoff of contiguous ownership)."""
        def attempt():
            parts = self.fleet._fanout(
                [lambda r=r: self._shard_get(r, staleness=staleness)
                 for r in range(len(self.subs))])
            return np.concatenate(parts)
        with _trace.request("fleet.get", table=self.name):
            return self._retry_remap(attempt)

    def get_range(self, lo: int, hi: int,
                  staleness: Optional[int] = None) -> np.ndarray:
        """Elements [lo, hi) — fetched ONLY from the shards whose
        ranges overlap it. This is the partitioning payoff a single
        server cannot offer: its wire ``get`` is a whole-table
        snapshot, so a range read there ships every element; here a
        shard-aligned range ships 1/N of the bytes end to end."""
        lo, hi = int(lo), int(hi)
        if not 0 <= lo < hi <= self.size:
            raise ValueError(
                f"range [{lo}, {hi}) out of bounds for size {self.size}")

        def attempt():
            b = self._bounds
            ranks = [r for r in range(self.pmap.n)
                     if b[r] < hi and b[r + 1] > lo]
            parts = self.fleet._fanout(
                [lambda r=r: self._shard_get(r, staleness=staleness)
                 for r in ranks])
            if len(parts) == 1:
                r = ranks[0]
                return parts[0][lo - b[r]:hi - b[r]]
            first = ranks[0]
            return np.concatenate(parts)[lo - b[first]:hi - b[first]]
        with _trace.request("fleet.get_range", table=self.name,
                            lo=lo, hi=hi):
            return self._retry_remap(attempt)

    def add(self, delta, option=None, sync: bool = False) -> FleetHandle:
        """Split the global delta by ownership; each slice is submitted
        on its own pipelined connection (quantized there, against that
        connection's residual store)."""
        delta = np.asarray(delta, self.dtype)
        if delta.shape != (self.size,):
            raise ValueError(
                f"fleet add to {self.name!r} expects shape "
                f"({self.size},), got {delta.shape}")
        subs, b = list(self.subs), self._bounds
        handles, ranks = [], []
        with _trace.request("fleet.add", table=self.name):
            for r, sub in enumerate(subs):
                try:
                    handles.append(self.fleet._guard_add(
                        r, lambda sub=sub, lo=b[r], hi=b[r + 1]:
                        sub.add(delta[lo:hi], option)))
                    ranks.append(r)
                except _Remapped:
                    # the fleet changed shape under this op and rank
                    # r's slice never landed (its member is gone):
                    # redistribute JUST that slice by the new bounds —
                    # slices already submitted to survivors are relayed
                    # server-side, resubmitting them would double-apply
                    _count("fleet.reshard.resplit", table=self.name)
                    for r2, h2 in self._readd_range(
                            delta, b[r], b[r + 1], option):
                        handles.append(h2)
                        ranks.append(r2)
        handle = FleetHandle(handles, self.fleet, ranks)
        if sync:
            handle.wait()
        return handle

    add_async = add

    def _readd_range(self, delta: np.ndarray, glo: int, ghi: int,
                     option) -> List[Tuple[int, Any]]:
        """Submit global elements [glo, ghi) of ``delta`` by CURRENT
        ownership, zero-padded to each new owner's full local range."""
        b = self._bounds
        out = []
        for r in range(self.pmap.n):
            lo, hi = max(glo, b[r]), min(ghi, b[r + 1])
            if lo >= hi:
                continue
            local = np.zeros(b[r + 1] - b[r], self.dtype)
            local[lo - b[r]: hi - b[r]] = delta[lo:hi]
            out.append((r, self.fleet._guard_add(
                r, lambda sub=self.subs[r], d=local:
                sub.add(d, option))))
        return out


class FleetKVTable(_FleetTable):
    """Hashed KV table scattered by contiguous logical-bucket blocks:
    a key's splitmix64 bucket picks its owning rank, forever (until a
    map-version bump)."""

    def __init__(self, fleet: "FleetClient", subs: Sequence[Any]) -> None:
        super().__init__(fleet, subs)
        head = self.subs[0]
        self.value_dim = head.value_dim
        self.num_cols = head.num_cols

    def _route(self, keys: np.ndarray
               ) -> List[Tuple[int, np.ndarray]]:
        """(rank, positions-into-keys) per rank that owns >= 1 key."""
        owner = self.pmap.kv_owner(keys)
        out = []
        for r in range(self.pmap.n):
            idx = np.nonzero(owner == r)[0]
            if idx.size:
                out.append((r, idx))
        return out

    def get(self, keys, staleness: Optional[int] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch lookup fanned out by ownership, reassembled into the
        caller's key order via the inverse index."""
        keys = np.ascontiguousarray(np.asarray(keys, np.uint64))
        n = keys.shape[0]

        def attempt():
            shape = (n, self.value_dim) if self.value_dim else (n,)
            values = np.zeros(shape, self.dtype)
            found = np.zeros(n, bool)
            routed = self._route(keys)
            replies = self.fleet._fanout(
                [lambda r=r, idx=idx: self._shard_get(
                    r, keys[idx], staleness=staleness)
                 for r, idx in routed])
            for (r, idx), (vals, fnd) in zip(routed, replies):
                values[idx] = vals
                found[idx] = fnd
            return values, found
        with _trace.request("fleet.kv_get", table=self.name):
            return self._retry_remap(attempt)

    def add(self, keys, deltas, option=None,
            sync: bool = False) -> FleetHandle:
        """Scatter an add by ownership, pre-summing duplicate keys per
        shard first — one wire row per distinct key, one apply per
        distinct key, same associative-sum contract the server's own
        fused batches use."""
        keys = np.ascontiguousarray(np.asarray(keys, np.uint64))
        deltas = np.asarray(deltas, self.dtype)
        handles = []
        ranks = []
        with _trace.request("fleet.kv_add", table=self.name):
            subs = list(self.subs)
            for r, idx in self._route(keys):
                sub_keys = keys[idx]
                sub_deltas = deltas[idx]
                uniq, inv = np.unique(sub_keys, return_inverse=True)
                if uniq.shape[0] != sub_keys.shape[0]:
                    acc = np.zeros(
                        (uniq.shape[0],) + sub_deltas.shape[1:],
                        sub_deltas.dtype)
                    np.add.at(acc, inv, sub_deltas)
                    sub_keys, sub_deltas = uniq, acc
                try:
                    handles.append(self.fleet._guard_add(
                        r, lambda sub=subs[r], k=sub_keys,
                        d=sub_deltas: sub.add(k, d, option)))
                    ranks.append(r)
                except _Remapped:
                    # redistribute ONLY this rank's keys by the new
                    # ownership (survivor submits relay server-side)
                    _count("fleet.reshard.resplit", table=self.name)
                    owner = self.pmap.kv_owner(sub_keys)
                    for r2 in np.unique(owner):
                        sel = owner == r2
                        handles.append(self.fleet._guard_add(
                            int(r2),
                            lambda sub=self.subs[int(r2)],
                            k=sub_keys[sel], d=sub_deltas[sel]:
                            sub.add(k, d, option)))
                        ranks.append(int(r2))
        handle = FleetHandle(handles, self.fleet, ranks)
        if sync:
            handle.wait()
        return handle

    add_async = add


class FleetClient:
    """N ``WireClient``\\ s + one :class:`PartitionMap` = one logical
    parameter server (see module docstring)."""

    def __init__(self, addresses: Sequence[str], *,
                 pmap: Optional["partition.PartitionMap"] = None,
                 version: int = 1,
                 kv_buckets: Optional[int] = None,
                 replicas: int = 1,
                 client: Optional[str] = None,
                 quant: Optional[str] = "env",
                 seed: Optional[int] = None,
                 deadline_s="env",
                 fleet_file: Optional[str] = None,
                 scheme: Optional[str] = None,
                 replica_addrs: Optional[
                     Sequence[Sequence[str]]] = None,
                 read_replica="env") -> None:
        addresses = list(addresses)
        if not addresses:
            raise ValueError("fleet needs at least one server address")
        if pmap is None:
            pmap = partition.PartitionMap(
                len(addresses), version=version, kv_buckets=kv_buckets,
                replicas=replicas)
        if pmap.n != len(addresses):
            raise ValueError(
                f"partition map is for {pmap.n} servers, got "
                f"{len(addresses)} addresses")
        self.pmap = pmap
        self.client_id = client or f"pid{os.getpid()}"
        self._claim = pmap.to_wire()
        self._deadline_s = deadline_s
        self._fleet_file = fleet_file
        self._scheme = scheme
        self._quant = quant
        self._seed = seed
        self._tables: List[_FleetTable] = []
        # one client per member: its OWN pipeline window, dedup stream,
        # residual store, and reconnect/replay loop — shard isolation
        # on the client side mirrors process isolation on the server's
        self.clients = [
            transport.WireClient(
                addr, client=self.client_id, quant=quant,
                seed=None if seed is None else int(seed) + rank,
                deadline_s=deadline_s, partition=self._claim)
            for rank, addr in enumerate(addresses)]
        # ONE persistent pool per fleet client (never a thread per
        # get): sub-requests outlive none of these workers, and the
        # replica fallback is a second sequential hop on the same
        # worker, so pmap.n workers cover every fan-out shape
        self._pool = ThreadPoolExecutor(
            max_workers=pmap.n, thread_name_prefix="mvtpu-fleet")
        # -- replica read routing state --
        # rank -> [follower addresses]; static override (tests) wins,
        # else the launcher fleet file's per-member "replicas" rows
        if replica_addrs is not None:
            self._replica_addrs = [list(a) for a in replica_addrs]
        else:
            self._replica_addrs = self._load_replica_addrs()
        self._replica_clients: Dict[int, Any] = {}
        self._replica_subs: Dict[Tuple[int, int], Any] = {}
        self._replica_down: Dict[int, float] = {}
        self._rlock = threading.Lock()
        # reentrant: _recover may escalate to _restructure (reshard)
        self._folock = threading.RLock()
        reads_on = os.environ.get(
            "MVTPU_REPLICA_READS", "1").strip().lower() \
            not in ("0", "false", "off", "no")
        if read_replica == "env":
            raw = os.environ.get("MVTPU_REPLICA_PICK", "").strip()
            if raw:
                pick = int(raw)
            else:
                # sticky per client: worker fleets hash themselves
                # uniformly across the replica set (0 = primary)
                pick = zlib.crc32(self.client_id.encode()) \
                    % max(int(pmap.replicas), 1)
        else:
            pick = int(read_replica or 0)
        self._replica_pick = pick if reads_on else 0

    def _load_replica_addrs(self) -> List[List[str]]:
        doc = partition.read_fleet_file(self._fleet_file) \
            if self._fleet_file else None
        if doc is None:
            return [[] for _ in range(self.pmap.n)]
        return self._replica_addrs_from(doc)

    def _replica_addrs_from(self, doc: Dict[str, Any]
                            ) -> List[List[str]]:
        members = sorted(doc.get("members", []),
                         key=lambda m: int(m.get("rank", 0)))
        out: List[List[str]] = [[] for _ in range(self.pmap.n)]
        for m in members:
            rank = int(m.get("rank", 0))
            if not 0 <= rank < self.pmap.n:
                continue
            for rep in (m.get("replicas") or []):
                a = _pick_addr(rep.get("addresses"), self._scheme)
                if a:
                    out[rank].append(a)
        return out

    def _fanout(self, thunks: Sequence[Any]) -> List[Any]:
        """Run per-server sub-requests concurrently; surface the first
        failure (a dead member fails ITS sub-request after its client's
        retry budget — other shards' results are already home).

        Trace linkage: the caller's request scope is captured on THIS
        thread and adopted inside every pooled thunk, so each shard's
        ``wire.client.*`` span — and through the wire context, each
        member server's spans — parent under the ONE fleet request
        (one fleet get = one tree spanning N+1 processes)."""
        if len(thunks) <= 1:
            return [t() for t in thunks]
        token = _trace.link()

        def run(t, shard):
            with _trace.adopt(token), \
                    _trace.span("fleet.fanout", shard=shard):
                return t()
        futures = [self._pool.submit(run, t, shard)
                   for shard, t in enumerate(thunks)]
        return [f.result() for f in futures]

    # -- replica read routing ----------------------------------------------

    def _replica_sub(self, table: _FleetTable, rank: int,
                     staleness: Optional[int]) -> Optional[Any]:
        """The follower subtable a read on ``rank`` should try first,
        or None when the read must go to the primary: unbounded reads
        (a follower cannot serve read-your-writes honestly), a pick of
        0 (this client is sticky-primary), no followers for the rank,
        or a follower benched after a recent hard miss."""
        if staleness is None or self._replica_pick <= 0:
            return None
        addrs = self._replica_addrs[rank] \
            if rank < len(self._replica_addrs) else []
        if not addrs:
            return None
        if time.monotonic() < self._replica_down.get(rank, 0.0):
            return None
        key = (id(table), rank)
        sub = self._replica_subs.get(key)
        if sub is not None:
            return sub
        with self._rlock:
            sub = self._replica_subs.get(key)
            if sub is not None:
                return sub
            c = self._replica_clients.get(rank)
            if c is None:
                idx = min(self._replica_pick, len(addrs)) - 1
                try:
                    c = transport.WireClient(
                        addrs[idx], client=self.client_id,
                        quant=None, deadline_s=self._deadline_s,
                        partition=dict(self._claim))
                except Exception:   # noqa: BLE001 — dead follower:
                    # bench it, reads fall back to the primary
                    self._replica_down[rank] = \
                        time.monotonic() + _REPLICA_RETRY_S
                    _count("fleet.replica.down", rank=rank)
                    return None
                self._replica_clients[rank] = c
            sub = _clone_sub(table.subs[rank], c)
            self._replica_subs[key] = sub
            return sub

    def _replica_served(self, rank: int) -> None:
        _count("fleet.replica.reads", rank=rank)

    def _replica_miss(self, rank: int, *, soft: bool) -> None:
        """A follower read that fell back to the primary. Soft (stale
        refusal) keeps the connection — lag is transient; hard
        (transport fault) benches the follower and drops its client so
        the next probe redials."""
        _count("fleet.replica.fallbacks", rank=rank,
               kind="stale" if soft else "down")
        if soft:
            return
        with self._rlock:
            c = self._replica_clients.pop(rank, None)
            for key in [k for k in self._replica_subs
                        if k[1] == rank]:
                self._replica_subs.pop(key, None)
            self._replica_down[rank] = \
                time.monotonic() + _REPLICA_RETRY_S
        if c is not None:
            try:
                c.abort()
            except Exception:   # noqa: BLE001 — already dead
                pass

    # -- failover ----------------------------------------------------------

    def _guard(self, rank: int, thunk: Any) -> Any:
        """Run a shard request; on a dead-peer fault or a newer-map
        hello refusal, recover the rank (promotion, adoption, or — on
        a shape change — a full re-split, surfaced as ``_Remapped`` so
        the table re-runs the whole op) and re-run it once.
        Application errors pass through untouched — except a reshard
        ``remap`` refusal, which IS the re-split trigger."""
        try:
            return thunk()
        except transport.RemoteError as exc:
            if not self._maybe_remap(exc):
                raise
            raise _Remapped() from exc
        except (_REFUSED,) + _DEAD as exc:
            n0 = self.pmap.n
            if not self._recover(rank, exc):
                raise
            if self.pmap.n != n0 or rank >= len(self.clients):
                raise _Remapped() from exc
            return thunk()

    def _guard_add(self, rank: int, thunk: Any) -> Any:
        """Failover guard for PIPELINED mutations. The failed submit's
        frame already sits in the rank client's pending window, so
        re-running the thunk would double-submit it under a fresh rid;
        the rebind replay is the redelivery — hand back a handle over
        the surviving window instead. A shape-change recovery raises
        ``_Remapped``: the rank may not exist any more, the table
        redistributes the slice."""
        try:
            return thunk()
        except transport.RemoteError as exc:
            if not self._maybe_remap(exc):
                raise
            raise _Remapped() from exc
        except (_REFUSED,) + _DEAD as exc:
            n0 = self.pmap.n
            if not self._recover(rank, exc):
                raise
            if self.pmap.n != n0 or rank >= len(self.clients):
                raise _Remapped() from exc
            c = self.clients[rank]
            rid = c._pending[-1].rid if c._pending else c._acked_rid
            return transport.RemoteHandle(c, rid)

    def _guard_wait(self, rank: int, handle: Any) -> None:
        try:
            handle.wait()
        except transport.RemoteError as exc:
            if not self._maybe_remap(exc):
                raise
            # resharded mid-wait: survivors' windows replayed at the
            # rebind; an evicted rank's acked writes were relayed
        except (_REFUSED,) + _DEAD as exc:
            if not self._recover(rank, exc):
                raise
            if rank >= len(self.clients):
                return
            handle.wait()

    def _guard_drain(self, rank: int) -> None:
        if rank >= len(self.clients):
            return      # evicted mid-wait by a reshard
        try:
            self.clients[rank].drain()
        except transport.RemoteError as exc:
            if not self._maybe_remap(exc):
                raise
        except (_REFUSED,) + _DEAD as exc:
            if not self._recover(rank, exc):
                raise
            if rank >= len(self.clients):
                return
            self.clients[rank].drain()

    # -- elastic fleet (live resharding) ------------------------------------

    def _maybe_remap(self, exc: BaseException) -> bool:
        """True iff ``exc`` is a reshard ``remap`` refusal AND the
        router successfully re-split onto the new map."""
        header = getattr(exc, "header", None) or {}
        wmap = header.get("partition")
        if not header.get("remap") or not isinstance(wmap, dict):
            return False
        return self._restructure(int(wmap.get("version", 0)))

    def _refresh_fleet(self, min_version: int) -> Dict[str, Any]:
        """Re-read the fleet file until it reaches ``min_version``,
        with JITTERED exponential backoff — at a map flip every worker
        of an N-worker fleet lands here at once, and the jitter (seeded
        per client id, so it is deterministic per worker but spread
        across the fleet) keeps them from thundering-herding the file
        while the admin's atomic rewrite is still in flight."""
        if not self._fleet_file:
            raise RuntimeError(
                f"fleet resharded to v{min_version} but this client "
                "was not connected via a fleet file — reconnect with "
                "connect_fleet_file to follow elastic fleets")
        tries = int(os.environ.get(
            "MVTPU_FLEET_REFRESH_TRIES", "") or 12)
        rng = random.Random(zlib.crc32(self.client_id.encode()))
        delay = 0.05
        for attempt in range(tries):
            doc = partition.read_fleet_file(self._fleet_file)
            got = int((doc.get("map") or {}).get("version", 0)) \
                if doc is not None else None
            if got is not None and got >= min_version:
                return doc
            _count("fleet.refresh.retry")
            time.sleep(delay * (0.5 + rng.random()))
            delay = min(delay * 2.0, 1.0)
        raise RuntimeError(
            f"fleet file {self._fleet_file!r} is still at "
            f"v{got} after {tries} re-reads but the fleet serves "
            f"v{min_version}: the reshard's fleet-file flip never "
            "landed (admin crashed mid-commit?) — raise "
            "MVTPU_FLEET_REFRESH_TRIES or re-run the reshard")

    def _restructure(self, min_version: int) -> bool:
        """Swing this router onto a DIFFERENT-SHAPE map (reshard):
        refresh the fleet file, rebind every surviving rank's client
        under the new claim (pending windows replay — the members'
        relay + origin dedup keep that exactly-once), dial joining
        ranks, drop evicted ones, resize the fan-out pool, and
        re-split every fleet table."""
        with self._folock:
            if self.pmap.version >= min_version:
                return True     # raced: another thread re-split first
            doc = self._refresh_fleet(min_version)
            new = partition.PartitionMap.from_wire(doc["map"])
            members = sorted(doc.get("members", []),
                             key=lambda m: int(m.get("rank", 0)))
            addrs = [_pick_addr(m.get("addresses"), self._scheme)
                     for m in members]
            if len(addrs) != new.n or any(a is None for a in addrs):
                raise RuntimeError(
                    f"fleet file {self._fleet_file!r} lists "
                    f"{len(addrs)} member addresses for a map of "
                    f"{new.n}")
            claim = new.to_wire()
            old_n = len(self.clients)
            for r in range(min(old_n, new.n)):
                self.clients[r].rebind(addrs[r],
                                       partition=dict(claim))
            for c in self.clients[new.n:]:
                try:    # evicted member: acked writes were relayed
                    c.abort()
                except Exception:   # noqa: BLE001
                    pass
            self.clients = self.clients[:new.n] + [
                transport.WireClient(
                    addrs[r], client=self.client_id,
                    quant=self._quant,
                    seed=None if self._seed is None
                    else int(self._seed) + r,
                    deadline_s=self._deadline_s,
                    partition=dict(claim))
                for r in range(old_n, new.n)]
            self.pmap = new
            self._claim = claim
            # replica routing: follower sets moved with their ranks
            with self._rlock:
                dead = list(self._replica_clients.values())
                self._replica_clients.clear()
                self._replica_subs.clear()
                self._replica_down.clear()
            for c in dead:
                try:
                    c.abort()
                except Exception:   # noqa: BLE001
                    pass
            self._replica_addrs = self._replica_addrs_from(doc)
            old_pool = self._pool
            self._pool = ThreadPoolExecutor(
                max_workers=new.n, thread_name_prefix="mvtpu-fleet")
            old_pool.shutdown(wait=False)
            for t in self._tables:
                t._resplit()
            _count("fleet.reshard.refresh")
            return True

    def _recover(self, rank: int, exc: BaseException) -> bool:
        """Client half of shard failover. Serialized: concurrent shard
        threads that hit the same dead primary queue here, the first
        one promotes, the rest find the map already bumped and just
        re-run their request against the rebound client. Returns True
        when the rank is routable again."""
        with self._folock:
            start_v = self.pmap.version
            header = getattr(exc, "header", None) or {}
            wmap = header.get("partition")
            if isinstance(wmap, dict) \
                    and int(wmap.get("version", 0)) > start_v:
                if int(wmap.get("n", self.pmap.n)) != self.pmap.n:
                    # the fleet changed SHAPE (reshard), not just
                    # leadership: full re-split, not a rank rebind
                    return self._restructure(
                        int(wmap.get("version", 0)))
                # refused BECAUSE someone already failed over: the
                # refusal carries the new map — adopt, no promote
                return self._adopt_map(wmap, rank)
            doc = partition.read_fleet_file(self._fleet_file) \
                if self._fleet_file else None
            if doc is not None:
                dmap = doc.get("map") or {}
                if int(dmap.get("version", 0)) > start_v:
                    if int(dmap.get("n", self.pmap.n)) \
                            != self.pmap.n:
                        return self._restructure(
                            int(dmap.get("version", 0)))
                    # another worker promoted and rewrote the file
                    return self._adopt_map(dmap, rank, doc=doc)
            if self.pmap.version > start_v:
                return True     # a queued thread behind the promoter
            addrs = self._follower_addrs(rank, doc)
            if not addrs:
                return False
            for addr in addrs:
                try:
                    c = transport.WireClient(
                        addr, client=self.client_id + ".fo",
                        quant=None, deadline_s=None,
                        partition=dict(self._claim))
                except Exception:   # noqa: BLE001 — follower dead too
                    continue
                try:
                    try:
                        h, _ = c.call("promote")
                    finally:
                        try:
                            c.abort()
                        except Exception:   # noqa: BLE001
                            pass
                except _REFUSED as refusal:
                    rh = getattr(refusal, "header", None) or {}
                    wm = rh.get("partition")
                    if isinstance(wm, dict) \
                            and int(wm.get("version", 0)) > start_v:
                        # the follower is ALREADY the new primary
                        return self._adopt_map(wm, rank,
                                               fallback=addr)
                    continue
                except _DEAD:
                    continue
                wm = h.get("partition")
                if isinstance(wm, dict):
                    return self._adopt_map(wm, rank, fallback=addr)
            return False

    def _follower_addrs(self, rank: int,
                        doc: Optional[Dict[str, Any]]) -> List[str]:
        if doc is not None:
            fresh = self._replica_addrs_from(doc)
            if rank < len(fresh) and fresh[rank]:
                return fresh[rank]
        return list(self._replica_addrs[rank]) \
            if rank < len(self._replica_addrs) else []

    def _adopt_map(self, wmap: Dict[str, Any], rank: int,
                   doc: Optional[Dict[str, Any]] = None,
                   fallback: Optional[str] = None) -> bool:
        """Swing the fleet onto a newer map: rebind the dead rank's
        client at its successor (pending window replays there), point
        every future hello at the new claim, and best-effort broadcast
        ``adopt`` so survivors bump before their next refused hello."""
        new = partition.PartitionMap.from_wire(wmap)
        if new.version <= self.pmap.version:
            return True     # lost a race to an even newer adoption
        claim = new.to_wire()
        addr = fallback
        if self._fleet_file:
            d = doc
            if d is None or int((d.get("map") or {})
                                .get("version", -1)) < new.version:
                d = partition.read_fleet_file(self._fleet_file)
            if d is not None and int((d.get("map") or {})
                                     .get("version", -1)) \
                    >= new.version:
                members = sorted(d.get("members", []),
                                 key=lambda m: int(m.get("rank", 0)))
                if rank < len(members):
                    picked = _pick_addr(
                        members[rank].get("addresses"), self._scheme)
                    if picked:
                        addr = picked
                self._replica_addrs = self._replica_addrs_from(d)
        if addr is None:
            return False
        self.pmap = new
        self._claim = claim
        self.clients[rank].rebind(addr, partition=claim)
        for c in self.clients:
            c.partition = dict(claim)
        # this rank's follower read path is void: its follower may BE
        # the new primary; reads route primary until addrs say else
        with self._rlock:
            dead_rc = self._replica_clients.pop(rank, None)
            for key in [k for k in self._replica_subs
                        if k[1] == rank]:
                self._replica_subs.pop(key, None)
        if dead_rc is not None:
            try:
                dead_rc.abort()
            except Exception:   # noqa: BLE001
                pass
        _count("fleet.failover", rank=rank)
        for r, c in enumerate(self.clients):
            if r == rank:
                continue    # the promoted server already holds v+1
            try:
                c.call("adopt", {"map": dict(claim)})
            except Exception:   # noqa: BLE001 — their next refused
                pass            # hello self-heals via err.header
        for c in list(self._replica_clients.values()):
            try:
                c.call("adopt", {"map": dict(claim)})
            except Exception:   # noqa: BLE001
                pass
        return True

    # -- table surface -----------------------------------------------------

    def create_array(self, name: str, size: int, *,
                     dtype: str = "float32",
                     updater: Optional[str] = None,
                     init_value: float = 0) -> FleetArrayTable:
        """Create the GLOBAL table on every member; each instantiates
        only its local slice (rank r holds bounds[r+1]-bounds[r]
        elements) from the same spec."""
        self.pmap.dense_bounds(size)    # validate split up front
        # guarded: creates are idempotent by name server-side, so the
        # post-failover re-run attaches instead of re-building
        subs = self._fanout(
            [lambda c=c, r=r: self._guard(
                r, lambda: c.create_array(name, size, dtype=dtype,
                                          updater=updater,
                                          init_value=init_value))
             for r, c in enumerate(self.clients)])
        table = FleetArrayTable(self, subs, size)
        self._tables.append(table)
        return table

    def create_kv(self, name: str, capacity: int, *, value_dim: int = 0,
                  dtype: str = "float32",
                  updater: Optional[str] = None,
                  tiered: bool = False) -> FleetKVTable:
        subs = self._fanout(
            [lambda c=c, r=r: self._guard(
                r, lambda: c.create_kv(name, capacity,
                                       value_dim=value_dim,
                                       dtype=dtype, updater=updater,
                                       tiered=tiered))
             for r, c in enumerate(self.clients)])
        table = FleetKVTable(self, subs)
        self._tables.append(table)
        return table

    # -- fleet plumbing ----------------------------------------------------

    @property
    def n(self) -> int:
        return self.pmap.n

    def client_for(self, rank: int) -> Any:
        return self.clients[rank]

    def ping(self) -> bool:
        return all(self._fanout([c.ping for c in self.clients]))

    def server_status(self) -> List[Dict[str, Any]]:
        return self._fanout([c.server_status for c in self.clients])

    def drain(self) -> None:
        for rank in range(len(self.clients)):
            self._guard_drain(rank)

    @property
    def tx_bytes(self) -> int:
        return sum(c.tx_bytes for c in self.clients)

    @property
    def rx_bytes(self) -> int:
        return sum(c.rx_bytes for c in self.clients)

    @property
    def sheds(self) -> int:
        return sum(c.sheds for c in self.clients)

    @property
    def reconnects(self) -> int:
        return sum(c.reconnects for c in self.clients)

    def close(self) -> None:
        errors = []
        for c in self.clients:
            try:
                c.close()
            except Exception as exc:    # noqa: BLE001 — close them all
                errors.append(exc)
        with self._rlock:
            rclients = list(self._replica_clients.values())
            self._replica_clients.clear()
            self._replica_subs.clear()
        for c in rclients:
            try:    # read-only connections: nothing pending to drain
                c.abort()
            except Exception:   # noqa: BLE001
                pass
        self._pool.shutdown(wait=False)
        if errors:
            raise errors[0]

    def __enter__(self) -> "FleetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect_fleet(addresses: Sequence[str], *,
                  version: int = 1,
                  kv_buckets: Optional[int] = None,
                  replicas: int = 1,
                  client: Optional[str] = None,
                  quant: Optional[str] = "env",
                  seed: Optional[int] = None,
                  deadline_s="env",
                  replica_addrs: Optional[
                      Sequence[Sequence[str]]] = None,
                  read_replica="env") -> FleetClient:
    """Dial every member of a fleet. ``addresses`` is rank-ordered;
    the map claimed at each hello is ``PartitionMap(len(addresses),
    version, kv_buckets, replicas)`` — member ranks refuse a mismatch.
    ``replica_addrs`` (rank-ordered lists of follower addresses) opts
    bounded-staleness reads into follower routing without a fleet
    file."""
    return FleetClient(addresses, version=version,
                       kv_buckets=kv_buckets, replicas=replicas,
                       client=client, quant=quant, seed=seed,
                       deadline_s=deadline_s,
                       replica_addrs=replica_addrs,
                       read_replica=read_replica)


def fleet_addresses(fleet_file: str,
                    scheme: Optional[str] = None) -> List[str]:
    """Rank-ordered member addresses out of a launcher fleet file;
    ``scheme`` picks a transport ("unix"/"tcp"/"shm") when members
    listen on several, else each member's first address wins."""
    doc = partition.read_fleet_file(fleet_file)
    if doc is None:
        raise FileNotFoundError(
            f"fleet file {fleet_file!r} missing or malformed")
    members = sorted(doc.get("members", []),
                     key=lambda m: int(m.get("rank", 0)))
    out = []
    for m in members:
        picked = _pick_addr(m.get("addresses"), scheme)
        if picked is None:
            raise ValueError(f"fleet member {m.get('rank')} has no "
                             "addresses")
        out.append(picked)
    return out


def replica_addresses(fleet_file: str,
                      scheme: Optional[str] = None
                      ) -> List[List[str]]:
    """Rank-ordered follower address lists out of a launcher fleet
    file (``[]`` for a rank with no followers)."""
    doc = partition.read_fleet_file(fleet_file)
    if doc is None:
        raise FileNotFoundError(
            f"fleet file {fleet_file!r} missing or malformed")
    members = sorted(doc.get("members", []),
                     key=lambda m: int(m.get("rank", 0)))
    out = []
    for m in members:
        out.append([a for a in
                    (_pick_addr(rep.get("addresses"), scheme)
                     for rep in (m.get("replicas") or []))
                    if a])
    return out


def connect_fleet_file(fleet_file: str, *,
                       scheme: Optional[str] = None,
                       client: Optional[str] = None,
                       quant: Optional[str] = "env",
                       seed: Optional[int] = None,
                       deadline_s="env",
                       read_replica="env") -> FleetClient:
    """Dial a fleet straight from its launcher fleet file (addresses,
    the authoritative map, AND the replica sets come from the file —
    keeping the file name around is what arms failover)."""
    doc = partition.read_fleet_file(fleet_file)
    if doc is None:
        raise FileNotFoundError(
            f"fleet file {fleet_file!r} missing or malformed")
    pmap = partition.PartitionMap.from_wire(doc["map"])
    return FleetClient(fleet_addresses(fleet_file, scheme),
                       pmap=pmap, client=client, quant=quant,
                       seed=seed, deadline_s=deadline_s,
                       fleet_file=fleet_file, scheme=scheme,
                       read_replica=read_replica)
