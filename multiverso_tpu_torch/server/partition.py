"""PartitionMap: which server process owns which slice of every table.

Counterpart of ``multiverso_tpu/server/partition.py``: the same maps,
wire form and fleet file, byte for byte. The fleet launcher, live
resharding and the router that use most of it come in ROADMAP queue A
items 11b and 11c; a single server takes its ``PartitionMember`` now.

The reference framework's defining scale shape is a *fleet* of server
processes, each owning a partition of every table, with workers
scattering requests by ownership (`src/server.cpp`: rank r serves the
rows `ProcessGet`/`ProcessAdd` hash to it). This module is that
ownership function for the wire stack: a versioned
:class:`PartitionMap` shared by the launcher, every
:class:`~multiverso_tpu_torch.server.table_server.TableServer` in the fleet,
and the client-side router (:mod:`multiverso_tpu_torch.client.router`).

Ownership is **contiguous blocks**, the same invariant
``tables/hashing.shard_lane_slices`` exploits on-device:

- a dense table of ``size`` elements splits into N contiguous element
  ranges — rank r owns ``[r*size//n, (r+1)*size//n)`` — so a scatter
  is a plain slice and a gather a plain concat, both zero-index-math;
- a KV key hashes (splitmix64, the table layer's own mix) into a
  fleet-wide **logical bucket space** of ``kv_buckets`` buckets
  (fixed at map creation and held FIXED across reshards, so keys
  never re-hash), and rank r owns the contiguous floor-division
  block ``[r*kv_buckets//n, (r+1)*kv_buckets//n)`` — the same split
  rule as the dense bounds, and bit-identical to the historical
  equal-block rule whenever ``kv_buckets % n == 0`` (true for every
  map the launcher ever wrote).

Contiguity is not an aesthetic: it is the substrate live resharding
(:func:`map_diff`) stands on — moving ownership v→v+1 is "reassign a
range, bump ``version``", the moved ranges are closed-form interval
intersections of the old and new bounds, and the version handshake
below is what makes a stale map refuse loudly instead of silently
mis-routing. Every server process checks the client's claimed
``(n, version, kv_buckets)`` at ``hello`` and refuses a mismatch
before any data op flows.

torch-free BY DESIGN (stdlib + numpy + the numpy-only hashing module):
the client router runs in bare worker processes, and the fleet-statusz
scraper runs on the statusz HTTP thread of a possibly-wedged process.
File-path loadable like ``server/wire.py``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

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


hashing = _dep("multiverso_tpu_torch.tables.hashing", "tables", "hashing.py")

#: logical KV bucket space floor. Plenty of granularity for reshard
#: range moves without bloating the map; held fixed across v→v+1 so a
#: grow/shrink never re-hashes keys — only contiguous bucket ranges
#: change hands.
DEFAULT_KV_BUCKETS = 8192

#: hello/statusz wire fields of a partition claim; ``replicas`` joined
#: the geometry in the replication PR, so claims from older routers
#: (no ``replicas`` key) read as the pre-replication default of 1
_WIRE_FIELDS = ("n", "version", "kv_buckets", "replicas")
_WIRE_DEFAULTS = {"replicas": 1}


class PartitionMap:
    """The fleet-wide ownership function (see module docstring).

    Immutable; equality and the ``hello`` handshake compare the full
    ``(n, version, kv_buckets)`` triple — any change to the geometry
    must bump ``version`` (item 3's reshard contract)."""

    __slots__ = ("n", "version", "kv_buckets", "replicas")

    def __init__(self, n: int, *, version: int = 1,
                 kv_buckets: Optional[int] = None,
                 replicas: int = 1) -> None:
        n = int(n)
        if n < 1:
            raise ValueError(f"partition map needs n >= 1, got {n}")
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError(f"partition map needs replicas >= 1, "
                             f"got {replicas}")
        base = int(kv_buckets) if kv_buckets else DEFAULT_KV_BUCKETS
        if base < n:
            base = n
        self.n = n
        self.version = int(version)
        self.replicas = replicas
        # NOT rounded to a multiple of n: ownership is floor-division
        # bounds (kv_bounds), so any kv_buckets >= n splits cleanly —
        # the invariant that lets a reshard keep the bucket space
        # fixed while n changes (keys never re-hash)
        self.kv_buckets = base

    # -- dense ownership ---------------------------------------------------

    def dense_bounds(self, size: int) -> List[int]:
        """N+1 offsets: rank r owns elements [bounds[r], bounds[r+1])
        of a dense table with ``size`` elements. Balanced to within one
        element, covering, disjoint."""
        size = int(size)
        if size < self.n:
            raise ValueError(
                f"dense table of {size} elements cannot split across "
                f"{self.n} servers (every rank must own >= 1 element)")
        return [r * size // self.n for r in range(self.n + 1)]

    def dense_range(self, size: int, rank: int) -> Tuple[int, int]:
        b = self.dense_bounds(size)
        return b[rank], b[rank + 1]

    # -- KV ownership ------------------------------------------------------

    @property
    def buckets_per_rank(self) -> int:
        """Floor of the per-rank bucket share. With floor-division
        bounds ranks may own this or this+1 buckets; kept as the
        capacity-sizing heuristic and for the historical name."""
        return self.kv_buckets // self.n

    def kv_bounds(self) -> List[int]:
        """N+1 offsets into the logical bucket space: rank r owns
        buckets [bounds[r], bounds[r+1]). Same floor-division rule as
        :meth:`dense_bounds` — balanced to within one bucket, covering,
        disjoint, and bit-identical to the historical equal-block rule
        whenever ``kv_buckets % n == 0``."""
        return [r * self.kv_buckets // self.n for r in range(self.n + 1)]

    def kv_bucket(self, keys: np.ndarray) -> np.ndarray:
        """Logical fleet bucket per key (splitmix64 mod kv_buckets) —
        the one hash every router and server must agree on."""
        keys = np.asarray(keys, np.uint64)
        return (hashing._hash_u64(keys)
                % np.uint64(self.kv_buckets)).astype(np.int64)

    def kv_owner(self, keys: np.ndarray) -> np.ndarray:
        """Owning rank per key: searchsorted over the contiguous
        bucket bounds (identical to ``bucket // buckets_per_rank``
        when the space divides evenly)."""
        bounds = np.asarray(self.kv_bounds()[1:], np.int64)
        return np.searchsorted(bounds, self.kv_bucket(keys),
                               side="right").astype(np.int64)

    def bucket_range(self, rank: int) -> Tuple[int, int]:
        b = self.kv_bounds()
        return b[rank], b[rank + 1]

    # -- wire form ---------------------------------------------------------

    def to_wire(self) -> Dict[str, int]:
        return {"n": self.n, "version": self.version,
                "kv_buckets": self.kv_buckets,
                "replicas": self.replicas}

    @classmethod
    def from_wire(cls, doc: Dict[str, Any]) -> "PartitionMap":
        return cls(int(doc["n"]), version=int(doc.get("version", 1)),
                   kv_buckets=int(doc["kv_buckets"]),
                   replicas=int(doc.get("replicas", 1)))

    def mismatch(self, claim: Optional[Dict[str, Any]]) -> Optional[str]:
        """None when ``claim`` (a to_wire dict off the hello header)
        names this exact map, else the human-readable refusal."""
        if not isinstance(claim, dict):
            return f"partition claim is not a map: {claim!r}"
        theirs = tuple(claim.get(k, _WIRE_DEFAULTS.get(k))
                       for k in _WIRE_FIELDS)
        ours = tuple(getattr(self, k) for k in _WIRE_FIELDS)
        if theirs != ours:
            return ("partition map mismatch: server has "
                    f"{dict(zip(_WIRE_FIELDS, ours))}, client claims "
                    f"{dict(zip(_WIRE_FIELDS, theirs))}")
        return None

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, PartitionMap) \
            and other.to_wire() == self.to_wire()

    def __repr__(self) -> str:
        return (f"PartitionMap(n={self.n}, version={self.version}, "
                f"kv_buckets={self.kv_buckets})")


class PartitionMember:
    """One rank's view of the map: what THIS server process owns."""

    __slots__ = ("map", "rank")

    def __init__(self, pmap: PartitionMap, rank: int) -> None:
        rank = int(rank)
        if not 0 <= rank < pmap.n:
            raise ValueError(f"rank {rank} outside fleet of {pmap.n}")
        self.map = pmap
        self.rank = rank

    def dense_range(self, size: int) -> Tuple[int, int]:
        return self.map.dense_range(size, self.rank)

    def local_dense_size(self, size: int) -> int:
        lo, hi = self.dense_range(size)
        return hi - lo

    def bucket_range(self) -> Tuple[int, int]:
        return self.map.bucket_range(self.rank)

    def local_kv_capacity(self, capacity: int) -> int:
        """This rank's slot budget: the global capacity split by owned
        bucket share (ceil — a shard must never hold fewer slots than
        its share of keys; KVTable rounds its bucket count up anyway).
        Identical to ``ceil(capacity / n)`` when the bucket space
        divides evenly."""
        lo, hi = self.bucket_range()
        return max(-(-int(capacity) * (hi - lo) // self.map.kv_buckets),
                   1)

    def describe(self) -> Dict[str, Any]:
        lo, hi = self.bucket_range()
        return {"rank": self.rank, "buckets": [lo, hi],
                **self.map.to_wire()}

    def __repr__(self) -> str:
        return f"PartitionMember(rank={self.rank}, map={self.map!r})"


# -- reshard diff ----------------------------------------------------------
#
# What moves on a map change v→v+1 is computable in closed form: both
# dense ranges and KV bucket ranges are contiguous floor-division
# splits, so the moved set per (donor, recipient) pair is the interval
# intersection of the old and new bounds — segments whose old owner
# differs from their new owner. Migration cost is therefore
# proportional to MOVED bytes, never table bytes: growing N→N+1 moves
# ~1/(N+1) of each table, shrinking moves the evicted rank's share.


def _bound_moves(old_bounds: List[int],
                 new_bounds: List[int]) -> List[Tuple[int, int, int, int]]:
    """``(donor, recipient, lo, hi)`` segments where ownership changes
    between two bounds lists over the same total span. Closed form:
    split the span at every old/new boundary; each piece has exactly
    one old owner and one new owner."""
    if old_bounds[-1] != new_bounds[-1] or old_bounds[0] != new_bounds[0]:
        raise ValueError(
            "bounds cover different spans: "
            f"{old_bounds[0]}..{old_bounds[-1]} vs "
            f"{new_bounds[0]}..{new_bounds[-1]}")
    import bisect
    edges = sorted(set(old_bounds) | set(new_bounds))
    moves = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        donor = bisect.bisect_right(old_bounds, lo) - 1
        rcpt = bisect.bisect_right(new_bounds, lo) - 1
        if donor != rcpt:
            moves.append((donor, rcpt, lo, hi))
    return moves


class MapDiff:
    """The exact moved ranges of a reshard ``old``→``new``.

    ``bucket_moves`` is the list of ``(donor, recipient, lo, hi)``
    logical-KV-bucket segments changing hands; :meth:`dense_moves`
    computes the element-range counterpart for a dense table of a
    given size. Both are disjoint, covering exactly the moved set."""

    __slots__ = ("old", "new", "bucket_moves")

    def __init__(self, old: PartitionMap, new: PartitionMap) -> None:
        if new.kv_buckets != old.kv_buckets:
            raise ValueError(
                "reshard must keep the logical bucket space fixed "
                f"(old kv_buckets={old.kv_buckets}, new "
                f"{new.kv_buckets}) — changing it re-hashes every key")
        if new.version <= old.version:
            raise ValueError(
                f"reshard must bump the map version (old "
                f"{old.version}, new {new.version})")
        self.old = old
        self.new = new
        self.bucket_moves = _bound_moves(old.kv_bounds(), new.kv_bounds())

    def dense_moves(self, size: int) -> List[Tuple[int, int, int, int]]:
        """``(donor, recipient, lo, hi)`` GLOBAL element ranges of a
        dense table of ``size`` elements that change hands."""
        return _bound_moves(self.old.dense_bounds(size),
                            self.new.dense_bounds(size))

    def moved_buckets(self) -> int:
        return sum(hi - lo for _, _, lo, hi in self.bucket_moves)

    def moved_dense(self, size: int) -> int:
        return sum(hi - lo for _, _, lo, hi in self.dense_moves(size))

    def donor_ranks(self) -> List[int]:
        """Ranks that ship at least one range. Size-free: evaluated on
        a synthetic large dense size (the floor-division rule makes
        the donor set scale-invariant above ~n² elements) plus the
        bucket moves."""
        big = max(self.old.n, self.new.n) << 20
        out = set(d for d, _, _, _ in self.dense_moves(big))
        out.update(d for d, _, _, _ in self.bucket_moves)
        return sorted(out)


def map_diff(old: PartitionMap, new: PartitionMap) -> MapDiff:
    """The exact moved element/bucket ranges of a reshard — see
    :class:`MapDiff`."""
    return MapDiff(old, new)


# -- fleet file ------------------------------------------------------------
#
# The launcher (``python -m multiverso_tpu_torch.server --fleet N``) writes
# one JSON document after every member reports ready; members read it
# LAZILY (first /statusz?fleet=1 scrape) so startup has no ordering
# cycle. Shape:
#
#   {"kind": "mvtpu.fleet.v1",
#    "map": {n, version, kv_buckets, replicas},
#    "members": [{"rank", "name", "addresses": [...],
#                 "statusz_port": int|null, "pid": int,
#                 "replicas": [{"idx", "name", "addresses": [...],
#                               "statusz_port": int|null, "pid": int},
#                              ...]},
#                ...]}
#
# ``replicas`` lists rank r's FOLLOWER processes (``--replicas R``
# spawns R-1 of them per rank); a follower promotion rewrites the doc
# through :func:`promote_in_doc` — the promoted follower becomes the
# member row and the map version bumps, so routers that re-read the
# file route to the new primary while stale claims refuse at hello.

FLEET_FILE_KIND = "mvtpu.fleet.v1"


def write_fleet_file(path: str, pmap: PartitionMap,
                     members: List[Dict[str, Any]]) -> None:
    doc = {"kind": FLEET_FILE_KIND, "map": pmap.to_wire(),
           "members": members}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def read_fleet_file(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("kind") != FLEET_FILE_KIND:
        return None
    return doc


def promote_in_doc(doc: Dict[str, Any], rank: int,
                   idx: int) -> Dict[str, Any]:
    """A fleet doc after follower ``idx`` of ``rank`` is promoted to
    primary: the follower's row replaces the member row, it leaves the
    replica list, and the map version bumps v→v+1 (stale routers now
    refuse at hello and refresh). Pure function — the caller owns the
    atomic rewrite through :func:`write_fleet_file`."""
    out = json.loads(json.dumps(doc))
    m = out.setdefault("map", {})
    m["version"] = int(m.get("version", 1)) + 1
    for member in out.get("members", []):
        if member.get("rank") != rank:
            continue
        reps = member.get("replicas") or []
        rep = next((r for r in reps if r.get("idx") == idx), None)
        if rep is not None:
            member["name"] = rep.get("name", member.get("name"))
            member["addresses"] = rep.get("addresses",
                                          member.get("addresses"))
            member["statusz_port"] = rep.get("statusz_port")
            member["pid"] = rep.get("pid")
            member["promoted_from"] = idx
        member["replicas"] = [r for r in reps if r.get("idx") != idx]
    return out


# -- fleet-aggregated introspection ----------------------------------------

def fleet_members(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every member row of a fleet-file document: each rank's primary,
    then its followers (a follower's row gets its rank's ``rank``). The
    fleet's scrapers (``report --fleet``, ``FleetController``) walk
    these, so a follower's registry and knobs count with its
    primary's."""
    out: List[Dict[str, Any]] = []
    for m in doc.get("members", []):
        out.append(m)
        for rep in m.get("replicas") or []:
            out.append(dict(rep, rank=m.get("rank")))
    return out


def member_summary(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-partition digest of one member's /statusz document: the
    owned row/bucket ranges, queue depth, and fuse/admission counters
    — the fields an operator triages a lopsided fleet with."""
    out = []
    transport = doc.get("transport") or {}
    for row in transport.get("servers") or []:
        part = row.get("partition")
        if not part:
            continue
        adm = row.get("admission") or {}
        queue = adm.get("queue") or {}
        out.append({
            "server": row.get("name"),
            "address": row.get("address"),
            "rank": part.get("rank"),
            "map": {k: part.get(k) for k in _WIRE_FIELDS},
            "tables": part.get("tables"),
            "ops": row.get("ops"),
            "queued": row.get("queued"),
            "queue_bound": queue.get("bound"),
            "fused": row.get("fused"),
            "admission": {"shed": adm.get("shed"),
                          "expired": adm.get("expired"),
                          "degraded": adm.get("degraded")},
        })
    return out


def fleet_status(fleet_file: str, *, self_rank: Optional[int] = None,
                 self_doc: Optional[Dict[str, Any]] = None,
                 timeout: float = 2.0) -> Dict[str, Any]:
    """Aggregate the whole fleet's partition state by scraping each
    member's statusz port (``/statusz?fleet=1`` serves this). A dead
    or portless peer degrades to an ``error`` entry — introspecting a
    half-up fleet is exactly when this matters."""
    import urllib.request
    doc = read_fleet_file(fleet_file)
    if doc is None:
        return {"kind": "mvtpu.statusz.fleet.v1", "error":
                f"fleet file {fleet_file!r} missing or malformed",
                "partitions": []}
    partitions: List[Dict[str, Any]] = []
    for member in doc.get("members", []):
        rank = member.get("rank")
        entry: Dict[str, Any] = {"rank": rank,
                                 "name": member.get("name"),
                                 "pid": member.get("pid")}
        if self_rank is not None and rank == self_rank \
                and self_doc is not None:
            entry["partitions"] = member_summary(self_doc)
            partitions.append(entry)
            continue
        port = member.get("statusz_port")
        if not port:
            entry["error"] = "member has no statusz port"
            partitions.append(entry)
            continue
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/statusz",
                    timeout=timeout) as r:
                peer = json.loads(r.read())
            entry["partitions"] = member_summary(peer)
        except Exception as exc:    # noqa: BLE001 — a dead peer is data
            entry["error"] = f"{type(exc).__name__}: {exc}"
        partitions.append(entry)
    return {"kind": "mvtpu.statusz.fleet.v1", "map": doc.get("map"),
            "fleet_file": fleet_file, "partitions": partitions}
