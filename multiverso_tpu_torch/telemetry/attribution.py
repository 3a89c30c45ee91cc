"""Usage attribution: WHO is hitting each shard, and WHERE it lands.

Counterpart of ``multiverso_tpu/telemetry/attribution.py``, copied.

Bounded-memory heavy-hitter accounting for the server dispatch path.
Three structures, all O(K)/O(table-independent) memory no matter how
many distinct clients show up:

- :class:`SpaceSaving` — the classic top-K sketch (Metwally et al.):
  at most ``K`` tracked keys; an untracked arrival evicts the minimum
  and inherits its count as its error term. Guarantees for every
  reported key: ``true <= est`` and ``est - err <= true``, with
  ``err <= N / K`` (N = total stream weight) — tight enough to name
  a flooder with K=32.
- :class:`CountMin` — a small count-min backing sketch so ANY key
  (top-K or not) answers a point estimate; also the cross-check the
  merge path uses.
- :class:`Heat` — a per-table load histogram over the table's OWN
  key space: contiguous element ranges for dense tables, splitmix64
  kv-bucket ranges for KV tables — the exact spaces
  :class:`server.partition.PartitionMap` splits on, so each fleet
  member's heat vector covers its owned range and the fleet view is
  the concatenation, aligned rank by rank: the load input of the
  "what moves" resharding math.

One :class:`AttributionPlane` per process aggregates all three per
(client_id, table, op) across the dimensions ``ops`` / ``bytes`` /
``queue_ms`` / ``sheds``. All sketches MERGE with preserved error
bounds (:func:`merge_topk`), so the fleet view is a merge of member
``/topk`` documents, not a second accounting system.

Arming: ``MVTPU_TOPK_K`` sets sketch capacity (default 32; 0 disables
the whole plane — the kill switch the attributed-vs-unattributed
bench lane flips). ``MVTPU_TOPK_HEAT`` sets heat buckets per table
range (default 16). Pure stdlib, no torch, no numpy — importable from
statusz and the report CLI.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

TOPK_KIND = "mvtpu.topk.v1"

DIMS = ("ops", "bytes", "queue_ms", "sheds")
DEFAULT_K = 32
DEFAULT_HEAT_BUCKETS = 16
_CM_DEPTH = 4
_CM_WIDTH = 512


class SpaceSaving:
    """Top-K heavy hitters with per-key deterministic error bounds.
    NOT internally locked — the owning plane serializes access."""

    __slots__ = ("k", "_counts")

    def __init__(self, k: int = DEFAULT_K) -> None:
        if k < 1:
            raise ValueError(f"SpaceSaving: k={k} must be >= 1")
        self.k = int(k)
        self._counts: Dict[Any, List[float]] = {}   # key -> [est, err]

    def add(self, key: Any, weight: float = 1.0) -> None:
        if weight <= 0:
            return
        cell = self._counts.get(key)
        if cell is not None:
            cell[0] += weight
        elif len(self._counts) < self.k:
            self._counts[key] = [weight, 0.0]
        else:
            mkey = min(self._counts, key=lambda x: self._counts[x][0])
            mcount = self._counts.pop(mkey)[0]
            self._counts[key] = [mcount + weight, mcount]

    @property
    def min_count(self) -> float:
        """The eviction floor: 0 until the sketch fills, then the
        smallest tracked estimate — the worst-case count of any key
        the sketch is NOT tracking."""
        if len(self._counts) < self.k:
            return 0.0
        return min(c[0] for c in self._counts.values())

    def estimate(self, key: Any) -> float:
        cell = self._counts.get(key)
        return cell[0] if cell is not None else self.min_count

    def top(self, n: Optional[int] = None
            ) -> List[Tuple[Any, float, float]]:
        """``(key, estimate, error)`` descending by estimate."""
        rows = sorted(((k, c[0], c[1])
                       for k, c in self._counts.items()),
                      key=lambda r: (-r[1], str(r[0])))
        return rows[:n] if n is not None else rows

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        """Bound-preserving merge: a key absent from one side gets
        that side's eviction floor as both estimate and error (it may
        have been evicted there with up to that count), then the union
        truncates back to K by estimate."""
        out = SpaceSaving(max(self.k, other.k))
        ma, mb = self.min_count, other.min_count
        union = set(self._counts) | set(other._counts)
        rows = []
        for key in union:
            ca = self._counts.get(key)
            cb = other._counts.get(key)
            est = (ca[0] if ca else ma) + (cb[0] if cb else mb)
            err = (ca[1] if ca else ma) + (cb[1] if cb else mb)
            rows.append((key, est, err))
        rows.sort(key=lambda r: (-r[1], str(r[0])))
        for key, est, err in rows[:out.k]:
            out._counts[key] = [est, err]
        return out


@functools.lru_cache(maxsize=4096)
def _cm_rows(key: str) -> Tuple[int, ...]:
    """Deterministic cross-process hash rows (blake2b, salted per
    depth) — every member of a fleet indexes identical cells, so
    count-min merge is elementwise addition. Cached: the dispatch
    loop hits the same (client, table, op) keys endlessly, and a
    digest per sketch add is the single biggest cost of the plane."""
    h = hashlib.blake2b(key.encode(), digest_size=_CM_DEPTH * 4)
    d = h.digest()
    return tuple(int.from_bytes(d[i * 4:(i + 1) * 4], "little")
                 % _CM_WIDTH for i in range(_CM_DEPTH))


class CountMin:
    """Fixed 4x512 count-min sketch: point estimates for EVERY key
    ever seen (overestimate-only), mergeable by cell addition."""

    __slots__ = ("cells", "total")

    def __init__(self) -> None:
        self.cells = [[0.0] * _CM_WIDTH for _ in range(_CM_DEPTH)]
        self.total = 0.0

    def add(self, key: str, weight: float = 1.0) -> None:
        if weight <= 0:
            return
        for row, col in enumerate(_cm_rows(key)):
            self.cells[row][col] += weight
        self.total += weight

    def estimate(self, key: str) -> float:
        return min(self.cells[row][col]
                   for row, col in enumerate(_cm_rows(key)))

    def merge(self, other: "CountMin") -> "CountMin":
        out = CountMin()
        for r in range(_CM_DEPTH):
            a, b = self.cells[r], other.cells[r]
            out.cells[r] = [x + y for x, y in zip(a, b)]
        out.total = self.total + other.total
        return out


class Heat:
    """Load histogram over one table's contiguous key range
    ``[lo, hi)`` in its partitioning space (``element`` for dense
    tables, ``bucket`` for KV tables — the splitmix64 buckets
    ``PartitionMap.kv_bucket`` routes on)."""

    __slots__ = ("space", "lo", "hi", "buckets", "counts")

    def __init__(self, space: str, lo: int, hi: int,
                 buckets: int = DEFAULT_HEAT_BUCKETS) -> None:
        self.space = space
        self.lo = int(lo)
        self.hi = max(int(hi), self.lo + 1)
        self.buckets = max(min(int(buckets), self.hi - self.lo), 1)
        self.counts = [0.0] * self.buckets

    def _index(self, pos: int) -> int:
        span = self.hi - self.lo
        i = (int(pos) - self.lo) * self.buckets // span
        return min(max(i, 0), self.buckets - 1)

    def touch_span(self, lo: int, hi: int, weight: float = 1.0) -> None:
        """Attribute ``weight`` spread across the overlap of
        ``[lo, hi)`` with the owned range, proportionally per heat
        bucket — a whole-table dense add warms every bucket evenly, a
        point write warms one."""
        lo = max(int(lo), self.lo)
        hi = min(int(hi), self.hi)
        if hi <= lo or weight <= 0:
            return
        b0, b1 = self._index(lo), self._index(hi - 1)
        if b0 == b1:
            self.counts[b0] += weight
            return
        span = hi - lo
        bucket_w = (self.hi - self.lo) / self.buckets
        for b in range(b0, b1 + 1):
            seg_lo = max(lo, self.lo + b * bucket_w)
            seg_hi = min(hi, self.lo + (b + 1) * bucket_w)
            if seg_hi > seg_lo:
                self.counts[b] += weight * (seg_hi - seg_lo) / span

    def touch_positions(self, positions: Iterable[int],
                        weight: float = 1.0) -> None:
        for p in positions:
            p = int(p)
            if self.lo <= p < self.hi:
                self.counts[self._index(p)] += weight

    def to_doc(self) -> dict:
        return {"space": self.space, "lo": self.lo, "hi": self.hi,
                "counts": [round(c, 3) for c in self.counts],
                "total": round(sum(self.counts), 3)}


def key_str(client: str, table: str, op: str) -> str:
    return f"{client}|{table}|{op}"


def split_key(key: str) -> Tuple[str, str, str]:
    parts = key.split("|", 2)
    while len(parts) < 3:
        parts.append("")
    return parts[0], parts[1], parts[2]


class AttributionPlane:
    """The per-process accounting: one (SpaceSaving, CountMin) pair
    per dimension plus per-table heat. One lock; every hot-path call
    is a couple of dict operations — cheap enough for
    ``_dispatch_loop`` unconditionally."""

    def __init__(self, k: int = DEFAULT_K,
                 heat_buckets: int = DEFAULT_HEAT_BUCKETS) -> None:
        self.k = int(k)
        self.heat_buckets = int(heat_buckets)
        self._lock = threading.Lock()
        self._sketch = {d: SpaceSaving(self.k) for d in DIMS}
        self._cm = {d: CountMin() for d in DIMS}
        self._heat: Dict[str, Heat] = {}

    # -- hot path ----------------------------------------------------

    def record(self, client: str, table: str, op: str, *,
               n_bytes: int = 0, queue_ms: float = 0.0) -> None:
        key = key_str(client, table, op)
        with self._lock:
            self._sketch["ops"].add(key, 1.0)
            self._cm["ops"].add(key, 1.0)
            if n_bytes > 0:
                self._sketch["bytes"].add(key, float(n_bytes))
                self._cm["bytes"].add(key, float(n_bytes))
            if queue_ms > 0:
                self._sketch["queue_ms"].add(key, float(queue_ms))
                self._cm["queue_ms"].add(key, float(queue_ms))

    def shed(self, client: str, table: str, op: str) -> None:
        key = key_str(client, table, op)
        with self._lock:
            self._sketch["sheds"].add(key, 1.0)
            self._cm["sheds"].add(key, 1.0)

    def heat(self, table: str, space: str, lo: int, hi: int) -> Heat:
        """The (lazily created) heat vector for ``table`` over its
        owned ``[lo, hi)`` range. Space/range changes (resharding)
        replace the vector — stale heat over a range this member no
        longer owns is worse than a cold start."""
        with self._lock:
            h = self._heat.get(table)
            if (h is None or h.space != space or h.lo != lo
                    or h.hi != hi):
                h = Heat(space, lo, hi, self.heat_buckets)
                self._heat[table] = h
            return h

    # -- queries -----------------------------------------------------

    def top(self, dim: str = "ops", n: Optional[int] = None
            ) -> List[Tuple[str, float, float]]:
        with self._lock:
            return self._sketch[dim].top(n)

    def estimate(self, dim: str, client: str, table: str,
                 op: str) -> float:
        """Count-min point estimate (any key, tracked or not)."""
        with self._lock:
            return self._cm[dim].estimate(key_str(client, table, op))

    def topk_doc(self, n: Optional[int] = None) -> dict:
        """The ``/topk`` document (kind ``mvtpu.topk.v1``): per-dim
        ranked talkers with error bars + eviction floor (what the
        merge needs to keep bounds honest) + per-table heat."""
        with self._lock:
            dims = {}
            for d in DIMS:
                sk = self._sketch[d]
                dims[d] = {
                    "total": round(self._cm[d].total, 3),
                    "min_count": round(sk.min_count, 3),
                    "k": sk.k,
                    "top": [
                        {"client": split_key(k)[0],
                         "table": split_key(k)[1],
                         "op": split_key(k)[2],
                         "estimate": round(est, 3),
                         "error": round(err, 3)}
                        for k, est, err in sk.top(n)],
                }
            heat = {t: h.to_doc() for t, h in self._heat.items()}
        return {"kind": TOPK_KIND, "ts": time.time(),
                "pid": os.getpid(), "k": self.k, "dims": dims,
                "heat": heat}


def merge_topk(docs: Sequence[dict]) -> dict:
    """Merge member ``mvtpu.topk.v1`` documents into the fleet view
    with the same bound-preserving algebra as
    :meth:`SpaceSaving.merge`: a key a member does not report gets
    that member's eviction floor as both estimate and error. Heat
    vectors are NOT summed — each member reports heat over its OWN
    owned range, so the fleet heat for a table is the per-member list
    (sorted by range start), ready to lay side by side as one strip."""
    if not docs:
        raise ValueError("merge_topk: no documents")
    for d in docs:
        if d.get("kind") != TOPK_KIND:
            raise ValueError("merge_topk: expected kind="
                             f"{TOPK_KIND!r}, got {d.get('kind')!r}")
    out = {"kind": TOPK_KIND, "ts": max(d.get("ts", 0) for d in docs),
           "members": len(docs),
           "k": max(int(d.get("k", DEFAULT_K)) for d in docs),
           "dims": {}, "heat": {}}
    for dim in DIMS:
        entries: Dict[str, List[float]] = {}
        floors = []
        total = 0.0
        kcap = 1
        per_member: List[Dict[str, Tuple[float, float]]] = []
        for d in docs:
            dd = d.get("dims", {}).get(dim) or {}
            floors.append(float(dd.get("min_count", 0.0)))
            total += float(dd.get("total", 0.0))
            kcap = max(kcap, int(dd.get("k", DEFAULT_K)))
            per_member.append({
                key_str(r.get("client", ""), r.get("table", ""),
                        r.get("op", "")):
                (float(r.get("estimate", 0.0)),
                 float(r.get("error", 0.0)))
                for r in dd.get("top", [])})
        for m in per_member:
            for key in m:
                entries.setdefault(key, [0.0, 0.0])
        for key, cell in entries.items():
            for i, m in enumerate(per_member):
                est, err = m.get(key, (floors[i], floors[i]))
                cell[0] += est
                cell[1] += err
        rows = sorted(((k, c[0], c[1]) for k, c in entries.items()),
                      key=lambda r: (-r[1], r[0]))[:kcap]
        out["dims"][dim] = {
            "total": round(total, 3),
            "min_count": round(sum(floors), 3),
            "k": kcap,
            "top": [{"client": split_key(k)[0],
                     "table": split_key(k)[1],
                     "op": split_key(k)[2],
                     "estimate": round(est, 3),
                     "error": round(err, 3)}
                    for k, est, err in rows]}
    for i, d in enumerate(docs):
        for table, h in d.get("heat", {}).items():
            part = dict(h)
            part["member"] = i
            out["heat"].setdefault(table, []).append(part)
    for parts in out["heat"].values():
        parts.sort(key=lambda p: (p.get("lo", 0), p.get("member", 0)))
    return out


_LOCK = threading.Lock()
_DISABLED = object()
_STATE: Any = None


def plane() -> Optional[AttributionPlane]:
    """The process-wide plane, or None when killed
    (``MVTPU_TOPK_K=0`` — the A/B overhead lane's switch)."""
    global _STATE
    if _STATE is _DISABLED:
        return None
    if _STATE is not None:
        return _STATE
    with _LOCK:
        if _STATE is None:
            try:
                from multiverso_tpu_torch.control import knobs as _knobs
                k = int(_knobs.initial("attribution.topk_k",
                                       DEFAULT_K))
                hb = int(_knobs.initial("attribution.heat_buckets",
                                        DEFAULT_HEAT_BUCKETS))
            except Exception:   # noqa: BLE001 — knob table optional
                k = int(os.environ.get("MVTPU_TOPK_K", DEFAULT_K)
                        or DEFAULT_K)
                hb = int(os.environ.get("MVTPU_TOPK_HEAT",
                                        DEFAULT_HEAT_BUCKETS)
                         or DEFAULT_HEAT_BUCKETS)
            _STATE = (_DISABLED if k <= 0
                      else AttributionPlane(k, heat_buckets=hb))
    return None if _STATE is _DISABLED else _STATE


def _reset_for_tests() -> None:
    global _STATE
    with _LOCK:
        _STATE = None
