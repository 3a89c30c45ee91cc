"""TierManager: placement bookkeeping + promotion/demotion policy for
one tiered KV table.

Counterpart of ``multiverso_tpu/storage/manager.py``: the same policy,
the same float32 scores and so the same placement (victims, fills,
``slot_of``, ``bucket_at``, ``tier``) for the same op history.

The manager owns WHERE every logical bucket lives — device slot, host
arena row, disk slot, or nowhere yet ("virgin": a bucket no add ever
touched is all-empty by construction and costs no IO to materialize —
cold start is free). It never touches device memory itself: the owning
:class:`~multiverso_tpu_torch.storage.tiered_kv.TieredKVTable` runs the
gathers and scatters on its dispatch thread and drives the manager
through ``plan → demote* → fetch/assign*`` (see ``_ensure_resident``
there), so placement mutations inherit the table's threading contract.

Victim selection is telemetry-driven: each bucket carries an access
EWMA (the shared :func:`multiverso_tpu_torch.telemetry.health.ewma_step`
window rule, float32, decayed lazily — idle buckets pay nothing per op)
and the coldest resident bucket outside the current batch is demoted
first; the same scores pick which warm bucket spills when the host arena
fills (the first of the coldest in the arena's insertion order, as the
reference's ``argmin`` over its dict picks it).

Telemetry (all labeled ``table=<name>``):
``storage.hits{tier=device}``, ``storage.misses{tier=host|disk|virgin}``,
``storage.fills{tier=...}``/``storage.promotions{tier=...}`` (same
event, both names), ``storage.demotions{tier=host|disk}``,
``storage.spills`` and ``storage.bytes{dir=spill|fill,tier=disk}`` (from
the disk tier), plus the status rows of :func:`status_all`.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import tempfile
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.control import knobs as _knobs
from multiverso_tpu_torch.storage.tiers import (BucketRecord, DiskTier,
                                                HostTier, RecordSpec)
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry.health import ewma_step
from multiverso_tpu_torch.utils import log

# tier codes, also what tiered checkpoints record per bucket
TIER_DEVICE = 0
TIER_HOST = 1
TIER_DISK = 2
TIER_VIRGIN = 3

TIER_NAMES = {TIER_DEVICE: "device", TIER_HOST: "host",
              TIER_DISK: "disk", TIER_VIRGIN: "virgin"}

# env knobs (the reference's names)
TIER_DEVICE_ENV = "MVTPU_TIER_DEVICE_BUCKETS"
TIER_HOST_ENV = "MVTPU_TIER_HOST_BUCKETS"
TIER_DIR_ENV = "MVTPU_TIER_DIR"
TIER_ALPHA_ENV = "MVTPU_TIER_ALPHA"

_MANAGERS: "weakref.WeakSet" = weakref.WeakSet()


def _knob_int(name: str, default: int) -> int:
    """Env-seeded knob read with the tier layer's forgiving error
    handling (a malformed env var degrades to the default, it does not
    kill table construction)."""
    try:
        return int(_knobs.initial(name, default))
    except ValueError as e:
        log.warn("%s; using %d", e, default)
        return default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warn("ignoring non-float %s=%r", name, raw)
        return default


@dataclasses.dataclass
class TierConfig:
    """Budgets + policy knobs for one tiered table. ``from_env`` reads the
    ``MVTPU_TIER_*`` environment, with explicit arguments taking
    precedence. The default spill directory is ``mvtpu_tiers`` under the
    process's temporary directory (``TMPDIR``, else ``/tmp``)."""
    device_buckets: int
    host_buckets: int
    spill_dir: str
    alpha: float = 0.25

    @classmethod
    def from_env(cls, total_buckets: int,
                 device_buckets: Optional[int] = None,
                 host_buckets: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 alpha: Optional[float] = None) -> "TierConfig":
        if device_buckets is None:
            device_buckets = _knob_int("storage.device_buckets",
                                       total_buckets)
        if host_buckets is None:
            host_buckets = _knob_int("storage.host_buckets",
                                     max(total_buckets // 4, 1))
        if spill_dir is None:
            spill_dir = os.environ.get(TIER_DIR_ENV, "").strip() \
                or os.path.join(tempfile.gettempdir(), "mvtpu_tiers")
        if alpha is None:
            alpha = _env_float(TIER_ALPHA_ENV, 0.25)
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"tier EWMA alpha {alpha} outside (0, 1]")
        return cls(device_buckets=int(device_buckets),
                   host_buckets=int(host_buckets),
                   spill_dir=spill_dir, alpha=float(alpha))


@dataclasses.dataclass
class ResidencyPlan:
    """What one batch needs moved: demote ``victims`` (device →
    host/disk cascade), then fill ``fills`` into the freed/free slots."""
    victims: np.ndarray   # logical bucket ids currently device-resident
    fills: np.ndarray     # logical bucket ids to fault in


class TierManager:
    """Placement state machine for ``total_buckets`` logical buckets over
    a ``device_buckets``-slot device tier, a host arena, and a disk spill
    file. ``pin_memory`` backs the host arena with pinned memory (a table
    on a card)."""

    def __init__(self, name: str, total_buckets: int,
                 config: TierConfig, spec: RecordSpec, *,
                 pin_memory: bool = False) -> None:
        if config.device_buckets <= 0:
            raise ValueError(
                f"device budget {config.device_buckets} buckets <= 0")
        self.name = name
        self.total_buckets = int(total_buckets)
        self.device_buckets = min(int(config.device_buckets),
                                  self.total_buckets)
        # the physical slot count above is frozen at construction (the
        # arrays below are sized by it); the control plane moves a soft
        # BUDGET underneath it — plan() evicts down to the budget, never
        # past the batch's own working set
        self.device_budget = self.device_buckets
        _knobs.bind("storage.device_buckets", self, "device_budget",
                    label=name)
        self.config = config
        self.spec = spec
        self.tier = np.full(self.total_buckets, TIER_VIRGIN, np.int8)
        self.slot_of = np.full(self.total_buckets, -1, np.int32)
        self.bucket_at = np.full(self.device_buckets, -1, np.int64)
        self._slot_used = np.zeros(self.device_buckets, bool)
        self._free_slots: List[int] = list(
            range(self.device_buckets - 1, -1, -1))
        self.host = HostTier(config.host_buckets, spec,
                             pin_memory=pin_memory)
        spill_path = os.path.join(config.spill_dir, f"{name}.spill")
        for other in list(_MANAGERS):
            if getattr(other.disk, "path", None) == spill_path:
                # two LIVE tables writing one spill file silently corrupt
                # each other; a restart reusing the dead table's path is
                # fine (load() rewrites the file)
                log.warn(
                    "tier manager %r: spill path %s is already in use "
                    "by a live manager — give one table a distinct "
                    "name or spill_dir", name, spill_path)
        self.disk = DiskTier(spill_path, spec)
        self.alpha = config.alpha
        # per-bucket access EWMA, decayed lazily: score[b] is exact as of
        # stamp[b]; the effective score at clock t is
        # score * (1-alpha)^(t-stamp) — dt stacked ewma_step(·, 0, α)
        # updates without ever sweeping all total_buckets entries
        self._score = np.zeros(self.total_buckets, np.float32)
        self._stamp = np.zeros(self.total_buckets, np.int64)
        self._clock = 0
        # live-key counts of demoted buckets, recorded at demote time
        # (lanes are immutable off-device) — lets __len__ avoid
        # re-reading spilled records
        self._live: Dict[int, int] = {}
        # the warm set's coldest-first order, built once per clock tick
        # when the arena is full (see _coldest_warm)
        self._warm_heap: Optional[list] = None
        self._warm_seq: Dict[int, int] = {}
        self._seq = 0
        self._c_hit = telemetry.counter("storage.hits", tier="device",
                                        table=name)
        self._c_miss = {
            t: telemetry.counter("storage.misses", tier=TIER_NAMES[t],
                                 table=name)
            for t in (TIER_HOST, TIER_DISK, TIER_VIRGIN)}
        _MANAGERS.add(self)

    # -- access scores -----------------------------------------------------

    def touch(self, buckets: np.ndarray) -> None:
        """Bump the access EWMA of (unique) logical buckets — one clock
        tick per batch, so scores order buckets by recency-weighted batch
        frequency."""
        self._clock += 1
        self._warm_heap = None
        b = np.asarray(buckets, np.int64)
        decay = (1.0 - self.alpha) ** (
            self._clock - self._stamp[b]).astype(np.float32)
        self._score[b] = ewma_step(self._score[b] * decay, 1.0,
                                   self.alpha)
        self._stamp[b] = self._clock

    def scores(self, buckets: np.ndarray) -> np.ndarray:
        """Effective (lazily-decayed) scores at the current clock."""
        b = np.asarray(buckets, np.int64)
        decay = (1.0 - self.alpha) ** (
            self._clock - self._stamp[b]).astype(np.float32)
        return self._score[b] * decay

    # -- planning ----------------------------------------------------------

    def plan(self, needed: np.ndarray) -> ResidencyPlan:
        """Decide which resident buckets to demote so every bucket in
        ``needed`` (unique logical ids) can be device-resident at once.
        Pure bookkeeping — commits nothing."""
        needed = np.asarray(needed, np.int64)
        if len(needed) > self.device_buckets:
            raise ValueError(
                f"batch touches {len(needed)} distinct buckets but the "
                f"device tier holds {self.device_buckets}; chunk the "
                "batch (TieredKVTable does)")
        t = self.tier[needed]
        missing = needed[t != TIER_DEVICE]
        hits = len(needed) - len(missing)
        if hits:
            self._c_hit.inc(hits)
        for code in (TIER_HOST, TIER_DISK, TIER_VIRGIN):
            n = int((self.tier[missing] == code).sum())
            if n:
                self._c_miss[code].inc(n)
        # budget-capped headroom: free slots count only up to the control
        # plane's device budget (clamped so one batch's working set
        # always fits — the physical bound above rules)
        cap = max(min(int(self.device_budget), self.device_buckets),
                  len(needed), 1)
        in_use = self.device_buckets - len(self._free_slots)
        headroom = min(len(self._free_slots), max(cap - in_use, 0))
        shortfall = len(missing) - headroom
        if shortfall <= 0:
            victims = np.zeros(0, np.int64)
        else:
            resident = self.bucket_at[self.bucket_at >= 0]
            evictable = resident[~np.isin(resident, needed)]
            order = np.argsort(self.scores(evictable), kind="stable")
            victims = evictable[order[:shortfall]]
        return ResidencyPlan(victims=victims, fills=missing)

    # -- placement transitions (caller moves the device bytes) -------------

    def _host_put(self, bucket: int, rec: BucketRecord) -> None:
        self.host.put(bucket, rec)
        self._seq += 1
        self._warm_seq[bucket] = self._seq
        if self._warm_heap is not None:
            heapq.heappush(self._warm_heap, (
                float(self.scores(np.array([bucket]))[0]), self._seq,
                bucket))

    def _host_take(self, bucket: int) -> BucketRecord:
        self._warm_seq.pop(bucket, None)   # its heap entry goes stale
        return self.host.take(bucket)

    def _coldest_warm(self) -> int:
        """The warm bucket the reference's ``argmin`` over the arena's
        scores picks: the lowest effective score, the earliest put among
        equal ones (the arena's dict keeps insertion order). Scores move
        only when the clock ticks, so the order is built once per tick
        (one pass over the arena, numbered in dict order) and kept in a
        heap; a put pushes its bucket, a take leaves a stale entry that is
        skipped."""
        if self._warm_heap is None:
            warm = np.fromiter(self.host.buckets(), np.int64,
                               len(self.host))
            base = self._seq
            self._seq += len(warm)
            self._warm_seq = {int(b): base + i for i, b in enumerate(warm)}
            self._warm_heap = [
                (float(s), base + i, int(b))
                for i, (b, s) in enumerate(zip(warm, self.scores(warm)))]
            heapq.heapify(self._warm_heap)
        while True:
            _, seq, bucket = self._warm_heap[0]
            if self._warm_seq.get(bucket) == seq:
                return bucket
            heapq.heappop(self._warm_heap)

    def demote(self, bucket: int, rec: BucketRecord) -> None:
        """Device → host (spilling the coldest warm bucket to disk if the
        arena is full). ``rec`` is the bucket's gathered device content;
        the caller has already pulled it D2H."""
        bucket = int(bucket)
        slot = int(self.slot_of[bucket])
        if slot < 0:
            raise ValueError(f"bucket {bucket} is not device-resident")
        if self.host.capacity == 0:
            self._spill(bucket, rec)
        else:
            if self.host.full:
                coldest = self._coldest_warm()
                self._spill(coldest, self._host_take(coldest))
            self._host_put(bucket, rec)
            self.tier[bucket] = TIER_HOST
            telemetry.counter("storage.demotions", tier="host",
                              table=self.name).inc()
        self._live[bucket] = rec.live()
        self.slot_of[bucket] = -1
        self.bucket_at[slot] = -1
        self._free_slots.append(slot)

    def _spill(self, bucket: int, rec: BucketRecord) -> None:
        self.disk.spill(bucket, rec)
        self.tier[bucket] = TIER_DISK
        self._live[bucket] = rec.live()
        telemetry.counter("storage.demotions", tier="disk",
                          table=self.name).inc()
        telemetry.counter("storage.spills", table=self.name).inc()

    def fetch(self, bucket: int) -> Tuple[Optional[BucketRecord], str]:
        """Pull a non-resident bucket's record out of its tier (host take
        / disk fill / ``None`` for virgin) ahead of the device scatter.
        Pair with :meth:`assign_slot`."""
        bucket = int(bucket)
        code = int(self.tier[bucket])
        if code == TIER_HOST:
            rec: Optional[BucketRecord] = self._host_take(bucket)
        elif code == TIER_DISK:
            rec = self.disk.fill(bucket)
        elif code == TIER_VIRGIN:
            rec = None
        else:
            raise ValueError(
                f"bucket {bucket} already device-resident")
        src = TIER_NAMES[code] if code != TIER_VIRGIN else "virgin"
        telemetry.counter("storage.fills", tier=src,
                          table=self.name).inc()
        telemetry.counter("storage.promotions", tier=src,
                          table=self.name).inc()
        self._live.pop(bucket, None)
        return rec, src

    def assign_slot(self, bucket: int) -> Tuple[int, bool]:
        """Bind a fetched bucket to a free device slot. Returns ``(slot,
        needs_scatter)``: a virgin bucket landing on a never-used slot
        needs NO device write (the construction-time EMPTY rows already
        represent it)."""
        bucket = int(bucket)
        slot = self._free_slots.pop()
        was_used = bool(self._slot_used[slot])
        self._slot_used[slot] = True
        self.slot_of[bucket] = slot
        self.bucket_at[slot] = bucket
        self.tier[bucket] = TIER_DEVICE
        return slot, was_used

    def place_host(self, bucket: int, rec: BucketRecord) -> None:
        """Put a restored bucket straight into the host arena (``load``)."""
        self._host_put(int(bucket), rec)
        self.tier[bucket] = TIER_HOST
        self._live[int(bucket)] = rec.live()

    def retire(self) -> None:
        """Drop this manager from the status and alias-warning sets (a
        table replacing its manager — load() — calls this so the successor
        doesn't false-positive the shared-spill-path warning)."""
        _MANAGERS.discard(self)

    # -- introspection -----------------------------------------------------

    def offdevice_live_keys(self) -> int:
        return sum(self._live.values())

    def counts(self) -> Dict[str, int]:
        return {TIER_NAMES[c]: int((self.tier == c).sum())
                for c in (TIER_DEVICE, TIER_HOST, TIER_DISK,
                          TIER_VIRGIN)}

    def status(self) -> Dict[str, object]:
        """One tier-table status row (the reference's /statusz row)."""
        c = self.counts()
        return {
            "table": self.name,
            "total_buckets": self.total_buckets,
            "device_buckets": self.device_buckets,
            "host_buckets": self.host.capacity,
            "resident": c["device"],
            "host_used": len(self.host),
            "disk_records": len(self.disk),
            "virgin": c["virgin"],
            "disk_bytes": self.disk.nbytes(),
            "spill_path": self.disk.path,
            "clock": self._clock,
        }


def status_all() -> List[Dict[str, object]]:
    """Live tier-manager rows for a status page's storage section."""
    rows = []
    for m in list(_MANAGERS):
        try:
            rows.append(m.status())
        except Exception:   # a half-constructed manager must not
            continue        # take the status page down
    return sorted(rows, key=lambda r: str(r.get("table", "")))
