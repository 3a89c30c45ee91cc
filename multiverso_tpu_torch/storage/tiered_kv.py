"""TieredKVTable: a KVTable whose capacity ceiling is disk, not device
memory.

Counterpart of ``multiverso_tpu/storage/tiered_kv.py``. The table keeps
the KVTable contract (get/add/store/load, deferred overflow, the
prepare/dispatch staging split) over a LOGICAL geometry of
``total_buckets × slots`` while the device shards hold only
``device_buckets`` bucket rows — the hot set. Device slot ``s`` is the
parent's bucket ``s``: row ``s % bps`` of shard ``s // bps``. A host-side
injective map (``TierManager.slot_of``) translates logical bucket ids to
device slots; a miss on a get/add faults the bucket in on the dispatch
thread (the thread that owns the table's tensors):

1. ``plan``: the tier manager picks the coldest resident buckets outside
   the batch (per-bucket access EWMAs, lazily decayed) as victims,
2. demote: ``index_select`` reads the victims' rows from each shard
   (keys and values of replica 0, the state of the replica that holds
   its block) into a pinned host buffer, one D2H copy a shard, and the
   manager moves each record into the host arena (the warm tier; its own
   coldest bucket cascades to the disk spill file when the arena is
   full),
3. fill: missing buckets come back from the host arena or a ranged
   ``pread`` of the spill file (never-touched buckets are "virgin" —
   all-empty by construction, no IO), are stacked into a pinned buffer
   and written to the freed slots with ``index_copy_``: keys and values
   on every replica, the state on every replica or, under
   ``shard_update``, on the replica that holds the bucket's block.

These row moves are plain torch ops, as the reference's are XLA's
``take`` and ``.at[].set`` outside any kernel. Both walk the victims and
the fills one bucket at a time in Python, and every disk spill opens the
file again, as the reference does; ``fault_in_s`` sums the host seconds
of each part (plan, demote, fill).

Batches touching more distinct buckets than the device tier holds are
CHUNKED: each chunk faults its working set in and dispatches separately
— bucket-capacity pressure becomes demotion + retry instead of a dropped
batch. (Per-bucket slot overflow — more than ``slots`` live keys hashing
to one logical bucket — still raises with the named buckets.)

The kernel path: lanes are re-sorted by device slot AFTER the fault-in
(placement is decided at dispatch, not prepare), and each chunk then
runs the parent's one lookup (``mv_kv_lookup``) or one probe + commit
(``mv_kv_probe`` + ``mv_kv_commit``) per card, as any KVTable does. The
prepare half (:meth:`prepare_add`) stays thread-safe for the
``KVStagingWriter`` split: it validates, hashes and sorts on the worker
thread and defers packing and the H2D to :meth:`add_prepared`.

Checkpoints: the export gathers EVERY tier into logical bucket order —
content is a pure function of op history, independent of placement —
and records each bucket's tier in the payload (``tier_of``), so a resume
restores bit-identical content AND re-establishes the placement. The
file is the reference's (``"tiered": True`` and ``device_buckets`` in the
manifest): a float32 one loads in either package. ``RunCheckpointManager``
covers the table through ``export_checkpoint_async``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.storage.manager import (TIER_DEVICE, TIER_DISK,
                                                  TIER_HOST, TierConfig,
                                                  TierManager)
from multiverso_tpu_torch.storage.tiers import BucketRecord, RecordSpec
from multiverso_tpu_torch.tables.base import (HostCopy, _record_events,
                                              loadz_stream, state_keys)
from multiverso_tpu_torch.tables.hashing import _hash_u64
from multiverso_tpu_torch.tables.kv_table import (KV_MAGIC, KVTable,
                                                  host_values)
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import log


class _TieredPreparedAdd:
    """Prepare-half product of a tiered Add: host keys and deltas sorted
    by LOGICAL bucket. Packing (and the H2D) waits for the dispatch thread
    — lane→slot translation needs the fault-in that only the
    tensor-owning thread may run."""

    __slots__ = ("keys", "deltas", "logical", "option", "elems",
                 "nbytes")

    def __init__(self, keys, deltas, logical, option, elems, nbytes):
        self.keys = keys
        self.deltas = deltas
        self.logical = logical
        self.option = option
        self.elems = elems
        self.nbytes = nbytes


def _take(x, order: np.ndarray):
    """Rows ``order`` of a numpy array or a tensor (on its device)."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(order, device=x.device)]
    return x[order]


class TieredKVTable(KVTable):
    """KVTable over device memory + host RAM + disk. See the module
    docstring.

    Extra constructor knobs (budgets; ``MVTPU_TIER_*`` env supplies
    defaults — see ``storage/manager.py``):

    - ``device_buckets`` — hot-set size in buckets (the device budget);
      the parent rounds its geometry up to the mesh like every KVTable.
    - ``host_buckets`` — warm-arena size in buckets.
    - ``spill_dir`` — directory for the cold tier's spill file.
    - ``tier_alpha`` — access-EWMA smoothing for victim selection.
    """

    def __init__(self, capacity: int, value_dim: int = 0,
                 dtype: Any = "float32", *, slots_per_bucket: int = 8,
                 updater: Optional[str] = None,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None,
                 name: str = "tiered_kv_table",
                 default_value: float = 0.0,
                 default_option: Optional[AddOption] = None,
                 shard_update: bool = False,
                 device_buckets: Optional[int] = None,
                 host_buckets: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 tier_alpha: Optional[float] = None) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        core.refuse_model_split(core.resolve_mesh(mesh, device),
                                "the tiered KV table")
        total = -(-capacity // slots_per_bucket)
        cfg = TierConfig.from_env(total, device_buckets=device_buckets,
                                  host_buckets=host_buckets,
                                  spill_dir=spill_dir, alpha=tier_alpha)
        dev_buckets = min(max(int(cfg.device_buckets), 1), total)
        # the parent builds the DEVICE tier: shards sized to the hot set,
        # geometry rounded to the mesh like any KVTable
        super().__init__(dev_buckets * slots_per_bucket, value_dim, dtype,
                         slots_per_bucket=slots_per_bucket, updater=updater,
                         device=device, mesh=mesh, name=name,
                         default_value=default_value,
                         default_option=default_option,
                         shard_update=shard_update)
        # ... and this subclass re-points the LOGICAL geometry at the full
        # capacity: hashing is mod total_buckets, device bucket ids exist
        # only between fault-in and dispatch
        self.total_buckets = max(int(total), self.num_buckets)
        self.capacity = self.total_buckets * self.slots
        self._state_names = state_keys(self.state_shards[0])
        self.spec = RecordSpec(
            self.slots, self.value_dim, self.dtype,
            [np.float32] * len(self._state_names), default_value)
        self._pinned = self.device.type == "cuda"
        self.tiers = TierManager(self.name, self.total_buckets, cfg,
                                 self.spec, pin_memory=self._pinned)
        #: host seconds of the fault-ins so far, by part
        self.fault_in_s: Dict[str, float] = {"plan": 0.0, "demote": 0.0,
                                             "fill": 0.0}
        log.debug(
            "tiered kv table %r: %d logical buckets over %d device + "
            "%d host (+disk at %s)", name, self.total_buckets,
            self.tiers.device_buckets, self.tiers.host.capacity,
            self.tiers.disk.path)

    # logical hashing: mod the FULL geometry
    def _buckets_of(self, keys: np.ndarray) -> np.ndarray:
        return (_hash_u64(keys)
                % np.uint64(self.total_buckets)).astype(np.int64)

    # -- device rows (dispatch thread only) ----------------------------------

    def _by_shard(self, slots: np.ndarray):
        """Device slots grouped by shard: ``order`` (a stable sort of the
        slots by shard) and ``[(shard, lo, hi, local rows)]``, the shard's
        slots being ``order[lo:hi]``."""
        bps = self._buckets_per_shard
        shard = slots // bps
        order = np.argsort(shard, kind="stable")
        sshard = shard[order]
        cuts = np.flatnonzero(np.concatenate(
            [[True], sshard[1:] != sshard[:-1], [True]]))
        groups = [(int(sshard[lo]), int(lo), int(hi),
                   slots[order[lo:hi]] - sshard[lo] * bps)
                  for lo, hi in zip(cuts[:-1], cuts[1:])]
        return order, groups

    def _staging(self, m: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        List[torch.Tensor]]:
        """Host buffers for ``m`` bucket rows (pinned for a card)."""
        vtail = (self.value_dim,) if self.value_dim else ()
        pin = self._pinned
        return (torch.empty((m, self.slots, 2), dtype=torch.int32,
                            pin_memory=pin),
                torch.empty((m, self.slots) + vtail, dtype=self.dtype,
                            pin_memory=pin),
                [torch.empty((m, self.slots) + vtail, dtype=torch.float32,
                             pin_memory=pin) for _ in self._state_names])

    def _state_owner(self, local: np.ndarray):
        """Each local row's state: (replica, row in its block)."""
        if not self.shard_update:
            return np.zeros_like(local), local
        q = self._buckets_per_shard // self.n_replicas
        return local // q, local % q

    def _gather_slots(self, slots: np.ndarray):
        """The rows of device ``slots`` on the host, in ``slots`` order:
        keys (uint32 planes), values (host form), state leaves."""
        order, groups = self._by_shard(np.asarray(slots, np.int64))
        hk, hv, hs = self._staging(len(slots))
        devices = []
        for s, lo, hi, local in groups:
            dev = self.devices[s]
            devices.append(dev)
            rows = torch.as_tensor(local, device=dev)
            hk[lo:hi].copy_(self.key_shards[s].index_select(0, rows),
                            non_blocking=True)
            hv[lo:hi].copy_(self.value_shards[s].index_select(0, rows),
                            non_blocking=True)
            rep, row = self._state_owner(local)
            for j, k in enumerate(self._state_names):
                if not self.shard_update:
                    hs[j][lo:hi].copy_(
                        self.state_shards[s][k].index_select(0, rows),
                        non_blocking=True)
                    continue
                for r in np.unique(rep):
                    sel = np.flatnonzero(rep == r)
                    leaf = self.replica_states[r][s][k]
                    hs[j][lo + sel] = leaf.index_select(
                        0, torch.as_tensor(row[sel], device=leaf.device)
                    ).cpu()
        for event in _record_events(devices):
            event.synchronize()
        inv = np.empty(len(order), np.int64)
        inv[order] = np.arange(len(order))
        vals = hv.view(torch.int16).numpy().view(np.uint16) \
            if self.dtype == torch.bfloat16 else hv.numpy()
        return (hk.numpy().view(np.uint32)[inv], vals[inv],
                [leaf.numpy()[inv] for leaf in hs])

    def _scatter_slots(self, slots: np.ndarray,
                       recs: List[BucketRecord]) -> None:
        """Write ``recs`` to device ``slots``: keys and values on every
        replica, the state where its block lives."""
        order, groups = self._by_shard(np.asarray(slots, np.int64))
        hk, hv, hs = self._staging(len(slots))
        ordered = [recs[i] for i in order]
        np.stack([r.keys for r in ordered],
                 out=hk.numpy().view(np.uint32))
        hv_np = hv.view(torch.int16).numpy().view(np.uint16) \
            if self.dtype == torch.bfloat16 else hv.numpy()
        np.stack([r.values for r in ordered], out=hv_np)
        for j, leaf in enumerate(hs):
            np.stack([r.state[j] for r in ordered], out=leaf.numpy())
        for s, lo, hi, local in groups:
            rep, row = self._state_owner(local)
            for r in range(self.n_replicas):
                dev = self.replica_devices[r][s]
                rows = torch.as_tensor(local, device=dev)
                self.replica_keys[r][s].index_copy_(
                    0, rows, hk[lo:hi].to(dev, non_blocking=True))
                self.replica_values[r][s].index_copy_(
                    0, rows, hv[lo:hi].to(dev, non_blocking=True))
                sel = np.flatnonzero(rep == r) if self.shard_update \
                    else np.arange(hi - lo)
                if not len(sel):
                    continue
                srows = torch.as_tensor(row[sel], device=dev)
                for j, k in enumerate(self._state_names):
                    src = hs[j][lo:hi] if len(sel) == hi - lo \
                        else hs[j][lo + sel]
                    self.replica_states[r][s][k].index_copy_(
                        0, srows, src.to(dev, non_blocking=True))

    # -- fault-in (dispatch thread only) -------------------------------------

    def _ensure_resident(self, needed: np.ndarray) -> None:
        """Make every (unique) logical bucket in ``needed`` device
        resident: demote the plan's victims, then fill the misses. Runs on
        the dispatch thread — it writes the live tensors."""
        mgr = self.tiers
        t0 = time.perf_counter()
        mgr.touch(needed)
        plan = mgr.plan(needed)
        t1 = time.perf_counter()
        if plan.victims.size:
            hk, hv, hs = self._gather_slots(mgr.slot_of[plan.victims])
            for i, b in enumerate(plan.victims):
                mgr.demote(int(b), BucketRecord(
                    keys=hk[i], values=hv[i],
                    state=[leaf[i] for leaf in hs]))
        t2 = time.perf_counter()
        slots: List[int] = []
        recs: List[BucketRecord] = []
        for b in plan.fills:
            rec, _src = mgr.fetch(int(b))
            slot, was_used = mgr.assign_slot(int(b))
            if rec is None and not was_used:
                continue    # virgin bucket on a never-written slot:
            slots.append(slot)  # the EMPTY rows already represent it
            recs.append(rec if rec is not None else self.spec.empty())
        if slots:
            self._scatter_slots(np.asarray(slots), recs)
        t3 = time.perf_counter()
        self.fault_in_s["plan"] += t1 - t0
        self.fault_in_s["demote"] += t2 - t1
        self.fault_in_s["fill"] += t3 - t2

    def _chunk_spans(self, sorted_logical: np.ndarray
                     ) -> List[Tuple[int, int]]:
        """Split a bucket-sorted lane array into [lo, hi) spans, each
        touching at most ``device_buckets`` distinct buckets."""
        n = len(sorted_logical)
        budget = self.tiers.device_buckets
        starts = np.flatnonzero(np.concatenate(
            [[True], sorted_logical[1:] != sorted_logical[:-1]]))
        if len(starts) <= budget:
            return [(0, n)]
        spans = []
        for i in range(0, len(starts), budget):
            lo = int(starts[i])
            hi = int(starts[i + budget]) if i + budget < len(starts) \
                else n
            spans.append((lo, hi))
        return spans

    # -- get -----------------------------------------------------------------

    def get_tensor(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        self._check_overflow()
        keys = self._check_keys(keys)
        logical = self._buckets_of(keys)
        uniq = np.unique(logical)
        if len(uniq) <= self.tiers.device_buckets:
            self._ensure_resident(uniq)
            slots = self.tiers.slot_of[logical].astype(np.int32)
            return self._get_with_buckets(keys, slots)
        # miss storm wider than the device tier: sort lanes by logical
        # bucket, fault in + look up chunk by chunk, unpermute at the end
        # so callers still see their own key order
        order = np.argsort(logical, kind="stable")
        sk, sl = keys[order], logical[order]
        vals_parts, found_parts = [], []
        for lo, hi in self._chunk_spans(sl):
            self._ensure_resident(np.unique(sl[lo:hi]))
            slots = self.tiers.slot_of[sl[lo:hi]].astype(np.int32)
            v, f = self._get_with_buckets(sk[lo:hi], slots)
            vals_parts.append(v)
            found_parts.append(f)
        inv = np.empty(len(keys), np.int64)
        inv[order] = np.arange(len(keys))
        vals, found = torch.cat(vals_parts), torch.cat(found_parts)
        inv_dev = torch.as_tensor(inv, device=vals.device)
        return vals[inv_dev], found[inv_dev]

    # -- add -----------------------------------------------------------------

    def prepare_add(self, keys, deltas,
                    option: Optional[AddOption] = None):
        """Thread-safe host half (the ``KVStagingWriter`` seam):
        validate/hash/sort by LOGICAL bucket. No H2D here — operand order
        depends on slot placement, which is decided at dispatch (after the
        fault-in)."""
        keys, deltas, logical, opt = self._prep_host_add(keys, deltas,
                                                         option)
        elems = int(np.prod(tuple(deltas.shape)))
        return _TieredPreparedAdd(
            keys=keys, deltas=deltas, logical=logical, option=opt,
            elems=elems, nbytes=elems * self.dtype.itemsize)

    def add_prepared(self, prepared, sync: bool = False):
        if not isinstance(prepared, _TieredPreparedAdd):
            # a parent-layout batch (e.g. hand-built in tests) rides the
            # parent path untouched — its bucket ids are already
            # device-geometry
            return super().add_prepared(prepared, sync=sync)
        self._poll_overflow()
        handle = None
        for lo, hi in self._chunk_spans(prepared.logical):
            lk = prepared.logical[lo:hi]
            self._ensure_resident(np.unique(lk))
            slots = self.tiers.slot_of[lk].astype(np.int32)
            # stable re-sort by slot: per-bucket batch order survives
            # (slot↔bucket is injective), and the packed lanes meet the
            # kernels' sorted-by-bucket operand contract
            order = np.argsort(slots, kind="stable")
            packed = self._pack_prepared(
                prepared.keys[lo:hi][order],
                _take(prepared.deltas[lo:hi], order), slots[order],
                prepared.option)
            # each chunk advances the option step and the generation, as
            # the reference's parent add does once per chunk
            handle = super().add_prepared(packed, sync=False)
        if sync:
            handle.wait()           # raises a pending overflow
        return handle

    def _overflowing_buckets(self, host_buckets) -> list:
        """The parent stashes DEVICE slot ids with the overflow count;
        translate back to logical bucket ids (best effort — a slot may
        have been re-assigned since) so the raise names buckets the
        caller can recognize."""
        slots = super()._overflowing_buckets(host_buckets)
        out = []
        for s in slots:
            if 0 <= s < len(self.tiers.bucket_at) \
                    and self.tiers.bucket_at[s] >= 0:
                out.append(int(self.tiers.bucket_at[s]))
            else:
                out.append(int(s))
        return out

    def __len__(self) -> int:
        """Live keys across ALL tiers."""
        return super().__len__() + self.tiers.offdevice_live_keys()

    # -- checkpoint ------------------------------------------------------------

    def export_checkpoint_async(self):
        """Export the FULL logical table, placement-independent.

        Dispatch half: the device shards queued into pinned host buffers
        (``HostCopy``), copies of the host arena's records, the cold
        records read from the spill file in one pass (synchronous IO; the
        reference reads them a record at a time), and a snapshot of the
        placement (``tier_of``). Blocking
        half (``finish``): wait for the copies and merge every tier into
        ``total_buckets``-major arrays. Content is a pure function of the
        op history, so two runs with different placements (different
        budgets, different access order inside a step) export
        byte-identical payloads."""
        self.flush_coalesced()
        self._check_overflow()
        mgr = self.tiers
        reps = range(self.n_replicas) if self.shard_update else (0,)
        keys = HostCopy(self.key_shards)
        vals = HostCopy(self.value_shards)
        leaves = [HostCopy([self.replica_states[r][s][k]
                            for s in range(len(self.devices))
                            for r in reps]) for k in self._state_names]
        bucket_at = mgr.bucket_at.copy()
        tier_of = mgr.tier.copy()
        offdev = {int(b): mgr.host.peek(int(b))
                  for b in mgr.host.buckets()}
        offdev.update(mgr.disk.peek_all())
        manifest = {"magic": KV_MAGIC, "name": self.name,
                    "capacity": self.capacity,
                    "value_dim": self.value_dim, "slots": self.slots,
                    "num_buckets": self.total_buckets,
                    "dtype": self.dtype_name,
                    "updater": self.updater.name,
                    "step": self.default_option.step,
                    "tiered": True,
                    "device_buckets": mgr.device_buckets}
        spec = self.spec

        def finish():
            dk = keys.numpy().view(np.uint32)
            dv = vals.numpy()
            ds = [leaf.numpy() for leaf in leaves]
            T = self.total_buckets
            full_k = np.full((T,) + spec.key_shape, 0xFFFFFFFF, np.uint32)
            full_v = np.full((T,) + spec.val_shape, spec.default_fill,
                             spec.dtype)
            full_s = [np.zeros((T,) + spec.val_shape, d)
                      for d in spec.state_dtypes]
            live_slots = np.flatnonzero(bucket_at >= 0)
            dst = bucket_at[live_slots]
            full_k[dst] = dk[live_slots]
            full_v[dst] = dv[live_slots]
            for fs, leaf in zip(full_s, ds):
                fs[dst] = leaf[live_slots]
            for b, rec in offdev.items():
                full_k[b] = rec.keys
                full_v[b] = rec.values
                for fs, leaf in zip(full_s, rec.state):
                    fs[b] = leaf
            fill = (~(full_k == 0xFFFFFFFF).all(-1)).sum(-1)
            if self.dtype == torch.bfloat16:
                # the reference's bfloat16 array, as numpy writes it
                full_v = full_v.view(np.dtype("V2"))
            payload = {"keys": full_k, "values": full_v,
                       "bucket_fill": fill.astype(np.int32),
                       "tier_of": tier_of}
            for i, fs in enumerate(full_s):
                payload[f"state_{i}"] = fs
            manifest["n_state_leaves"] = len(full_s)
            self._record_op("store", full_v.size,
                            sum(a.nbytes for a in payload.values()))
            return manifest, payload
        return finish

    def load(self, uri: str) -> None:
        """Restore a tiered checkpoint: bit-identical logical content,
        placement re-established from the recorded ``tier_of`` (capped by
        the CURRENT budgets — a bucket that no longer fits its recorded
        tier cascades down; never-touched buckets stay virgin)."""
        self.flush_coalesced()
        self._check_overflow()
        manifest, data = loadz_stream(uri, KV_MAGIC)
        for field, mine in (("value_dim", self.value_dim),
                            ("dtype", self.dtype_name),
                            ("slots", self.slots),
                            ("num_buckets", self.total_buckets)):
            if manifest[field] != mine:
                raise ValueError(
                    f"tiered kv table {field} mismatch: checkpoint "
                    f"{manifest[field]!r} != table {mine!r} (tiered "
                    "restores require identical logical geometry)")
        if manifest["updater"] != self.updater.name:
            raise ValueError(
                f"checkpoint updater {manifest['updater']!r} != "
                f"{self.updater.name!r}")
        if int(manifest["n_state_leaves"]) != len(self._state_names):
            raise ValueError(
                f"checkpoint has {manifest['n_state_leaves']} state "
                f"leaves, updater {self.updater.name!r} has "
                f"{len(self._state_names)}")
        spec = self.spec
        full_k = data["keys"]
        full_v = host_values(data["values"], self.dtype)
        full_s = [np.asarray(data[f"state_{i}"], d)
                  for i, d in enumerate(spec.state_dtypes)]
        tier_of = np.asarray(
            data["tier_of"] if "tier_of" in data.files
            else np.full(self.total_buckets, TIER_DEVICE, np.int8), np.int8)
        # fresh placement state (the old spill file is abandoned; the
        # first new spill truncates it)
        self.tiers.retire()
        mgr = TierManager(self.name, self.total_buckets, self.tiers.config,
                          spec, pin_memory=self._pinned)
        nb = self.num_buckets
        new_k = np.full((nb,) + spec.key_shape, 0xFFFFFFFF, np.uint32)
        new_v = np.full((nb,) + spec.val_shape, spec.default_fill,
                        spec.dtype)
        new_s = [np.zeros((nb,) + spec.val_shape, d)
                 for d in spec.state_dtypes]

        def rec_of(b: int) -> BucketRecord:
            return BucketRecord(keys=full_k[b], values=full_v[b],
                                state=[leaf[b] for leaf in full_s])

        for code in (TIER_DEVICE, TIER_HOST, TIER_DISK):
            for b in np.flatnonzero(tier_of == code):
                b = int(b)
                rec = rec_of(b)
                want = code
                if want == TIER_DEVICE and not mgr._free_slots:
                    want = TIER_HOST
                if want == TIER_HOST and mgr.host.full:
                    want = TIER_DISK
                if want == TIER_DEVICE:
                    slot, _ = mgr.assign_slot(b)
                    new_k[slot] = rec.keys
                    new_v[slot] = rec.values
                    for arr, leaf in zip(new_s, rec.state):
                        arr[slot] = leaf
                elif want == TIER_HOST:
                    mgr.place_host(b, rec)
                else:
                    mgr.disk.spill(b, rec)
                    mgr.tier[b] = TIER_DISK
                    mgr._live[b] = rec.live()
        self._record_op("load", full_v.size,
                        full_k.nbytes + full_v.nbytes)
        self.install_arrays(new_k, new_v, new_s)
        self.tiers = mgr
        self.default_option.step = int(manifest.get("step", 0))
        with self._option_lock:
            self.generation += 1
        self._notify_views()
