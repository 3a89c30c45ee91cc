"""KVTable: a fixed-capacity hashed key -> value table, split over the
mesh's model axis.

Counterpart of ``multiverso_tpu/tables/kv_table.py``. The open hash is
``num_buckets x slots_per_bucket`` slots in fixed tensors; a key's bucket
is ``splitmix64(key) % num_buckets``. On a mesh of S model shards
``num_buckets`` rounds up to a multiple of S and shard s holds buckets
``[s * bps, (s + 1) * bps)`` on the mesh device ``[0, s]``
(``key_shards``, ``value_shards``, ``state_shards``; on one shard also
``keys``, ``values``, ``state``). A data axis above 1 changes
nothing: the table is one copy on data row 0, whose Get/Add equal the
reference's table replicated over ``data`` (replicas and
``shard_update``: ROADMAP queue A item 4):

- ``keys`` int32 ``[B, S, 2]``: the ``[hi, lo]`` uint32 bit patterns of the
  64-bit keys (torch's uint32 supports few ops); an empty slot is
  ``(-1, -1)``, the planes of the reserved ``EMPTY_KEY``.
- ``values`` ``[B, S]`` (``value_dim`` 0) or ``[B, S, value_dim]``, empty
  slots at ``default_value``; ``state``: the updater's leaves, shaped alike.

``get(keys)`` is one lookup (``ops.table_kernels.kv_lookup_sharded``, one
launch per card): missing keys give ``default_value`` and ``found``
False. ``add(keys, deltas)`` is one fused probe + updater apply
(``kv_probe_update_sharded``): a key takes its slot if present, else the
next empty slot of its bucket, same-bucket new keys in batch order. If any
key of the batch finds no slot, the whole batch is dropped on the device
(on every shard) and the error is raised at a later table op (the
reference's deferred overflow), so adds never wait for the device. The
host prep sorts lanes by bucket, which sorts them by shard, and slices
them per shard (``hashing.shard_lane_slices``); on one shard that is the
reference's flat layout, the batch padded to a power of two.

Tensors are updated in place (the reference donated its buffers). The
checkpoint is the reference's ``multiverso_tpu.kvtable.v1`` npz of the
global arrays (the shards concatenated): keys as uint32 ``[B, S, 2]``,
values, ``bucket_fill`` and the state leaves sorted by name; a table
stored by either package loads in the other, into any geometry and shard
count (a different bucket count is rehashed on the host).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables.base import (Handle, _record_events,
                                              _register, lanes_on,
                                              loadz_stream, savez_stream,
                                              state_keys, torch_dtype)
from multiverso_tpu_torch.tables.hashing import (EMPTY_KEY, _bucket,
                                                 _hash_u64, _join_keys,
                                                 _split_keys,
                                                 shard_lane_slices)
from multiverso_tpu_torch.updaters import (AddOption, get_updater,
                                           resolve_default_option)
from multiverso_tpu_torch.utils import configure, log

KV_MAGIC = "multiverso_tpu.kvtable.v1"


@dataclasses.dataclass
class KVTableOption:
    capacity: int
    value_dim: int = 0
    dtype: Any = "float32"
    slots_per_bucket: int = 8
    updater: Optional[str] = None
    name: str = "kv_table"


@dataclasses.dataclass
class PreparedKVAdd:
    """One Add batch with its host prep done and its operands on the
    device: lanes sorted by bucket and sliced per shard into
    ``(shards, L, ...)`` rows of local bucket ids (a tensor, or per-shard
    rows on their devices), each row padded to the power of two ``L``."""
    buckets: Any            # int32 (shards, L); padding on the last bucket
    query: Any              # int32 (shards, L, 2); padding lanes (-1, -1)
    deltas: Any             # (shards, L[, D]); padding lanes 0
    valid: Any              # bool (shards, L)
    option: AddOption       # snapshot, resolved at prepare time
    #: host copy of the batch's bucket ids (sorted, no padding), kept with
    #: the deferred overflow count so a raise can name the buckets
    host_buckets: Any
    #: each shard's real lane count (its lanes are a row prefix)
    counts: Any


def _keys_device(split: np.ndarray) -> np.ndarray:
    """[..., 2] uint32 planes -> the int32 bit patterns the device holds."""
    return np.ascontiguousarray(split, np.uint32).view(np.int32)


class KVTable:
    """Fixed-capacity hashed table: get/add/store/load on the
    (keys, values, state) triple; registers a table id."""

    def __init__(self, capacity: int, value_dim: int = 0,
                 dtype: Any = "float32", *, slots_per_bucket: int = 8,
                 updater: Optional[str] = None,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None, name: str = "kv_table",
                 default_value: float = 0.0,
                 default_option: Optional[AddOption] = None,
                 shard_update: bool = False) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.name = name
        self.mesh = core.resolve_mesh(mesh, device)
        if shard_update and self.mesh.shape[core.DATA_AXIS] > 1:
            raise NotImplementedError(
                f"KVTable {name!r}: shard_update over a data axis of "
                f"{self.mesh.shape[core.DATA_AXIS]} is not ported (ROADMAP "
                "queue A item 4)")
        self.devices = self.mesh.shard_devices
        self.device = self.devices[0]
        self.value_dim = value_dim
        self.np_dtype = np.dtype(dtype)
        self.dtype = torch_dtype(self.np_dtype)
        self.slots = slots_per_bucket
        self.default_value = default_value
        updater_name = updater if updater is not None \
            else configure.get_flag("updater_type")
        self.updater = get_updater(updater_name)
        self.default_option = resolve_default_option(updater_name,
                                                     default_option)
        self._option_lock = threading.Lock()
        self.generation = 0
        # the reference's geometry: buckets round up to a multiple of the
        # model-axis size; shard s owns buckets [s * bps, (s + 1) * bps),
        # so a sort by bucket IS a sort by shard, then bucket
        n_shards = len(self.devices)
        buckets = -(-capacity // self.slots)
        self.num_buckets = -(-buckets // n_shards) * n_shards
        self.capacity = self.num_buckets * self.slots
        self._buckets_per_shard = self.num_buckets // n_shards
        shard_shape = (self._buckets_per_shard, self.slots)
        vtail = (value_dim,) if value_dim else ()
        self.key_shards = [torch.full(shard_shape + (2,), -1,
                                      dtype=torch.int32, device=d)
                           for d in self.devices]
        self.value_shards = [torch.full(shard_shape + vtail, default_value,
                                        dtype=self.dtype, device=d)
                             for d in self.devices]
        self.state_shards = [self.updater.init_state(v)
                             for v in self.value_shards]
        # deferred overflow: (n_over device tensor, CUDA events, host
        # bucket ids) per add, drained without blocking in add and
        # blocking at every other table op
        self._pending_over: list = []
        self._events: list = []
        self.table_id = _register(self)  # type: ignore[arg-type]
        log.debug("kv table %r: %d buckets x %d slots (capacity %d) on %s",
                  name, self.num_buckets, self.slots, self.capacity,
                  [str(d) for d in self.devices])

    # -- storage ------------------------------------------------------------

    def _one_shard(self, what: str) -> None:
        if len(self.key_shards) != 1:
            raise NotImplementedError(
                f"kv table {self.name!r} is split into "
                f"{len(self.key_shards)} shards; {what} is one tensor only "
                "on a one-shard mesh (use the *_shards lists or "
                "global_arrays())")

    @property
    def keys(self) -> torch.Tensor:
        self._one_shard("keys")
        return self.key_shards[0]

    @keys.setter
    def keys(self, value: torch.Tensor) -> None:
        self._one_shard("keys")
        self.key_shards[0] = value

    @property
    def values(self) -> torch.Tensor:
        self._one_shard("values")
        return self.value_shards[0]

    @values.setter
    def values(self, value: torch.Tensor) -> None:
        self._one_shard("values")
        self.value_shards[0] = value

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        self._one_shard("state")
        return self.state_shards[0]

    @state.setter
    def state(self, value: Dict[str, torch.Tensor]) -> None:
        self._one_shard("state")
        self.state_shards[0] = value

    def global_arrays(self):
        """Fresh copies of the global (keys, values, state) on the first
        device: the shards concatenated in bucket order."""
        cat = lambda ts: torch.cat([t.to(self.device) for t in ts])
        return (cat(self.key_shards), cat(self.value_shards),
                {k: cat([st[k] for st in self.state_shards])
                 for k in self.state_shards[0]})

    def install_arrays(self, keys: np.ndarray, values: np.ndarray,
                       state_leaves) -> None:
        """Replace the triple with global host arrays of this geometry
        (keys as the uint32 planes; state leaves in checkpoint order), cut
        into the shards' bucket blocks. Commits only once every tensor is
        placed."""
        bps = self._buckets_per_shard
        names = state_keys(self.state_shards[0])

        def split(arr, dtype):
            return [torch.tensor(np.ascontiguousarray(
                arr[s * bps:(s + 1) * bps]), device=d).to(dtype)
                for s, d in enumerate(self.devices)]

        key_shards = split(_keys_device(keys), torch.int32)
        value_shards = split(np.asarray(values).astype(self.np_dtype),
                             self.dtype)
        leaves = [split(leaf, self.state_shards[0][k].dtype)
                  for k, leaf in zip(names, state_leaves)]
        self.key_shards, self.value_shards = key_shards, value_shards
        self.state_shards = [{k: leaves[i][s] for i, k in enumerate(names)}
                             for s in range(len(self.devices))]

    # -- keys and overflow ------------------------------------------------

    def _buckets_of(self, keys: np.ndarray) -> np.ndarray:
        return (_hash_u64(keys) % np.uint64(self.num_buckets)).astype(
            np.int32)

    def _check_keys(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.ndim != 1 or len(keys) == 0:
            raise ValueError("keys must be a non-empty 1-D array")
        if (keys == EMPTY_KEY).any():
            raise ValueError(f"key {EMPTY_KEY} is the reserved empty "
                             "sentinel")
        return keys

    def _raise_overflow(self, n_over: int, bucket_ids=None) -> None:
        where = ""
        if bucket_ids:
            shown = ", ".join(str(b) for b in bucket_ids[:16])
            more = "" if len(bucket_ids) <= 16 \
                else f" (+{len(bucket_ids) - 16} more)"
            where = f"; bucket id(s) at capacity for the batch: " \
                    f"[{shown}]{more}"
        raise RuntimeError(
            f"kv table {self.name!r}: {n_over} keys overflowed their "
            f"buckets in a previous add (configured capacity "
            f"{self.capacity} keys = {self.capacity // self.slots} "
            f"buckets x {self.slots} slots{where}; the batch was "
            "dropped "
            "atomically); raise capacity or slots_per_bucket. NOTE: "
            "the dropped add still advanced the table generation and "
            "option step (overflow is only known after device "
            "execution) — re-issue the dropped batch after resizing")

    def _overflowing_buckets(self, host_buckets) -> list:
        """Name the buckets that could not take a dropped batch: those
        whose current fill plus the batch's keys exceed ``slots`` (an upper
        bound: keys already present need no new slot, but the true
        overflowing bucket is always in the list)."""
        if host_buckets is None or len(host_buckets) == 0:
            return []
        ub, cnt = np.unique(np.asarray(host_buckets, np.int64),
                            return_counts=True)
        bps = self._buckets_per_shard
        fill = np.zeros(len(ub), np.int64)
        for s in np.unique(ub // bps):
            sel = ub // bps == s
            keys = self.key_shards[s]
            rows = keys[torch.as_tensor(ub[sel] - s * bps,
                                        device=keys.device)].cpu()
            fill[sel] = (rows != -1).any(-1).sum(-1).numpy()
        return [int(b) for b in ub[(fill + cnt) > self.slots]]

    def _drain_overflow(self, entries) -> None:
        n_over = 0
        bucket_ids: set = set()
        for flag, _event, host_buckets in entries:
            n = int(flag)
            if n:
                n_over += n
                bucket_ids.update(self._overflowing_buckets(host_buckets))
        if n_over:
            self._raise_overflow(n_over, sorted(bucket_ids))

    def _check_overflow(self) -> None:
        """Raise any pending overflow of earlier adds, blocking on their
        counts. Every table op but ``add`` calls it."""
        pending, self._pending_over = self._pending_over, []
        self._drain_overflow(pending)

    def _poll_overflow(self) -> None:
        """Non-blocking drain for ``add``: only counts whose event has
        completed are read (on the CPU every count is ready at once), so
        back-to-back adds keep the device queue full."""
        still, ready = [], []
        for entry in self._pending_over:
            done = all(e.query() for e in entry[1])
            (ready if done else still).append(entry)
        self._pending_over = still
        self._drain_overflow(ready)

    # -- Get ---------------------------------------------------------------

    def get_tensor(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched lookup -> (values, found) as device tensors: the
        reference's lane-sliced ``_get_jax_sharded`` (its ``get_jax`` on
        one shard, the queries padded to a power of two with the empty
        sentinel, whose lanes are sliced off)."""
        self._check_overflow()
        keys = self._check_keys(keys)
        n = len(keys)
        query, local, inv = self._get_lanes(keys, self._buckets_of(keys))
        vals, found = tk.kv_lookup_sharded(
            self.key_shards, self.value_shards, query, local, inv,
            self.default_value)
        if len(inv) != n:
            vals, found = vals[:n], found[:n]
        return vals, found

    def _get_lanes(self, keys: np.ndarray, lane_buckets: np.ndarray):
        """The host prep of a Get: sort the lanes by owning shard,
        slice each shard its row of local bucket ids and queries, and build
        ``inv`` (flat ``shard * L + pos`` indices, pow2-padded) that
        unpermutes the results back to caller order. Returns the device
        operands (query, local buckets, inv)."""
        bps = self._buckets_per_shard
        shard_ids = lane_buckets // bps
        # a stable sort on a 16-bit key is numpy's radix sort
        order = np.argsort(shard_ids.astype(np.int16), kind="stable")
        sshard = shard_ids[order]
        local = (lane_buckets[order] - sshard * bps).astype(np.int32)
        (sl_local, sl_query), _, pos = shard_lane_slices(
            sshard, len(self.key_shards),
            [local, _split_keys(keys[order])],
            [np.int32(bps - 1), np.uint32(0xFFFFFFFF)])
        inv = np.zeros(_bucket(len(keys)), np.int32)
        inv[order] = (sshard * sl_local.shape[1] + pos).astype(np.int32)
        return (lanes_on(_keys_device(sl_query), self.devices),
                lanes_on(sl_local, self.devices),
                torch.as_tensor(inv, device=self.device))

    def get(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """Batched lookup -> (values, found) on the host; missing keys give
        ``default_value``."""
        vals, found = self.get_tensor(keys)
        return vals.cpu().numpy(), found.cpu().numpy()

    def get_async(self, keys) -> Handle:
        """Non-blocking Get: ``wait()`` returns the device (values, found)
        once computed."""
        return Handle(self.get_tensor(keys))

    # -- Add ---------------------------------------------------------------

    def prepare_add(self, keys, deltas,
                    option: Optional[AddOption] = None) -> PreparedKVAdd:
        """Host half of an Add: validate, hash, sort the lanes stably by
        bucket, slice them per shard, each row padded to a power of two,
        and stage the operands on the devices.
        ``deltas`` may be a numpy array or a tensor (a device tensor stays
        on the device and is permuted there). The option is resolved
        here."""
        keys, deltas, lane_buckets, opt = self._prep_host_add(keys, deltas,
                                                              option)
        return self._pack_prepared(keys, deltas, lane_buckets, opt)

    def _prep_host_add(self, keys, deltas,
                       option: Optional[AddOption] = None):
        keys = self._check_keys(keys)
        if len(np.unique(keys)) != len(keys):
            raise ValueError("duplicate keys in one add; pre-aggregate")
        n = len(keys)
        want = (n, self.value_dim) if self.value_dim else (n,)
        if not isinstance(deltas, torch.Tensor):
            deltas = np.asarray(deltas)
        if tuple(deltas.shape) != want:
            raise ValueError(f"deltas shape {tuple(deltas.shape)} != {want}")
        lane_buckets = self._buckets_of(keys)
        order = np.argsort(lane_buckets, kind="stable")
        if isinstance(deltas, torch.Tensor):
            deltas = deltas[torch.as_tensor(order, device=deltas.device)]
        else:
            deltas = deltas[order]
        opt = (option or self.default_option).snapshot()
        return keys[order], deltas, lane_buckets[order], opt

    def _pack_prepared(self, keys: np.ndarray, deltas, lane_buckets:
                       np.ndarray, opt: AddOption) -> PreparedKVAdd:
        """The reference's sharded ``_pack_prepared``: the bucket sort
        already grouped the lanes by owning shard, each shard's lanes
        bucket-sorted in batch order; slice them into per-shard rows of
        local bucket ids, padding on each shard's last local bucket (so
        each row stays sorted; on one shard, the reference's flat
        layout)."""
        bps = self._buckets_per_shard
        n_shards = len(self.key_shards)
        shard_ids = lane_buckets // bps
        local = (lane_buckets - shard_ids * bps).astype(np.int32)
        arrays = [local, _split_keys(keys)]
        pads = [np.int32(bps - 1), np.uint32(0xFFFFFFFF)]
        if not isinstance(deltas, torch.Tensor):
            arrays.append(deltas.astype(_canonical_numpy(deltas.dtype),
                                        copy=False))
            pads.append(0)
        sliced, valid, _ = shard_lane_slices(shard_ids, n_shards, arrays,
                                             pads)
        counts = valid.sum(1)
        if isinstance(deltas, torch.Tensor):
            # a device delta is sliced on the device, a copy per shard
            lanes = sliced[0].shape[1]
            sl_deltas = torch.zeros(
                (n_shards, lanes) + tuple(deltas.shape[1:]),
                dtype=_canonical_torch(deltas.dtype), device=self.device)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            deltas = deltas.to(self.device)
            for s, (st, c) in enumerate(zip(starts, counts)):
                sl_deltas[s, :c] = deltas[st:st + c]
        else:
            sl_deltas = sliced[2]
        put = lambda a: lanes_on(a, self.devices)
        return PreparedKVAdd(
            buckets=put(sliced[0]), query=put(_keys_device(sliced[1])),
            deltas=put(sl_deltas), valid=put(valid), option=opt,
            host_buckets=lane_buckets, counts=counts)

    def add_prepared(self, prepared: PreparedKVAdd,
                     sync: bool = False) -> Handle:
        """Device half of an Add: one fused probe + updater apply on the
        staged batch. The overflow count stays on the device until a later
        table op reads it."""
        self._poll_overflow()
        n_over = tk.kv_probe_update_sharded(
            self.key_shards, self.value_shards, self.state_shards,
            prepared.buckets, prepared.query, prepared.deltas,
            prepared.valid, prepared.option, self.updater,
            counts=prepared.counts)[3]
        self._events = _record_events(self.devices)
        self._pending_over.append((n_over, self._events,
                                   prepared.host_buckets))
        with self._option_lock:
            self.default_option.step += 1
            self.generation += 1
            gen = self.generation
        handle = Handle(table=self, generation=gen)
        if sync:
            handle.wait()
        return handle

    def add(self, keys, deltas, option: Optional[AddOption] = None,
            sync: bool = False) -> Handle:
        """Batched upsert through the updater. Keys of one batch must be
        distinct (pre-aggregate duplicates). On bucket overflow the batch
        is dropped on the device and a later table op raises; the handle,
        the generation and the option step still advance."""
        self._poll_overflow()
        return self.add_prepared(self.prepare_add(keys, deltas, option),
                                 sync=sync)

    def wait(self) -> None:
        """Block until every queued add has applied; raise a pending
        overflow."""
        for event in self._events:
            event.synchronize()
        self._check_overflow()

    def _live_value(self) -> Any:
        """The values (the list of value shards for a sharded table)."""
        return self.value_shards[0] if len(self.value_shards) == 1 \
            else list(self.value_shards)

    def __len__(self) -> int:
        """Number of live keys (counted on the devices)."""
        self._check_overflow()
        return sum(int((k != -1).any(-1).sum()) for k in self.key_shards)

    # -- checkpoint --------------------------------------------------------

    def export_checkpoint_async(self):
        """Checkpoint export in two halves: device copies of the triple
        now (later adds update the live tensors in place), the host
        payload in the returned ``finish()``."""
        self._check_overflow()
        keys, vals, state = self.global_arrays()
        names = state_keys(state)
        leaves = [state[k] for k in names]
        manifest = {"magic": KV_MAGIC, "name": self.name,
                    "capacity": self.capacity, "value_dim": self.value_dim,
                    "slots": self.slots, "num_buckets": self.num_buckets,
                    "dtype": self.np_dtype.name,
                    "updater": self.updater.name,
                    "step": self.default_option.step}

        def finish():
            host_keys = keys.cpu().numpy().view(np.uint32)
            # slots fill contiguously (no deletion), so fill = live count
            fill = (~(host_keys == 0xFFFFFFFF).all(-1)).sum(-1)
            payload = {"keys": host_keys, "values": vals.cpu().numpy(),
                       "bucket_fill": fill.astype(np.int32)}
            for i, leaf in enumerate(leaves):
                payload[f"state_{i}"] = leaf.cpu().numpy()
            manifest["n_state_leaves"] = len(leaves)
            return manifest, payload
        return finish

    def store(self, uri: str) -> None:
        manifest, payload = self.export_checkpoint_async()()
        savez_stream(uri, manifest, payload)

    def load(self, uri: str) -> None:
        # a pending overflow is about the pre-load state: raise it first
        self._check_overflow()
        manifest, data = loadz_stream(uri, KV_MAGIC)
        for field, mine in (("value_dim", self.value_dim),
                            ("dtype", self.np_dtype.name)):
            if manifest[field] != mine:
                raise ValueError(
                    f"kv table {field} mismatch: checkpoint "
                    f"{manifest[field]!r} != table {mine!r}")
        if manifest["updater"] != self.updater.name:
            raise ValueError(
                f"checkpoint updater {manifest['updater']!r} != "
                f"{self.updater.name!r}")
        names = state_keys(self.state_shards[0])
        if int(manifest["n_state_leaves"]) != len(names):
            raise ValueError(
                f"checkpoint has {manifest['n_state_leaves']} state "
                f"leaves, updater {self.updater.name!r} has {len(names)}")
        new_buckets = self.num_buckets
        if manifest["num_buckets"] != self.num_buckets \
                or manifest["slots"] != self.slots:
            new_buckets, host_keys, host_vals, host_state = \
                self._rehash_checkpoint(manifest, data)
        else:
            host_keys, host_vals = data["keys"], data["values"]
            host_state = [data[f"state_{i}"] for i in range(len(names))]
        grown = new_buckets != self.num_buckets
        if grown:
            self._buckets_per_shard = new_buckets // len(self.devices)
        self.install_arrays(host_keys, host_vals, host_state)
        if grown:
            log.warn(
                "kv table %r: rehash from %dx%d into %dx%d overflowed a "
                "bucket; geometry auto-grown to %dx%d (capacity %d -> "
                "%d) so the restore succeeds",
                self.name, manifest["num_buckets"], manifest["slots"],
                self.num_buckets, self.slots, new_buckets, self.slots,
                self.capacity, new_buckets * self.slots)
            self.num_buckets = new_buckets
            self.capacity = new_buckets * self.slots
        self.default_option.step = int(manifest.get("step", 0))
        with self._option_lock:
            self.generation += 1

    def _rehash_checkpoint(self, manifest, data):
        """Re-insert a checkpoint's live (key, value, state) triples into
        this table's (num_buckets, slots) geometry, on the host. Within a
        bucket the slots follow the checkpoint's bucket-major order. If a
        bucket would overflow, the bucket count doubles until every key
        fits (it stays a multiple of the shard count). Returns
        (num_buckets, keys, values, state leaves) without touching the
        table."""
        ck_keys = data["keys"]                        # [B0, S0, 2] u32
        live = ~(ck_keys == np.uint32(0xFFFFFFFF)).all(-1)
        bb, ss = np.nonzero(live)
        k2 = ck_keys[bb, ss]                          # [n, 2]
        hashes = _hash_u64(_join_keys(k2))
        n = len(hashes)
        nb = self.num_buckets
        while n and np.unique(hashes % np.uint64(nb),
                              return_counts=True)[1].max() > self.slots:
            if nb >= 2 ** 30:
                raise ValueError(
                    f"kv table {self.name!r}: rehash from "
                    f"{manifest['num_buckets']}x{manifest['slots']} "
                    f"cannot fit every bucket even at {nb} buckets of "
                    f"{self.slots} slot(s); construct the restoring table "
                    "with slots_per_bucket >= 4")
            nb *= 2
        buckets = (hashes % np.uint64(nb)).astype(np.int32)
        order = np.argsort(buckets, kind="stable")
        sb = buckets[order]
        # slot = rank within each bucket run of the sorted order
        pos = np.arange(n)
        run_start = np.concatenate([[True], sb[1:] != sb[:-1]]) \
            if n else np.zeros(0, bool)
        lane = pos - np.maximum.accumulate(np.where(run_start, pos, 0))
        kv_shape = (nb, self.slots)
        new_keys = np.full(kv_shape + (2,), 0xFFFFFFFF, np.uint32)
        new_keys[sb, lane] = k2[order]

        def remap(arr, fill):
            out = np.full(kv_shape + arr.shape[2:], fill, arr.dtype)
            out[sb, lane] = arr[bb, ss][order]
            return out

        new_vals = remap(data["values"], self.default_value)
        new_state = [remap(data[f"state_{i}"], 0)
                     for i in range(manifest["n_state_leaves"])]
        return nb, new_keys, new_vals, new_state


def _canonical_numpy(dtype) -> np.dtype:
    """64-bit deltas narrow to 32 bits, as the reference's device arrays
    do without x64."""
    dtype = np.dtype(dtype)
    return {np.dtype(np.float64): np.dtype(np.float32),
            np.dtype(np.int64): np.dtype(np.int32)}.get(dtype, dtype)


def _canonical_torch(dtype: torch.dtype) -> torch.dtype:
    return {torch.float64: torch.float32,
            torch.int64: torch.int32}.get(dtype, dtype)
