"""KVTable: a fixed-capacity hashed key -> value table, split over the
mesh's model axis and replicated over its data axis.

Counterpart of ``multiverso_tpu/tables/kv_table.py``. The open hash is
``num_buckets x slots_per_bucket`` slots in fixed tensors; a key's bucket
is ``splitmix64(key) % num_buckets``. On a mesh of S model shards
``num_buckets`` rounds up to a multiple of S and shard s holds buckets
``[s * bps, (s + 1) * bps)``. On a data axis D above 1 the table holds D
replicas of that split, as the reference replicates its keys and values
over ``data``: replica ``d``'s shard ``s`` lives on the mesh device
``[d, s]`` (``replica_keys[d]``, ``replica_values[d]``,
``replica_states[d]``; ``key_shards``, ``value_shards``, ``state_shards``
are replica 0's, and on one shard and one replica ``keys``, ``values``,
``state`` their tensors). A Get reads replica 0; every add writes each
cell it touches to every replica, so they stay bit-identical. Under
``shard_update`` (the reference's updater state split over (model,
data)) ``num_buckets`` rounds up to a multiple of S * D and replica ``d``
holds block ``d`` of each shard's state leaves, buckets
``[d * q, (d + 1) * q)`` of the shard with ``q = bps / D``; an add updates
a cell's state in the block that holds it:

- ``keys`` int32 ``[B, S, 2]``: the ``[hi, lo]`` uint32 bit patterns of the
  64-bit keys (torch's uint32 supports few ops); an empty slot is
  ``(-1, -1)``, the planes of the reserved ``EMPTY_KEY``.
- ``values`` ``[B, S]`` (``value_dim`` 0) or ``[B, S, value_dim]`` of the
  table's ``dtype`` (float32, bfloat16 or float16 on the card), empty
  slots at ``default_value``; ``state``: the updater's float32 leaves,
  shaped alike.

``get(keys)`` is one lookup (``ops.table_kernels.kv_lookup_sharded``, one
launch per card): missing keys give ``default_value`` and ``found``
False. ``add(keys, deltas)`` is one fused probe + updater apply
(``kv_probe_update_sharded``, one probe and one commit launch per card,
the commit writing every replica): a key takes its slot if present, else
the next empty slot of its bucket, same-bucket new keys in batch order.
If any key of the batch finds no slot, the whole batch is dropped on the
device (on every shard and replica) and the error is raised at a later
table op (the reference's deferred overflow), so adds never wait for the
device. The host prep sorts lanes by bucket, which sorts them by shard,
and slices them per shard (``hashing.shard_lane_slices``); on one shard
that is the reference's flat layout, the batch padded to a power of two.

Over several processes (``core``'s module doc) a table holds the shards
of its process's cells only, None for the others. Every process hashes
and sorts the same batch; when the model axis crosses processes, or the
state is split over a data axis that does (``shard_update``), each lane
is committed by ONE process, the one that owns the cell of its shard's
state (row 0's cell, or under ``shard_update`` the cell of its block),
which probes and commits it on its own copies. The overflow gate is the
sum of every process's count, brought through the host
(:func:`~multiverso_tpu_torch.parallel.multihost.allgather_i64`) after
this process's probes and before any commit, so an overflow on any
process voids the batch on every one. Then, where another process holds
a copy of a shard, the processes exchange the cells they wrote (bucket,
slot, key, value, and the state when every copy holds it), never whole
blocks, and write them into their copies. A Get reads each shard from a
local replica that holds it and ORs every process's partial in
(:func:`~multiverso_tpu_torch.parallel.multihost.or_partials`).

Tensors are updated in place (the reference donated its buffers). The
checkpoint is the reference's ``multiverso_tpu.kvtable.v1`` npz of the
global arrays (the shards concatenated; under ``shard_update`` each
shard's state blocks joined in replica order): keys as uint32
``[B, S, 2]``, values (bfloat16 as the raw two-byte array the reference
writes, under its ``dtype`` name), ``bucket_fill`` and the state leaves
sorted by name; a table stored by either package loads in the other,
into any geometry, shard count and replica count (a different bucket
count is rehashed on the host).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.ft.chaos import chaos_corrupt
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables.base import (Handle, HostCopy, Table,
                                              _record_events, _register,
                                              dtype_name, lanes_on,
                                              loadz_stream, savez_stream,
                                              state_keys, torch_dtype)
from multiverso_tpu_torch.tables.hashing import (EMPTY_KEY, _bucket,
                                                 _hash_u64, _join_keys,
                                                 _split_keys,
                                                 shard_lane_slices)
from multiverso_tpu_torch.telemetry import health as _health
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry import trace as tracing
from multiverso_tpu_torch.telemetry.profiling import profiled
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
    shard_update: bool = False   # data-axis updater-state sharding


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
    #: the delta's elements and their bytes in the table's value type
    #: (the reference's ``table.add`` accounting)
    elems: int
    nbytes: int


def _keys_device(split: np.ndarray) -> np.ndarray:
    """[..., 2] uint32 planes -> the int32 bit patterns the device holds."""
    return np.ascontiguousarray(split, np.uint32).view(np.int32)


def host_values(arr, dtype: torch.dtype) -> np.ndarray:
    """A host array of values in the host form of a table of ``dtype``:
    numpy's own type, or for bfloat16 (which numpy lacks) its uint16 bit
    patterns. A two-byte array numpy cannot name (a checkpoint's void
    ``V2``, ``ml_dtypes``' bfloat16) already holds them."""
    arr = np.asarray(arr)
    if dtype != torch.bfloat16:
        return arr.astype(torch.empty(0, dtype=dtype).numpy().dtype,
                          copy=False)
    if arr.dtype.kind not in "fiub":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"{arr.dtype} values are not bfloat16 bits")
        return np.ascontiguousarray(arr).view(np.uint16)
    bits = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
        torch.bfloat16).view(torch.int16)
    return bits.numpy().view(np.uint16)


def from_host(arr: np.ndarray, dtype: torch.dtype,
              device=None) -> torch.Tensor:
    """A host-form array (:func:`host_values`) as a tensor of ``dtype``
    (a copy) on ``device``."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        return torch.tensor(arr.view(np.int16), device=device).view(dtype)
    return torch.tensor(arr, device=device)


class KVTable:
    """Fixed-capacity hashed table: get/add/store/load on the
    (keys, values, state) triple; registers a table id."""

    #: whether the table holds a replica per row of the data axis
    REPLICATED = True

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
        # over several processes: the shards of this process's cells only
        # (the probe is a pure function of table state and batch, so every
        # process's copies stay identical; see the module doc for a model
        # axis that crosses processes)
        self.replica_ids = list(self.mesh.local_rows)
        self.n_data = n_replicas = self.mesh.shape[core.DATA_AXIS]
        self.replica_devices = [self.mesh.replica_devices(d)
                                for d in self.replica_ids]
        self.devices = self.replica_devices[0]
        self.device = self.mesh.row_device(self.replica_ids[0])
        self.value_dim = value_dim
        self.dtype = torch_dtype(dtype)
        self.dtype_name = dtype_name(self.dtype)
        self.slots = slots_per_bucket
        self.default_value = default_value
        updater_name = updater if updater is not None \
            else configure.get_flag("updater_type")
        self.updater = get_updater(updater_name)
        self.default_option = resolve_default_option(updater_name,
                                                     default_option)
        self._option_lock = threading.Lock()
        self.generation = 0
        # client-pipeline hooks, shared with the dense tables
        self._view_refs: list = []
        self._coalescer_refs: list = []
        # the reference's geometry: buckets round up to a multiple of the
        # model-axis size (of model x data under shard_update); shard s
        # owns buckets [s * bps, (s + 1) * bps), so a sort by bucket IS a
        # sort by shard, then bucket
        self.shard_update = bool(shard_update) and n_replicas > 1
        m = self.mesh
        #: each lane committed by one process, the gate summed over them
        self._cross = m.processes > 1 and (m.model_split
                                           or self.shard_update)
        n_shards = len(self.devices)
        #: whether another process holds a copy of a shard whose cells
        #: this one writes (then the written cells are exchanged)
        self._shared = self._cross and any(
            len({m.owner(g, s) for g in range(n_replicas)}) > 1
            for s in range(n_shards))
        mult = n_shards * n_replicas if self.shard_update else n_shards
        buckets = -(-capacity // self.slots)
        self.num_buckets = -(-buckets // mult) * mult
        self.capacity = self.num_buckets * self.slots
        self._buckets_per_shard = self.num_buckets // n_shards
        shard_shape = (self._buckets_per_shard, self.slots)
        vtail = (value_dim,) if value_dim else ()
        self.replica_keys = [[None if d is None else
                              torch.full(shard_shape + (2,), -1,
                                         dtype=torch.int32, device=d)
                              for d in devs]
                             for devs in self.replica_devices]
        self.replica_values = [[None if d is None else
                                torch.full(shard_shape + vtail,
                                           default_value, dtype=self.dtype,
                                           device=d) for d in devs]
                               for devs in self.replica_devices]
        self.replica_states = [
            [None if v is None else
             self.updater.init_state(v[self._state_block(r)]) for v in vals]
            for r, vals in enumerate(self.replica_values)]
        # deferred overflow: (n_over device tensor, CUDA events, host
        # bucket ids) per add, drained without blocking in add and
        # blocking at every other table op
        self._pending_over: list = []
        self._events: list = []
        # profiled: profile.calls{fn=kv.lookup/kv.apply.<name>} are the
        # Get/Add dispatch counts (the reference's names)
        self._lookup = profiled(tk.kv_lookup_sharded, f"kv.lookup.{name}")
        self._probe_update = profiled(tk.kv_probe_update_sharded,
                                      f"kv.apply.{name}")
        self.table_id = _register(self)  # type: ignore[arg-type]
        lbl = f"{self.table_id}:{self.name}"
        self._h_get = telemetry.histogram(
            "table.get.seconds", telemetry.LATENCY_BUCKETS, table=lbl)
        self._h_add = telemetry.histogram(
            "table.add.seconds", telemetry.LATENCY_BUCKETS, table=lbl)
        log.debug("kv table %r: %d buckets x %d slots (capacity %d) on %s",
                  name, self.num_buckets, self.slots, self.capacity,
                  [[str(d) for d in devs] for devs in self.replica_devices])

    # per-table op accounting + client-pipeline hooks, shared with the
    # dense tables (KVTable is contract-compatible, not a subclass)
    _record_op = Table._record_op
    _attach_view = Table._attach_view
    _attach_coalescer = Table._attach_coalescer
    _notify_views = Table._notify_views
    flush_coalesced = Table.flush_coalesced
    # the shards of a model axis that crosses processes
    _read_shards = Table._read_shards
    _filled = Table._filled
    _fill_remote = Table._fill_remote
    _merge = Table._merge
    _merger = Table._merger
    _state0 = Table._state0

    # -- storage ------------------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self.replica_keys)

    @property
    def key_shards(self) -> List[torch.Tensor]:
        """Replica 0's keys, shard by shard."""
        return self.replica_keys[0]

    @property
    def value_shards(self) -> List[torch.Tensor]:
        """Replica 0's values, shard by shard."""
        return self.replica_values[0]

    @property
    def state_shards(self) -> List[Dict[str, torch.Tensor]]:
        """Replica 0's updater state, shard by shard (under shard_update,
        the block of each shard that replica 0 holds)."""
        return self.replica_states[0]

    def _state_block(self, replica: int) -> slice:
        """The buckets of a shard whose state local replica ``replica``
        (global data row ``replica_ids[replica]``) holds."""
        if not self.shard_update:
            return slice(None)
        q = self._buckets_per_shard // self.n_data
        g = self.replica_ids[replica]
        return slice(g * q, (g + 1) * q)


    def _one_shard(self, what: str, whole_state: bool = False) -> None:
        if len(self.key_shards) != 1:
            raise NotImplementedError(
                f"kv table {self.name!r} is split into "
                f"{len(self.key_shards)} shards; {what} is one tensor only "
                "on a one-shard mesh (use the *_shards lists or "
                "global_arrays())")
        if whole_state and self.shard_update:
            raise NotImplementedError(
                f"kv table {self.name!r} splits its state over "
                f"{self.n_replicas} replicas (shard_update); use "
                "replica_states or global_arrays()")

    def _one_copy(self, what: str) -> None:
        self._one_shard(what)
        if self.n_replicas != 1:
            raise NotImplementedError(
                f"kv table {self.name!r} holds {self.n_replicas} replicas; "
                f"set {what} through load or convert.load_kv_table, which "
                "write them all")

    @property
    def keys(self) -> torch.Tensor:
        self._one_shard("keys")
        return self.key_shards[0]

    @keys.setter
    def keys(self, value: torch.Tensor) -> None:
        self._one_copy("keys")
        self.key_shards[0] = value

    @property
    def values(self) -> torch.Tensor:
        self._one_shard("values")
        return self.value_shards[0]

    @values.setter
    def values(self, value: torch.Tensor) -> None:
        self._one_copy("values")
        self.value_shards[0] = value

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        self._one_shard("state", whole_state=True)
        return self.state_shards[0]

    @state.setter
    def state(self, value: Dict[str, torch.Tensor]) -> None:
        self._one_copy("state")
        self.state_shards[0] = value

    def _global_parts(self):
        """The global (keys, values, {leaf: state}) as per-shard part
        lists in bucket order (under shard_update each shard's state
        blocks in replica order): each shard from a local replica that
        holds it, the parts other processes hold gathered over the group
        (a COLLECTIVE when the model axis crosses processes or under a
        shard_update split across processes)."""
        keys = self._filled(self._read_shards(self.replica_keys))
        vals = self._filled(self._read_shards(self.replica_values))
        names = state_keys(self._state0())
        if not self.shard_update:
            states = self._read_shards(self.replica_states)
            return keys, vals, {k: self._filled(
                [None if st is None else st[k] for st in states])
                for k in names}
        out = {}
        for k in names:
            blocks = [[None] * self.n_data for _ in self.devices]
            for r, g in enumerate(self.replica_ids):
                for s, st in enumerate(self.replica_states[r]):
                    if st is not None:
                        blocks[s][g] = st[k]
            self._fill_remote(blocks)
            out[k] = [b for row in blocks for b in row]
        return keys, vals, out

    def global_arrays(self):
        """Fresh copies of the global (keys, values, state) on the first
        device: the shards concatenated in bucket order, under
        shard_update each shard's state blocks in replica order (a
        collective when parts lie in other processes)."""
        cat = lambda ts: torch.cat([t.to(self.device) for t in ts])
        keys, vals, states = self._global_parts()
        return cat(keys), cat(vals), {k: cat(v) for k, v in states.items()}

    def install_arrays(self, keys: np.ndarray, values: np.ndarray,
                       state_leaves) -> None:
        """Replace the triple with global host arrays of this geometry
        (keys as the uint32 planes; values in the table's host form,
        :func:`host_values`; state leaves in checkpoint order) on every
        replica, cut into the shards' bucket blocks and, under
        shard_update, each shard's state into the replicas' blocks.
        Commits only once every tensor is placed."""
        bps = self._buckets_per_shard
        st0 = self._state0()
        names = state_keys(st0)
        leaf_dtypes = [st0[k].dtype for k in names]
        keys = _keys_device(keys)
        rk, rv, rs = [], [], []
        for r, devs in enumerate(self.replica_devices):
            blk = self._state_block(r)
            rk.append([None if d is None else
                       torch.tensor(keys[s * bps:(s + 1) * bps], device=d)
                       for s, d in enumerate(devs)])
            rv.append([None if d is None else
                       from_host(values[s * bps:(s + 1) * bps], self.dtype,
                                 d) for s, d in enumerate(devs)])
            rs.append([None if d is None else {k: torch.tensor(
                np.ascontiguousarray(
                    np.asarray(leaf)[s * bps:(s + 1) * bps][blk]),
                device=d).to(dt)
                for k, dt, leaf in zip(names, leaf_dtypes, state_leaves)}
                for s, d in enumerate(devs)])
        self.replica_keys, self.replica_values, self.replica_states = \
            rk, rv, rs

    # -- keys and overflow ------------------------------------------------

    def _bucket_rows(self, buckets: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Whole bucket rows of replica 0 on the host: keys as uint32
        planes (m, S, 2) and values (m, S[, V]) in the host form
        (:func:`host_values`)."""
        bps = self._buckets_per_shard
        hk = np.empty((len(buckets), self.slots, 2), np.uint32)
        vtail = (self.value_dim,) if self.value_dim else ()
        hv = np.empty((len(buckets), self.slots) + vtail,
                      np.uint16 if self.dtype == torch.bfloat16
                      else torch.empty(0, dtype=self.dtype).numpy().dtype)
        shard = buckets // bps
        for s in np.unique(shard):
            sel = np.flatnonzero(shard == s)
            keys, vals = self.key_shards[s], self.value_shards[s]
            rows = torch.as_tensor(buckets[sel] - s * bps,
                                   device=keys.device)
            hk[sel] = keys.index_select(0, rows).cpu().numpy().view(
                np.uint32)
            got = vals.index_select(0, rows).cpu()
            hv[sel] = got.view(torch.int16).numpy().view(np.uint16) \
                if self.dtype == torch.bfloat16 else got.numpy()
        return hk, hv

    def _put_bucket_rows(self, buckets: np.ndarray, hk: np.ndarray,
                         hv: np.ndarray) -> None:
        """Write whole bucket rows (as :meth:`_bucket_rows` gives them)
        to every replica, keys and values; the updater state stays."""
        bps = self._buckets_per_shard
        shard = buckets // bps
        for s in np.unique(shard):
            sel = np.flatnonzero(shard == s)
            local = buckets[sel] - s * bps
            k = torch.from_numpy(_keys_device(hk[sel]))
            v = from_host(hv[sel], self.dtype)
            for r in range(self.n_replicas):
                keys = self.replica_keys[r][s]
                rows = torch.as_tensor(local, device=keys.device)
                keys.index_copy_(0, rows, k.to(keys.device))
                vals = self.replica_values[r][s]
                vals.index_copy_(0, rows, v.to(vals.device))

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
        held = self._read_shards(self.replica_keys)
        for s in np.unique(ub // bps):
            sel = ub // bps == s
            keys = held[s]
            if keys is None:            # another process's shard
                continue
            rows = keys[torch.as_tensor(ub[sel] - s * bps,
                                        device=keys.device)].cpu()
            fill[sel] = (rows != -1).any(-1).sum(-1).numpy()
        if self.mesh.model_split:
            # every process's fills (a collective: a pending overflow is
            # drained at the same op on every process)
            from multiverso_tpu_torch.parallel import multihost
            fill = multihost.allgather_i64(fill).max(0)
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
        return self._get_with_buckets(keys, self._buckets_of(keys))

    def _get_with_buckets(self, keys: np.ndarray, lane_buckets: np.ndarray
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dispatch half of a Get for per-lane bucket ids already in the
        DEVICE geometry: the seam the tiered store drives after it has
        translated logical buckets to resident device slots
        (``storage/tiered_kv.py``); :meth:`get_tensor` is the identity
        translation."""
        n = len(keys)
        t0 = time.monotonic()
        with tracing.span("table.get", table=f"{self.table_id}:{self.name}",
                          n=n):
            elems = n * max(self.value_dim, 1)
            self._record_op("get", elems, elems * self.dtype.itemsize)
            query, local, inv = self._get_lanes(keys, lane_buckets)
            vals, found = self._lookup(
                self._read_shards(self.replica_keys),
                self._read_shards(self.replica_values), query, local, inv,
                self.default_value, merge=self._merger)
            if len(inv) != n:
                vals, found = vals[:n], found[:n]
        self._h_get.observe(time.monotonic() - t0)
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
        # the lookup launches over the shards held here only
        devs = [None if t is None else t.device
                for t in self._read_shards(self.replica_keys)]
        return (lanes_on(_keys_device(sl_query), devs),
                lanes_on(sl_local, devs),
                torch.as_tensor(inv, device=self.device))

    def get(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """Batched lookup -> (values, found) on the host; missing keys give
        ``default_value``. A bfloat16 table's values come as float32
        (numpy has no bfloat16; the widening is exact)."""
        vals, found = self.get_tensor(keys)
        if vals.dtype == torch.bfloat16:
            vals = vals.float()
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
        deltas = chaos_corrupt("table.add", deltas)
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
        elems = int(np.prod(tuple(deltas.shape)))
        host_buckets = lane_buckets
        shard_ids = lane_buckets // bps
        local = (lane_buckets - shard_ids * bps).astype(np.int32)
        if self._cross:
            # this process probes and commits the lanes of the cells it
            # owns (module doc); the others' lanes go nowhere
            mine = self._committer(shard_ids, local) == self.mesh.rank
            keys, shard_ids, local = keys[mine], shard_ids[mine], local[mine]
            deltas = deltas[torch.as_tensor(mine, device=deltas.device)] \
                if isinstance(deltas, torch.Tensor) else deltas[mine]
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
        devs = [None if t is None else t.device
                for t in self._read_shards(self.replica_keys)]
        put = lambda a: lanes_on(a, devs)
        return PreparedKVAdd(
            buckets=put(sliced[0]), query=put(_keys_device(sliced[1])),
            deltas=put(sl_deltas), valid=put(valid), option=opt,
            host_buckets=host_buckets, counts=counts, elems=elems,
            nbytes=elems * self.dtype.itemsize)

    def _committer(self, shard_ids: np.ndarray,
                   local: np.ndarray) -> np.ndarray:
        """The process that commits each lane (shard, local bucket): the
        owner of the shard's row-0 cell, or under shard_update of the
        cell of the state block that holds the bucket."""
        m = self.mesh
        rows = local // (self._buckets_per_shard // self.n_data) \
            if self.shard_update else np.zeros_like(local)
        return (rows.astype(np.int64) * m.devices.shape[1]
                + shard_ids) // m.per_process

    def add_prepared(self, prepared: PreparedKVAdd,
                     sync: bool = False) -> Handle:
        """Device half of an Add: one fused probe + updater apply on the
        staged batch, written to every replica. The overflow count stays
        on the device until a later table op reads it."""
        self._poll_overflow()
        t0 = time.monotonic()
        with tracing.span("table.add", table=f"{self.table_id}:{self.name}",
                          sync=sync):
            self._record_op("add", prepared.elems, prepared.nbytes)
            _health.observe_update(self, prepared.deltas)
            n_over = self._commit(prepared)
            _health.observe_param(self, self.value_shards)
            self._events = _record_events(
                [d for devs in self.replica_devices for d in devs])
            # a count brought through the host is read at once, on every
            # process at the same op
            self._pending_over.append((n_over, [] if self._cross
                                       else self._events,
                                       prepared.host_buckets))
            with self._option_lock:
                self.default_option.step += 1
                self.generation += 1
                gen = self.generation
            self._notify_views()
            handle = Handle(table=self, generation=gen)
            if sync:
                handle.wait()
        self._h_add.observe(time.monotonic() - t0)
        return handle

    def _copies(self) -> List[Tuple[list, list, list]]:
        """The copies the commit writes, ``(keys, values, states)`` shard
        lists: under shard_update one per global data row (the kernel
        finds a bucket's state block by row), else one per local replica.
        A cell this process does not own takes a local copy of its shard
        in its place (the commit then writes the same cell twice, and
        never reads that copy's state: its lanes are another process's),
        or None where no local replica holds the shard."""
        held = [self._read_shards(c) for c in (
            self.replica_keys, self.replica_values, self.replica_states)]
        rows = range(self.n_data) if self.shard_update \
            else self.replica_ids
        out = []
        for g in rows:
            r = self.replica_ids.index(g) if g in self.replica_ids else None
            out.append(tuple(
                [h[s] if r is None or mine[r][s] is None else mine[r][s]
                 for s in range(len(self.devices))]
                for h, mine in zip(held, (self.replica_keys,
                                          self.replica_values,
                                          self.replica_states))))
        return out

    def _gate(self, local: torch.Tensor) -> torch.Tensor:
        """Every process's overflow count, from this process's (a
        collective through the host, after this process's probes)."""
        from multiverso_tpu_torch.parallel import multihost
        total = int(multihost.allgather_i64([int(local.sum())]).sum())
        return torch.tensor([total], dtype=torch.int32,
                            device=local.device)

    def _commit(self, prepared: PreparedKVAdd) -> torch.Tensor:
        """The probe + commit of an add on this process's copies; returns
        the overflow count (0-d; on the device, or on the host when lanes
        are committed by one process each: then the gate is every
        process's, and the written cells go to the processes that hold
        other copies, module doc)."""
        copies = self._copies()
        cells: list = [] if self._shared else None
        n_over = self._probe_update(
            *copies[0], prepared.buckets, prepared.query, prepared.deltas,
            prepared.valid, prepared.option, self.updater,
            counts=prepared.counts, replicas=copies[1:],
            state_blocks=self.shard_update,
            gate=self._gate if self._cross else None,
            cells=cells)[3]
        if not self._cross:
            return n_over
        n_over = n_over.cpu()
        if cells is not None and not int(n_over):
            self._exchange_cells(cells)
        return n_over

    def _exchange_cells(self, cells: list) -> None:
        """Send the cells this process wrote, ``(global bucket, slot)``
        pairs, with their keys and values (and state when every copy
        holds it) to every process; write the other processes' cells
        into each local copy of their shards (a collective)."""
        from multiverso_tpu_torch.parallel import multihost
        bps = self._buckets_per_shard
        dev = self.device
        bw = torch.cat([c[0].to(dev) for c in cells]) if cells \
            else torch.zeros(0, dtype=torch.int64, device=dev)
        sw = torch.cat([c[1].to(dev) for c in cells]) if cells \
            else torch.zeros(0, dtype=torch.int64, device=dev)
        names = [] if self.shard_update else state_keys(self._state0())
        held = [self._read_shards(c) for c in (
            self.replica_keys, self.replica_values, self.replica_states)]
        vtail = (self.value_dim,) if self.value_dim else ()
        out = [bw, sw.to(torch.int32),
               torch.empty((len(bw), 2), dtype=torch.int32, device=dev),
               torch.empty((len(bw),) + vtail, dtype=self.dtype,
                           device=dev)] + \
            [torch.empty((len(bw),) + vtail, dtype=torch.float32,
                         device=dev) for _ in names]
        shard = bw // bps
        for s in torch.unique(shard).tolist():
            sel = shard == s
            k, v, st = (h[s] for h in held)
            b, sl = (bw[sel] - s * bps).to(k.device), sw[sel].to(k.device)
            out[2][sel] = k[b, sl].to(dev)
            out[3][sel] = v[b, sl].to(dev)
            for i, name in enumerate(names):
                out[4 + i][sel] = st[name][b, sl].to(dev)
        got = multihost.allgather_tensors(out)
        for p, theirs in enumerate(got):
            if p == self.mesh.rank or not len(theirs[0]):
                continue
            bw_p, sw_p = theirs[0], theirs[1].long()
            shard = bw_p // bps
            for s in torch.unique(shard).tolist():
                sel = shard == s
                for r in range(self.n_replicas):
                    k = self.replica_keys[r][s]
                    if k is None:
                        continue
                    d = k.device
                    b, sl = (bw_p[sel] - s * bps).to(d), sw_p[sel].to(d)
                    k[b, sl] = theirs[2][sel].to(d)
                    self.replica_values[r][s][b, sl] = theirs[3][sel].to(d)
                    for i, name in enumerate(names):
                        self.replica_states[r][s][name][b, sl] = \
                            theirs[4 + i][sel].to(d)

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
        """Number of live keys (counted on the devices; over the group
        when the model axis crosses processes, each shard by the owner of
        its row-0 cell)."""
        self._check_overflow()
        m = self.mesh
        held = self._read_shards(self.replica_keys)
        n = sum(int((k != -1).any(-1).sum()) for s, k in enumerate(held)
                if k is not None and (not m.model_split
                                      or m.owner(0, s) == m.rank))
        if m.model_split:
            from multiverso_tpu_torch.parallel import multihost
            n = int(multihost.allgather_i64([n]).sum())
        return n

    def snapshot_kv_async(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Light copies of replica 0's (keys, values) for read replicas:
        device copies of the shards concatenated (a fresh tensor even on
        one shard), queued on the current stream, so the next in-place
        add cannot reach them. Unlike :meth:`export_checkpoint_async` this
        does NOT flush coalescers or read the overflow flags — it is a
        dispatch-thread hot-path call and must never block or raise for
        unrelated pending adds."""
        cat = lambda ts: torch.cat([t.to(self.device) for t in ts])
        return cat(self.key_shards), cat(self.value_shards)

    # -- checkpoint --------------------------------------------------------

    def export_checkpoint_async(self):
        """Checkpoint export split like ``Table.export_checkpoint_async``:
        the dispatch half here (a pending overflow raises first, then the
        keys, values and every state leaf are queued into pinned host
        buffers, :class:`~multiverso_tpu_torch.tables.base.HostCopy`, the
        parts other processes hold gathered first, on this thread), the
        blocking half in the returned ``finish()``."""
        self.flush_coalesced()
        self._check_overflow()
        key_parts, val_parts, state_parts = self._global_parts()
        keys = HostCopy(key_parts)
        vals = HostCopy(val_parts)
        leaves = [HostCopy(state_parts[k])
                  for k in state_keys(self._state0())]
        manifest = {"magic": KV_MAGIC, "name": self.name,
                    "capacity": self.capacity, "value_dim": self.value_dim,
                    "slots": self.slots, "num_buckets": self.num_buckets,
                    "dtype": self.dtype_name,
                    "updater": self.updater.name,
                    "step": self.default_option.step}

        def finish():
            host_keys = keys.numpy().view(np.uint32)
            # slots fill contiguously (no deletion), so fill = live count
            fill = (~(host_keys == 0xFFFFFFFF).all(-1)).sum(-1)
            host_vals = vals.numpy()
            if vals.host.dtype == torch.bfloat16:
                # the reference's bfloat16 array, as numpy writes it: two
                # bytes a value with no numpy type name
                host_vals = host_vals.view(np.dtype("V2"))
            payload = {"keys": host_keys, "values": host_vals,
                       "bucket_fill": fill.astype(np.int32)}
            for i, leaf in enumerate(leaves):
                payload[f"state_{i}"] = leaf.numpy()
            manifest["n_state_leaves"] = len(leaves)
            self._record_op("store", payload["values"].size,
                            sum(a.nbytes for a in payload.values()))
            return manifest, payload
        return finish

    def store(self, uri: str) -> None:
        manifest, payload = self.export_checkpoint_async()()
        savez_stream(uri, manifest, payload)

    def load(self, uri: str) -> None:
        # buffered deltas and a pending overflow are about the pre-load
        # state: flush and raise them first
        self.flush_coalesced()
        self._check_overflow()
        manifest, data = loadz_stream(uri, KV_MAGIC)
        for field, mine in (("value_dim", self.value_dim),
                            ("dtype", self.dtype_name)):
            if manifest[field] != mine:
                raise ValueError(
                    f"kv table {field} mismatch: checkpoint "
                    f"{manifest[field]!r} != table {mine!r}")
        if manifest["updater"] != self.updater.name:
            raise ValueError(
                f"checkpoint updater {manifest['updater']!r} != "
                f"{self.updater.name!r}")
        names = state_keys(self._state0())
        if int(manifest["n_state_leaves"]) != len(names):
            raise ValueError(
                f"checkpoint has {manifest['n_state_leaves']} state "
                f"leaves, updater {self.updater.name!r} has {len(names)}")
        new_buckets = self.num_buckets
        host_keys = data["keys"]
        host_vals = host_values(data["values"], self.dtype)
        host_state = [data[f"state_{i}"] for i in range(len(names))]
        if manifest["num_buckets"] != self.num_buckets \
                or manifest["slots"] != self.slots:
            new_buckets, host_keys, host_vals, host_state = \
                self._rehash_checkpoint(manifest, host_keys, host_vals,
                                        host_state)
        grown = new_buckets != self.num_buckets
        if grown:
            self._buckets_per_shard = new_buckets // len(self.devices)
        self._record_op("load", data["values"].size,
                        data["keys"].nbytes + data["values"].nbytes)
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
        self._notify_views()

    def _rehash_checkpoint(self, manifest, ck_keys, ck_vals, ck_state):
        """Re-insert a checkpoint's live (key, value, state) triples
        (values in host form, :func:`host_values`) into this table's
        (num_buckets, slots) geometry, on the host. Within a bucket the
        slots follow the checkpoint's bucket-major order. If a bucket
        would overflow, the bucket count doubles until every key fits (it
        stays a multiple of the shard count, of shards x replicas under
        shard_update). Returns (num_buckets, keys, values, state leaves)
        without touching the table."""
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

        new_vals = remap(ck_vals, host_values(
            np.float32(self.default_value), self.dtype))
        new_state = [remap(leaf, 0) for leaf in ck_state]
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
