"""Table base: the Worker/Server table contract on device tensors split
over the mesh's model axis.

Counterpart of ``multiverso_tpu/tables/base.py``:

- ``WorkerTable::Get/Add/GetAsync/AddAsync/Wait`` -> :meth:`Table.get`,
  :meth:`Table.add`, :meth:`Table.get_async` (a :class:`Handle`),
  :meth:`Table.wait`.
- ``ServerTable::ProcessAdd`` through the Updater -> the updater's pure
  ``apply(param, state, delta, option)`` on the table's tensors.
- ``ServerTable::Store/Load`` -> :meth:`Table.store` / :meth:`Table.load`,
  in the reference's checkpoint format (an ``.npz`` of a JSON manifest and
  the padded arrays, each stamped with its CRC32), through the URI stream
  layer (``io/stream.py``: local files, ``mem://``, fsspec schemes) under
  the IO retry policy: a table stored by either package loads in the
  other. :meth:`Table.export_checkpoint_async` splits a store into a
  dispatch half (copies queued into pinned host memory) and a blocking
  half, the run checkpoint manager's overlap (``ft/checkpoint.py``).
- The ``table.get`` / ``table.add`` fault points of ``ft/chaos.py`` and
  the numerics audit of ``telemetry/health.py`` sit where the reference
  puts them.
- The client pipeline's hooks (``client/``): every generation bump wakes
  the attached cached views, and ops that must observe every issued delta
  (supersteps, store / load, the checkpoint export) flush the attached
  coalescing buffers first.

The leading dimension is padded as the reference pads it: to a multiple
of the model-axis size (of the model x data product under
``shard_update``), subclasses reserving scratch rows. Shard ``s`` holds
the contiguous row block ``s`` of the padded storage (the reference
shards its leading dimension over ``model`` the same way); a one-shard
mesh holds one tensor. On a mesh whose data axis D is above 1 a table
holds D replicas of that split, as the
reference replicates its tables over ``data``: replica ``d``'s shard
``s`` lives on the mesh device ``[d, s]``. Every write keeps the
replicas bit-identical, and a Get reads replica 0. Under
``shard_update`` (the reference's weight-update sharding) the updater
state is split over (model, data) instead: replica ``d`` holds row block
``d`` of each shard's state, updates those rows only, and sends the
updated param rows to every replica. Over several processes (SPMD,
``core``'s module doc) a table holds the shards of its process's cells
only (:attr:`Table.replica_ids`, the global data rows in which it owns a
cell; a shard of another process's cell is None in ``replicas[d]``, and
nothing is allocated for it): every process calls every op with the
same host values, an add updates the local shards, and under
``shard_update`` the row blocks other processes updated, and the state
blocks a checkpoint needs, come over
:func:`~multiverso_tpu_torch.parallel.multihost.allgather_tensors`. A Get
reads each shard from the first local replica that holds it; when the
model axis crosses processes (``mesh.model_split``) the shards no local
replica holds come over the group from row 0's owner of each (a
collective), and a row gather ORs each process's partial
(:func:`~multiverso_tpu_torch.parallel.multihost.or_partials`). Every
process writes a checkpoint's file, with the same bytes (the stream
layer's atomic rename), as the reference's ranks do. The logical
shape is what the API shows. ``storage_shape`` is the physical layout of
the param: the padded shape, or a re-tiled view of it (``[R, C/128, 128]``
for a tiled SparseMatrixTable); checkpoints always hold the global padded
shape, whatever the shard count, so a table stored on S shards is
byte-identical to the reference's on S shards and loads on any other.
"""

from __future__ import annotations

import io
import json
import threading
import time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.ft.chaos import chaos_corrupt, chaos_point
from multiverso_tpu_torch.io import open_stream
from multiverso_tpu_torch.ops.table_kernels import ShardedParam
from multiverso_tpu_torch.telemetry import health as _health
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry import trace as tracing
from multiverso_tpu_torch.telemetry.profiling import profiled
from multiverso_tpu_torch.updaters import (AddOption, Updater, get_updater,
                                           resolve_default_option)
from multiverso_tpu_torch.utils import configure, log

CHECKPOINT_MAGIC = "multiverso_tpu.table.v1"


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype (name), of ``"bfloat16"`` (which
    numpy lacks) and of a torch dtype itself."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name of a table type (numpy's, or ``"bfloat16"``),
    as checkpoint manifests carry it."""
    return str(dtype).replace("torch.", "")


# -- checkpoint format ---------------------------------------------------------


def _payload_crc32(arr: np.ndarray) -> int:
    """CRC32 over an array's raw bytes (C order)."""
    return int(zlib.crc32(np.ascontiguousarray(arr).tobytes()))


def savez_stream(uri: str, manifest: Dict[str, Any],
                 payload: Dict[str, np.ndarray]) -> None:
    """Write an npz (manifest json + arrays) through the stream layer, the
    manifest stamped with a per-array CRC32. The write is atomic in the
    stream layer (a local file lands in a temp file renamed into place)
    and guarded by the env-configured IO retry policy
    (:func:`~multiverso_tpu_torch.ft.retry.io_retry_policy`)."""
    from multiverso_tpu_torch.ft.retry import io_retry_policy
    manifest = dict(manifest)
    manifest["crc32"] = {k: _payload_crc32(v) for k, v in payload.items()}
    buf = io.BytesIO()
    np.savez(buf, manifest=json.dumps(manifest), **payload)
    data = buf.getvalue()

    def write() -> None:
        with open_stream(uri, "wb") as stream:
            stream.write(data)
    io_retry_policy("io.store").call(write)


def loadz_stream(uri: str, magic: str):
    """Read an npz through the stream layer (under the IO retry policy);
    validate its manifest magic and the per-array CRC32 checksums (when
    present). Returns (manifest dict, npz data)."""
    from multiverso_tpu_torch.ft.retry import io_retry_policy

    def read() -> bytes:
        with open_stream(uri, "rb") as stream:
            return stream.read()
    data = np.load(io.BytesIO(io_retry_policy("io.load").call(read)),
                   allow_pickle=False)
    try:
        manifest = json.loads(str(data["manifest"]))
    except Exception:
        raise ValueError(f"{uri!r} is not a multiverso_tpu checkpoint "
                         "(no manifest)") from None
    if manifest.get("magic") != magic:
        raise ValueError(f"{uri!r}: checkpoint magic "
                         f"{manifest.get('magic')!r} != expected {magic!r}")
    for key, want in (manifest.get("crc32") or {}).items():
        if key not in data:
            raise ValueError(
                f"{uri!r}: checkpoint is torn — manifest lists payload "
                f"{key!r} but the archive lacks it")
        got = _payload_crc32(data[key])
        if got != int(want):
            raise ValueError(
                f"{uri!r}: payload {key!r} checksum mismatch "
                f"(crc32 {got:#010x} != manifest {int(want):#010x}) — "
                "the checkpoint is torn or bit-rotted")
    return manifest, data


def state_keys(state: Dict[str, torch.Tensor]) -> List[str]:
    """Updater-state leaves in checkpoint order: the reference stores a
    dict state's leaves sorted by key (``jax.tree.leaves``)."""
    return sorted(state)


# -- handles -------------------------------------------------------------------


def _record_events(devices) -> List[torch.cuda.Event]:
    """CUDA events marking the work queued so far on each distinct card of
    ``devices`` (none for the CPU, where every op has finished when it
    returns)."""
    events = []
    for dev in dict.fromkeys(devices):
        if dev is not None and dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
    return events


class HostCopy:
    """Tensors queued into one host buffer: the dispatch half of a
    checkpoint export.

    The flattened elements of ``parts``, in order, make up an array of
    ``shape`` (default: the parts stacked along their first dimension).
    Each part is copied with ``non_blocking`` into its slice of one host
    tensor (pinned when a part lives on a card), and an event is recorded
    on each card's current stream after its copies. :meth:`numpy` waits
    on those events and returns the host array; it touches no CUDA tensor,
    so a writer thread may call it.

    Stream order keeps the copy whole although the port's kernels write
    tables in place: every op of the port queues on each card's current
    stream, which no module of the port changes (a replica thread only
    enters ``torch.cuda.device``), and a stream runs its work in order. So
    no add queued after the copies, from any thread, writes the bytes
    before the copy has read them. A caller that queues table work on a
    stream of its own must make that stream wait on :attr:`events` first.
    """

    def __init__(self, parts: Sequence[torch.Tensor],
                 shape: Optional[Tuple[int, ...]] = None) -> None:
        parts = list(parts)
        if shape is None:
            shape = (sum(int(t.shape[0]) for t in parts),) \
                + tuple(parts[0].shape[1:])
        self.shape = tuple(int(d) for d in shape)
        self.host = torch.empty(
            int(np.prod(self.shape)), dtype=parts[0].dtype,
            pin_memory=any(t.is_cuda for t in parts))
        off = 0
        for t in parts:
            n = t.numel()
            self.host[off:off + n].copy_(t.reshape(-1), non_blocking=True)
            off += n
        if off != self.host.numel():
            raise ValueError(f"parts of {off} elements for shape "
                             f"{self.shape}")
        self.events = _record_events([t.device for t in parts])

    def numpy(self) -> np.ndarray:
        """The host array, once the copies are done (bfloat16 as its
        uint16 bit patterns, which numpy can hold)."""
        for event in self.events:
            event.synchronize()
        host = self.host.view(self.shape)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(np.uint16)
        return host.numpy()


def _placed(blocks, devices, copy: bool) -> List[torch.Tensor]:
    """Row blocks (numpy, copied, or tensors) as contiguous tensors, block
    i on ``devices[i]``; a tensor block is a copy when ``copy``, else it
    may share its storage. A None device (a cell of another process)
    gets None."""
    if blocks and isinstance(blocks[0], np.ndarray):
        return [None if d is None else torch.tensor(b, device=d)
                for b, d in zip(blocks, devices)]
    return [None if d is None else b.to(d, copy=copy).contiguous()
            for b, d in zip(blocks, devices)]


def lanes_on(lanes, devices: List[torch.device]):
    """A ``(shards, L, ...)`` lane array (numpy or tensor) on the shards'
    devices: one tensor when they share one device, else a list of
    per-shard rows, row s on ``devices[s]`` (the sharded kernel forms take
    either); a shard of another process (None) gets no row."""
    held = {d for d in devices if d is not None}
    if len(held) == 1:
        return torch.as_tensor(lanes, device=held.pop())
    return [None if dev is None else torch.as_tensor(row, device=dev)
            for row, dev in zip(lanes, devices)]


class Handle:
    """Async completion handle (the reference's Waiter).

    - A **get-handle** wraps a snapshot tensor (or a tuple of them);
      ``wait()`` blocks until it is computed and returns it.
    - An **add-handle** records the table and the *generation* its update
      produced. Updates apply in stream order, so once the table's queued
      work is done every generation up to the current one has landed;
      ``wait()`` returns the CURRENT param tensor (the list of shards for
      a sharded table), which is this handle's result only while it is
      the latest update (see :meth:`superseded`).
    """

    def __init__(self, values: Any = None, *, table: "Table" = None,
                 generation: Optional[int] = None) -> None:
        if (values is None) == (table is None):
            raise ValueError("Handle wraps either snapshot values or a "
                             "(table, generation) pair")
        self._values = values
        self._table = table
        self._generation = generation
        first = values[0] if isinstance(values, tuple) else values
        self._events = _record_events([first.device]) \
            if isinstance(first, torch.Tensor) else []

    @property
    def generation(self) -> Optional[int]:
        return self._generation

    def superseded(self) -> bool:
        """True when a later update has been applied to the table."""
        return (self._table is not None
                and self._table.generation > self._generation)

    def done(self) -> bool:
        """Non-blocking completion check (add-handles: of the table's
        latest queued update)."""
        events = self._events if self._table is None else self._table._events
        return all(e.query() for e in events)

    def wait(self) -> Any:
        if self._table is None:
            for e in self._events:
                e.synchronize()
            return self._values
        self._table.wait()
        return self._table._live_value()

    def result(self) -> Any:
        return self.wait()


# -- the table -------------------------------------------------------------------


class Table:
    """Base class owning the param (+ updater state) of a table, split
    over the mesh's model axis: ``shards[s]`` holds rows
    ``[s * rows_per_shard, (s + 1) * rows_per_shard)`` of the padded
    storage on ``devices[s]``, ``shard_states[s]`` its updater state. On
    a one-shard mesh ``param`` and ``state`` are that shard's tensors.

    On a mesh with a data axis D above 1 a replicated table (``REPLICATED``)
    holds D copies of that split: ``replicas[d]`` on
    ``replica_devices[d]`` (data row ``d``), ``replica_states[d]`` their
    updater state; ``shards`` / ``shard_states`` are replica 0's. Over
    several processes the lists hold this process's replicas only, local
    ``i`` being data row ``replica_ids[i]`` of ``n_data``."""

    #: whether the table holds a replica per row of the data axis (every
    #: table does)
    REPLICATED = True

    def __init__(self, name: str, shape: Tuple[int, ...], dtype: Any,
                 *, updater: Optional[str] = None,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None,
                 init_value: Any = 0,
                 default_option: Optional[AddOption] = None,
                 shard_update: bool = False) -> None:
        self.name = name
        self.mesh = core.resolve_mesh(mesh, device)
        #: the global data rows of this process's replicas, and D
        self.replica_ids = list(self.mesh.local_rows) if self.REPLICATED \
            else [self.mesh.local_rows[0]]
        self.n_data = self.mesh.shape[core.DATA_AXIS] \
            if self.REPLICATED else 1
        n_replicas = self.n_data
        self.replica_devices = [self.mesh.replica_devices(d)
                                for d in self.replica_ids]
        self.devices = self.replica_devices[0]
        self.device = self.mesh.row_device(self.replica_ids[0])
        self.logical_shape = tuple(int(s) for s in shape)
        self.np_dtype = np.dtype(dtype)
        self.dtype = torch_dtype(self.np_dtype)
        updater_name = updater if updater is not None \
            else configure.get_flag("updater_type")
        self.updater: Updater = get_updater(updater_name)
        self.default_option = resolve_default_option(updater_name,
                                                     default_option)
        self._option_lock = threading.Lock()
        # update counter behind the Handle generation contract (bumped on
        # every applied update / load)
        self.generation = 0
        # client-pipeline hooks (weakrefs — a dropped CachedView or
        # CoalescingBuffer must not be pinned by its table): views are
        # woken on every generation bump so their background refresh
        # starts at the update, not at the next read; coalescers are
        # flushed by ops that must observe every buffered delta
        # (supersteps, store/load)
        self._view_refs: List[weakref.ref] = []
        self._coalescer_refs: List[weakref.ref] = []
        # weight-update sharding: the updater state split over (model,
        # data), each replica updating its rows; a no-op without a data axis
        self.shard_update = bool(shard_update) and n_replicas > 1
        # the lead pads to a multiple of the model-axis size, of the model
        # x data product under shard_update (subclasses reserve scratch
        # rows); dense checkpoints repad across paddings
        lead = self.logical_shape[0] if self.logical_shape else 1
        n_shards = len(self.devices)
        mult = n_shards * n_replicas if self.shard_update else n_shards
        self.padded_shape = (self._pad_lead(lead, mult),) \
            + self.logical_shape[1:]
        self._rows_per_shard = self.padded_shape[0] // n_shards
        self.storage_shape = self.padded_shape
        if np.isscalar(init_value):
            self.replicas = [core.sharded_zeros(self.padded_shape,
                                                self.dtype, devs)
                             for devs in self.replica_devices]
            if init_value != 0:
                for shards in self.replicas:
                    for t in shards:
                        if t is not None:
                            t.fill_(init_value)
        else:
            init = self._pad(np.asarray(init_value))
            self.replicas = [self._split(init, devs)
                             for devs in self.replica_devices]
        self.replica_states = [
            [None if p is None else self.updater.init_state(p)
             for p in self._state_rows(d)]
            for d in range(len(self.replica_ids))]
        self._events: list = []
        # profiled: profile.calls{fn=table.apply.<name>} is the dispatch
        # count of the Add path, profile.calls{fn=table.snapshot.<name>}
        # of the whole-table Get (the reference's names)
        self._apply = profiled(self._apply_delta, f"table.apply.{name}")
        self._snapshot = profiled(self.logical_tensor,
                                  f"table.snapshot.{name}")
        self.table_id = _register(self)
        lbl = f"{self.table_id}:{self.name}"
        # tail-latency histograms over the Get/Add paths (the SLO
        # monitor's table.{get,add}.p99 targets)
        self._h_get = telemetry.histogram(
            "table.get.seconds", telemetry.LATENCY_BUCKETS, table=lbl)
        self._h_add = telemetry.histogram(
            "table.add.seconds", telemetry.LATENCY_BUCKETS, table=lbl)
        log.debug("table %r id=%d shape=%s padded=%s updater=%s on %s",
                  name, self.table_id, self.logical_shape,
                  self.padded_shape, self.updater.name,
                  [[str(d) for d in devs] for devs in self.replica_devices])

    # -- helpers -----------------------------------------------------------

    def _record_op(self, op: str, elems: int, nbytes: int) -> None:
        """Per-table op accounting: ``table.<op>.{ops,elems,bytes}``
        keyed by ``table=<id>:<name>``, what the Get/Add/Store/Load
        contract moved. KVTable (not a subclass) shares it, as in the
        reference."""
        lbl = f"{self.table_id}:{self.name}"
        telemetry.counter(f"table.{op}.ops", table=lbl).inc()
        telemetry.counter(f"table.{op}.elems", table=lbl).inc(int(elems))
        telemetry.counter(f"table.{op}.bytes", table=lbl).inc(int(nbytes))

    def _elems(self) -> int:
        """Elements of the logical shape (what a whole-table op moves)."""
        return int(np.prod(self.logical_shape)) if self.logical_shape \
            else 1

    def _pad_lead(self, lead: int, shards: int) -> int:
        return -(-lead // shards) * shards

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        if arr.shape == self.padded_shape:
            return arr.astype(self.np_dtype, copy=False)
        if arr.shape != self.logical_shape:
            raise ValueError(f"table {self.name!r}: value shape {arr.shape} "
                             f"!= table shape {self.logical_shape}")
        pad = [(0, p - l) for p, l in zip(self.padded_shape, arr.shape)]
        return np.pad(arr.astype(self.np_dtype, copy=False), pad)

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def shards(self) -> List[torch.Tensor]:
        """Replica 0's shards (the only replica off a data axis)."""
        return self.replicas[0]

    @property
    def shard_states(self) -> List[Dict[str, torch.Tensor]]:
        """Replica 0's updater state, shard by shard (under shard_update,
        the row block of each shard's state that replica 0 holds)."""
        return self.replica_states[0]

    def _split(self, whole, devices: Optional[List[torch.device]] = None,
               copy: bool = False) -> List[torch.Tensor]:
        """A value of the padded (or storage) shape, numpy (copied) or a
        tensor, cut into ``len(devices)`` (default: the shards') equal
        row blocks, block i on ``devices[i]``; a tensor's block is a copy
        when ``copy``, else it may share the tensor's storage."""
        devices = self.devices if devices is None else devices
        rows = whole.shape[0] // len(devices)
        return _placed([whole[i * rows:(i + 1) * rows]
                        for i in range(len(devices))], devices, copy)

    def _replicate(self, whole) -> List[List[torch.Tensor]]:
        """A padded (or storage-shaped) value as every replica's shards:
        replica 0's may share a tensor's storage, the others copy it."""
        return [self._split(whole, devs, copy=d > 0)
                for d, devs in enumerate(self.replica_devices)]

    def _state_rows(self, replica: int) -> List[torch.Tensor]:
        """The rows of each of ``replica``'s shards whose updater state it
        holds: every row, or row block ``replica`` of the shard under
        shard_update (the reference's state split over (model, data))."""
        shards = self.replicas[replica]
        if not self.shard_update:
            return list(shards)
        q = self._rows_per_shard // self.n_data
        g = self.replica_ids[replica]
        return [None if p is None else p[g * q:(g + 1) * q] for p in shards]

    def _state_split(self, whole, replica: int) -> List[torch.Tensor]:
        """A padded state leaf (numpy or tensor) as the blocks ``replica``
        holds, one per shard on its device (the inverse of
        :meth:`_state_parts`)."""
        devs = self.replica_devices[replica]
        if not self.shard_update:
            return self._split(whole, devs, copy=True)
        # the (model, data) split: block s * D + d is replica d's of shard s
        n, g = self.n_data, self.replica_ids[replica]
        rows = whole.shape[0] // (len(devs) * n)
        return _placed([whole[(s * n + g) * rows:
                              (s * n + g + 1) * rows]
                        for s in range(len(devs))], devs, copy=True)

    def _state_leaf(self, key: str) -> torch.Tensor:
        """An updater-state leaf as one padded tensor on the first device
        (:meth:`_state_parts` concatenated)."""
        return self._whole([t.to(self.device)
                            for t in self._state_parts(key)])

    def _whole(self, shards: Optional[List[torch.Tensor]] = None
               ) -> torch.Tensor:
        """The shards (default: :meth:`_read_shards`, filled in over the
        group) as one tensor on the first device: the live shard on a
        one-shard mesh, their concatenation otherwise."""
        shards = self._filled(self._read_shards()) if shards is None \
            else shards
        if len(shards) == 1:
            return shards[0]
        return torch.cat([t.to(self.device) for t in shards])

    def _read_shards(self, copies=None) -> list:
        """Each shard of ``copies`` (default: the replicas' storage; or
        the replicas' lists of any per-shard value) from the first local
        replica that holds it; None where no local replica does."""
        copies = self.replicas if copies is None else copies
        return [next((c[s] for c in copies if c[s] is not None), None)
                for s in range(len(self.devices))]

    def _filled(self, shards: list) -> list:
        """``shards`` (a per-shard list from :meth:`_read_shards`) with
        every None filled in by the process that owns row 0's cell of that
        shard (CPU tensors, :meth:`_fill_remote` over row 0): a COLLECTIVE
        when the model axis crosses processes, else ``shards`` itself."""
        if not self.mesh.model_split:
            return shards
        blocks = [[t] for t in shards]
        self._fill_remote(blocks, rows=[0])
        return [t if t is not None else b[0]
                for t, b in zip(shards, blocks)]

    def _merge(self, outs: tuple) -> None:
        """OR every process's partial of a row read into ``outs`` (a
        table whose model axis crosses processes; a collective)."""
        from multiverso_tpu_torch.parallel import multihost
        multihost.or_partials(outs)

    @property
    def _merger(self):
        """The cross-process merge of a row read: :meth:`_merge` when the
        model axis crosses processes, else None."""
        return self._merge if self.mesh.model_split else None

    def _state0(self) -> Dict[str, torch.Tensor]:
        """An updater-state dict held here (its keys name the leaves)."""
        return next(st for sts in self.replica_states for st in sts
                    if st is not None)

    def _one_shard(self, what: str) -> None:
        if len(self.shards) != 1:
            raise NotImplementedError(
                f"table {self.name!r} is split into {len(self.shards)} "
                f"shards; {what} is one tensor only on a one-shard mesh "
                "(use .shards / .shard_states)")

    def _one_replica(self, what: str) -> None:
        self._one_shard(what)
        if self.n_replicas != 1:
            raise NotImplementedError(
                f"table {self.name!r} holds {self.n_replicas} replicas; "
                f"set {what} through put_raw / load, which write them all")

    @property
    def param(self) -> torch.Tensor:
        """The storage tensor of a one-shard table (replica 0's)."""
        self._one_shard("param")
        return self.shards[0]

    @param.setter
    def param(self, value: torch.Tensor) -> None:
        self._one_replica("param")
        self.shards[0] = value

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The updater state of a one-shard table (replica 0's)."""
        self._one_shard("state")
        return self.shard_states[0]

    @state.setter
    def state(self, value: Dict[str, torch.Tensor]) -> None:
        self._one_replica("state")
        self.shard_states[0] = value

    def superstep_view(self, replica: int = 0) -> Tuple[Any, Dict[str, Any]]:
        """``(param, state)`` of one replica as a superstep body takes
        them: the shard's tensors on a one-shard table; on a split one a
        :class:`~multiverso_tpu_torch.ops.table_kernels.ShardedParam` of
        the shards, and the state as one ShardedParam per leaf (the
        reference's body sees the global arrays)."""
        shards, states = self.replicas[replica], self.replica_states[replica]
        if len(shards) == 1:
            return shards[0], states[0]
        # a row split over processes merges its reads over the group (a
        # superstep over a data axis merges over the row's processes)
        merge = self._merge if self.mesh.rows_split else None
        return ShardedParam(shards, merge), {
            k: ShardedParam([None if st is None else st[k] for st in states],
                            merge) for k in self._state0()}

    def _take_shards(self, value, devices) -> List[torch.Tensor]:
        """A body's returned param (or state leaf) of a split table as its
        shards: a ShardedParam's own shards, or a whole tensor cut into
        row blocks on ``devices``."""
        if isinstance(value, ShardedParam):
            if len(value.shards) != len(devices):
                raise ValueError(
                    f"table {self.name!r}: a superstep returned "
                    f"{len(value.shards)} shards for {len(devices)}")
            return list(value.shards)
        return self._split(value, devices)

    def superstep_update(self, param: Any, state: Dict[str, Any],
                         replica: int = 0) -> None:
        """Take a superstep body's returned ``(param, state)`` back as one
        replica's storage (the inverse of :meth:`superstep_view`)."""
        devs = self.replica_devices[replica]
        if len(devs) == 1:
            self.replicas[replica][0] = param
            self.replica_states[replica][0] = state
            return
        self.replicas[replica] = self._take_shards(param, devs)
        leaves = {k: self._take_shards(v, devs) for k, v in state.items()}
        self.replica_states[replica] = [
            None if devs[s] is None else {k: v[s] for k, v in leaves.items()}
            for s in range(len(devs))]

    def _resolve_option(self, option: Optional[AddOption]) -> AddOption:
        opt = option if option is not None else self.default_option
        return opt.snapshot()

    def _bump_step(self) -> int:
        """Advance step + generation; returns the new generation (mint
        handles from it, not from a later read of ``self.generation``).
        Records the queued work of every replica's devices, which
        :meth:`wait` and the handles fence."""
        self._events = _record_events(
            [d for devs in self.replica_devices for d in devs])
        with self._option_lock:
            self.default_option.step += 1
            self.generation += 1
            gen = self.generation
        self._notify_views()
        return gen

    # -- client-pipeline hooks (multiverso_tpu_torch.client) ---------------

    def _attach_view(self, view: Any) -> None:
        """Register a CachedView for update notification (weakref)."""
        self._view_refs.append(weakref.ref(view))

    def _attach_coalescer(self, buf: Any) -> None:
        """Register a CoalescingBuffer so flush-demanding table ops
        (supersteps, store/load) can force its buffered deltas out."""
        self._coalescer_refs.append(weakref.ref(buf))

    def _notify_views(self) -> None:
        """Wake attached CachedViews: the generation advanced, so their
        background refresh should start NOW rather than at the next
        read. Must stay cheap — it runs on every applied update."""
        refs = self._view_refs
        if not refs:
            return
        live = []
        for r in refs:
            v = r()
            if v is not None:
                v._on_table_update()
                live.append(r)
        self._view_refs[:] = live

    def flush_coalesced(self) -> None:
        """Flush every attached CoalescingBuffer's pending deltas into
        the table. Called by ops whose contract requires observing all
        prior adds (fused supersteps before they read the storage,
        store/load around checkpoints); plain ``get`` does NOT call this
        — a buffered delta is invisible until its flush, the bounded-
        staleness semantics coalescing opts into."""
        refs = self._coalescer_refs
        if not refs:
            return
        live = []
        for r in refs:
            b = r()
            if b is not None:
                b.flush()
                live.append(r)
        self._coalescer_refs[:] = live

    # -- the Get/Add contract ---------------------------------------------

    def raw(self) -> torch.Tensor:
        """The padded param tensor of a one-shard table — LIVE table
        storage, updated in place by row adds and supersteps. Use
        :meth:`get_tensor` for a snapshot."""
        return self.param

    def put_raw(self, padded: torch.Tensor) -> None:
        """Replace table storage with a tensor of the storage shape and the
        table's dtype (split into the shards' blocks, each moved to its
        device); advances the generation. Updater state is untouched."""
        if tuple(padded.shape) != self.storage_shape:
            raise ValueError(
                f"table {self.name!r}: put_raw shape {tuple(padded.shape)} "
                f"!= storage shape {self.storage_shape}")
        if padded.dtype != self.dtype:
            raise ValueError(f"table {self.name!r}: put_raw dtype "
                             f"{padded.dtype} != table dtype {self.dtype}")
        self.replicas = self._replicate(padded)
        with self._option_lock:
            self.generation += 1
        self._notify_views()

    def _host_range(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the storage, on the host (a live reshard's
        chunk: the reference slices ``raw()``)."""
        return self._whole()[lo:hi].cpu().numpy()

    def _put_range(self, lo: int, values: np.ndarray) -> None:
        """Set rows [lo, lo + len(values)) of the storage on every
        replica, shard by shard; advances the generation as
        :meth:`put_raw` does (the reference writes ``raw()`` back whole).
        Updater state is untouched."""
        src = torch.from_numpy(np.ascontiguousarray(
            values, self.np_dtype))
        hi = lo + len(src)
        rows = self._rows_per_shard
        for shards in self.replicas:
            for s, shard in enumerate(shards):
                x, y = max(lo, s * rows), min(hi, (s + 1) * rows)
                if x < y and shard is not None:
                    shard[x - s * rows:y - s * rows] = \
                        src[x - lo:y - lo].to(shard.device)
        with self._option_lock:
            self.generation += 1
        self._notify_views()

    def put_views(self, views) -> None:
        """Replace each replica's storage with ``views[d]`` in the form
        :meth:`superstep_view` gives it (a tensor of the storage shape on
        a one-shard table, else a ShardedParam of its shards), on that
        replica's devices; advances the generation as :meth:`put_raw`
        does. Updater state is untouched."""
        if len(views) != self.n_replicas:
            raise ValueError(f"table {self.name!r}: {len(views)} views for "
                             f"{self.n_replicas} replicas")
        for d, view in enumerate(views):
            if view.dtype != self.dtype:
                raise ValueError(f"table {self.name!r}: put_views dtype "
                                 f"{view.dtype} != table dtype {self.dtype}")
            devs = self.replica_devices[d]
            self.replicas[d] = [view] if len(devs) == 1 \
                else self._take_shards(view, devs)
        with self._option_lock:
            self.generation += 1
        self._notify_views()

    def get_tensor(self) -> torch.Tensor:
        """The logical value (padding sliced off) as a fresh tensor on the
        first device."""
        chaos_point("table.get")
        t0 = time.monotonic()
        with tracing.span("table.get", table=f"{self.table_id}:{self.name}"):
            elems = self._elems()
            self._record_op("get", elems, elems * self.np_dtype.itemsize)
            _health.observe_param(self)
            out = self._snapshot()
        self._h_get.observe(time.monotonic() - t0)
        return out

    def logical_tensor(self) -> torch.Tensor:
        """What :meth:`get_tensor` returns, without its Get accounting:
        an app's own read of its table inside a computation (the
        reference reads ``raw()`` inside its jitted programs)."""
        return self._whole().view(self.padded_shape)[
            tuple(slice(0, l) for l in self.logical_shape)].clone()

    def get(self) -> np.ndarray:
        """Whole-table fetch to host (``WorkerTable::Get``)."""
        return self.get_tensor().cpu().numpy()

    def get_async(self) -> Handle:
        """Non-blocking whole-table Get: the handle wraps the device
        snapshot."""
        return Handle(self.get_tensor())

    def add(self, delta: Any, option: Optional[AddOption] = None,
            sync: bool = False) -> Handle:
        """``WorkerTable::Add``: fold a delta (numpy array or tensor, of
        the logical or padded shape) through the updater, shard by shard
        on every replica (under shard_update each replica its own row
        block of each shard, whose updated rows then go to every
        replica)."""
        chaos_point("table.add")
        delta = chaos_corrupt("table.add", delta)
        t0 = time.monotonic()
        with tracing.span("table.add", table=f"{self.table_id}:{self.name}",
                          sync=sync):
            if isinstance(delta, torch.Tensor):
                delta = delta.to(self.device)
                if tuple(delta.shape) == self.logical_shape \
                        and self.logical_shape != self.padded_shape:
                    pad = [0, 0] * (len(self.padded_shape) - 1) + \
                        [0, self.padded_shape[0] - self.logical_shape[0]]
                    delta = torch.nn.functional.pad(delta, pad)
                elif tuple(delta.shape) != self.padded_shape:
                    raise ValueError(f"table {self.name!r}: delta shape "
                                     f"{tuple(delta.shape)} != table shape "
                                     f"{self.logical_shape}")
            else:
                delta = self._pad(np.asarray(delta))
            elems = self._elems()
            self._record_op("add", elems, elems * self.np_dtype.itemsize)
            _health.observe_update(self, delta)
            self._apply(delta, self._resolve_option(option))
            _health.observe_param(self)
            handle = Handle(table=self, generation=self._bump_step())
            if sync:
                handle.wait()
        self._h_add.observe(time.monotonic() - t0)
        return handle

    def _apply_delta(self, delta, opt: AddOption) -> None:
        """The updater over a padded delta, shard by shard on every
        replica."""
        shard_padded = (self._rows_per_shard,) + self.padded_shape[1:]
        shard_storage = (self._rows_per_shard,) + self.storage_shape[1:]
        q = self._rows_per_shard // self.n_data
        # blocks[s][g]: shard s's rows [g * q, (g + 1) * q) as replica g
        # updated them under shard_update
        blocks = [[None] * self.n_data for _ in self.devices]
        for d, devs in enumerate(self.replica_devices):
            g = self.replica_ids[d]
            rows = slice(g * q, (g + 1) * q) if self.shard_update \
                else slice(None)
            for s, part in enumerate(self._split(delta, devs)):
                if part is None:        # another process's cell
                    continue
                states = self.replica_states[d]
                blk, states[s] = self.updater.apply(
                    self.replicas[d][s].view(shard_padded)[rows], states[s],
                    part.view(shard_padded)[rows], opt)
                if self.shard_update:
                    blocks[s][g] = blk
                else:
                    self.replicas[d][s] = blk.reshape(shard_storage)
        if self.shard_update:
            self._fill_remote(blocks)
            for devs, shards in zip(self.replica_devices, self.replicas):
                for s, dev in enumerate(devs):
                    if dev is not None:
                        shards[s] = torch.cat([b.to(dev)
                                               for b in blocks[s]]) \
                            .reshape(shard_storage)

    def _fill_remote(self, blocks: List[list],
                     rows: Optional[List[int]] = None,
                     shards: Optional[List[int]] = None) -> None:
        """``blocks[i][g]`` (``i`` the position of shard ``shards[i]``,
        default every shard), given for the cells ``[g, shard]`` this
        process owns among ``rows`` (default: every data row), filled in
        for every other process's cells (CPU tensors) by one all-gather
        (a collective; nothing on one process)."""
        m = self.mesh
        if m.processes == 1:
            return
        from multiverso_tpu_torch.parallel import multihost
        rows = range(self.n_data) if rows is None else rows
        shards = range(len(blocks)) if shards is None else shards
        cells = [[(i, g) for i, s in enumerate(shards) for g in rows
                  if m.owner(g, s) == p] for p in range(m.processes)]
        mine = [blocks[i][g] for i, g in cells[m.rank]]
        for p, theirs in enumerate(multihost.allgather_tensors(mine)):
            if p != m.rank:
                for (i, g), t in zip(cells[p], theirs):
                    blocks[i][g] = t

    add_async = add

    def wait(self) -> None:
        """Block until all queued updates on this table are applied."""
        for event in self._events:
            event.synchronize()

    def _live_value(self) -> Any:
        """What an add-handle's ``wait()`` returns: the current param (the
        list of shards for a sharded table)."""
        return self.shards[0] if len(self.shards) == 1 else list(self.shards)

    # -- checkpoint (ServerTable::Store/Load) ------------------------------

    def _manifest(self) -> Dict[str, Any]:
        return {
            "magic": CHECKPOINT_MAGIC,
            "kind": type(self).__name__,
            "name": self.name,
            "logical_shape": list(self.logical_shape),
            "padded_shape": list(self.padded_shape),
            "dtype": self.np_dtype.name,
            "updater": self.updater.name,
            "step": self.default_option.step,
        }

    def _state_parts(self, key: str) -> List[torch.Tensor]:
        """An updater-state leaf's blocks in global row order (the
        shards', under shard_update each shard's blocks in replica
        order): a checkpoint's padded leaf, concatenated."""
        if not self.shard_update:
            # shards no local replica holds come over the group
            return self._filled([None if st is None else st[key]
                                 for st in self._read_shards(
                                     self.replica_states)])
        blocks = [[None] * self.n_data for _ in self.devices]
        for d, g in enumerate(self.replica_ids):
            for s in range(len(self.devices)):
                if self.replica_states[d][s] is not None:
                    blocks[s][g] = self.replica_states[d][s][key]
        # other processes' blocks come over the group (a collective)
        self._fill_remote(blocks)
        return [b for row in blocks for b in row]

    def export_checkpoint_async(self):
        """The checkpoint export in two halves (the run checkpoint
        manager's overlap, ``ft/checkpoint.py``):

        - the DISPATCH half runs here, on the thread that queues the
          table's work: the param shards and every state leaf are queued
          into pinned host buffers (:class:`HostCopy`, whose docstring
          says why no later add reaches the exported bytes), the parts
          other processes hold gathered first (a collective, called here
          and never on a writer thread, so every process calls its
          collectives in one order);
        - the returned ``finish()`` is the BLOCKING half, safe on a
          worker thread: it waits on the copies' events, assembles the
          payload and records the accounting.

        ``finish()`` returns ``(manifest, payload)`` ready for
        :func:`savez_stream`: the global padded arrays, the shards
        concatenated."""
        self.flush_coalesced()
        manifest = self._manifest()
        param = HostCopy(self._filled(self._read_shards()),
                         self.padded_shape)
        keys = state_keys(self._state0())
        leaves = [HostCopy(self._state_parts(k)) for k in keys]

        def finish():
            payload = {"param": param.numpy()}
            for i, leaf in enumerate(leaves):
                payload[f"state_{i}"] = leaf.numpy()
            manifest["n_state_leaves"] = len(keys)
            self._record_op("store", payload["param"].size,
                            sum(a.nbytes for a in payload.values()))
            return manifest, payload
        return finish

    def store(self, uri: str) -> None:
        """Serialize param + updater state through the stream layer."""
        manifest, payload = self.export_checkpoint_async()()
        savez_stream(uri, manifest, payload)

    def load(self, uri: str) -> None:
        """Restore a checkpoint of any padding and shard count."""
        # buffered deltas refer to the pre-load state: they land first
        self.flush_coalesced()
        manifest, data = loadz_stream(uri, CHECKPOINT_MAGIC)
        if tuple(manifest["logical_shape"]) != self.logical_shape:
            raise ValueError(
                f"checkpoint shape {manifest['logical_shape']} != table "
                f"shape {list(self.logical_shape)}")
        if manifest["updater"] != self.updater.name:
            raise ValueError(
                f"checkpoint updater {manifest['updater']!r} != table "
                f"updater {self.updater.name!r}")
        keys = state_keys(self._state0())
        if int(manifest["n_state_leaves"]) != len(keys):
            raise ValueError(
                f"checkpoint has {manifest['n_state_leaves']} state "
                f"leaves, updater {self.updater.name!r} has {len(keys)}")
        self._record_op("load", data["param"].size,
                        data["param"].nbytes + sum(data[f"state_{i}"].nbytes
                                                   for i in range(len(keys))))

        def repad(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
            # slice to the logical region, then pad to this table's padded
            # shape: the checkpoint may come from another padding
            if arr.shape != self.padded_shape:
                arr = arr[tuple(slice(0, l) for l in self.logical_shape)]
                pad = [(0, p - l) for p, l in zip(self.padded_shape,
                                                   arr.shape)]
                arr = np.pad(arr, pad)
            return arr.astype(dtype)

        self.replicas = self._replicate(
            repad(data["param"], self.np_dtype).reshape(self.storage_shape))
        leaves = [repad(data[f"state_{i}"], np.dtype(np.float32))
                  for i in range(len(keys))]
        self.replica_states = []
        for d in range(self.n_replicas):
            blocks = [self._state_split(leaf, d) for leaf in leaves]
            self.replica_states.append(
                [None if self.replicas[d][s] is None
                 else {key: blocks[i][s] for i, key in enumerate(keys)}
                 for s in range(len(self.devices))])
        self.default_option.step = int(manifest.get("step", 0))
        with self._option_lock:
            self.generation += 1
        self._notify_views()

    def load_numpy(self, arr: np.ndarray) -> None:
        """Install a value given as a numpy array of the logical or the
        padded shape, e.g. weights of a ``multiverso_tpu`` table
        (:func:`multiverso_tpu_torch.convert.load_table`)."""
        from multiverso_tpu_torch.convert import load_table
        load_table(self, arr)


# -- process-wide table registry (TableFactory / table ids) ---------------------

_TABLES: List[Table] = []
_REG_LOCK = threading.Lock()


def _register(table: Table) -> int:
    with _REG_LOCK:
        _TABLES.append(table)
        return len(_TABLES) - 1


def get_table(table_id: int) -> Table:
    with _REG_LOCK:
        return _TABLES[table_id]


def num_tables() -> int:
    with _REG_LOCK:
        return len(_TABLES)


def reset_tables() -> None:
    """Drop all registered tables (tests / shutdown)."""
    with _REG_LOCK:
        _TABLES.clear()
