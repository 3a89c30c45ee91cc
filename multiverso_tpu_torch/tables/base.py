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
  the padded arrays, each stamped with its CRC32), on local files: a table
  stored by either package loads in the other.

The leading dimension is padded as the reference pads it: to a multiple
of the model-axis size, subclasses reserving scratch rows. Shard ``s``
holds the contiguous row block ``s`` of the padded storage on the mesh
device ``[0, s]`` (the reference shards its leading dimension over
``model`` the same way); a one-shard mesh holds one tensor. The logical
shape is what the API shows. ``storage_shape`` is the physical layout of
the param: the padded shape, or a re-tiled view of it (``[R, C/128, 128]``
for a tiled SparseMatrixTable); checkpoints always hold the global padded
shape, whatever the shard count, so a table stored on S shards is
byte-identical to the reference's on S shards and loads on any other.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.ops.table_kernels import ShardedParam
from multiverso_tpu_torch.updaters import (AddOption, Updater, get_updater,
                                           resolve_default_option)
from multiverso_tpu_torch.utils import configure, log

CHECKPOINT_MAGIC = "multiverso_tpu.table.v1"


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype (name)."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


# -- checkpoint format ---------------------------------------------------------


def _local_path(uri: str) -> str:
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if "://" in uri:
        raise ValueError(f"only local files are supported, got {uri!r}")
    return uri


def _payload_crc32(arr: np.ndarray) -> int:
    """CRC32 over an array's raw bytes (C order)."""
    return int(zlib.crc32(np.ascontiguousarray(arr).tobytes()))


def savez_stream(uri: str, manifest: Dict[str, Any],
                 payload: Dict[str, np.ndarray]) -> None:
    """Write an npz (manifest json + arrays), the manifest stamped with a
    per-array CRC32. The file appears whole or not at all (write to a
    temporary file, then rename)."""
    manifest = dict(manifest)
    manifest["crc32"] = {k: _payload_crc32(v) for k, v in payload.items()}
    buf = io.BytesIO()
    np.savez(buf, manifest=json.dumps(manifest), **payload)
    path = _local_path(uri)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               prefix=".tmp_ckpt_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def loadz_stream(uri: str, magic: str):
    """Read an npz; validate its manifest magic and the per-array CRC32
    checksums (when present). Returns (manifest dict, npz data)."""
    with open(_local_path(uri), "rb") as f:
        data = np.load(io.BytesIO(f.read()), allow_pickle=False)
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
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
    return events


def lanes_on(lanes, devices: List[torch.device]):
    """A ``(shards, L, ...)`` lane array (numpy or tensor) on the shards'
    devices: one tensor when they share one device, else a list of
    per-shard rows, row s on ``devices[s]`` (the sharded kernel forms take
    either)."""
    if len(set(devices)) == 1:
        return torch.as_tensor(lanes, device=devices[0])
    return [torch.as_tensor(row, device=dev)
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
    a one-shard mesh ``param`` and ``state`` are that shard's tensors."""

    def __init__(self, name: str, shape: Tuple[int, ...], dtype: Any,
                 *, updater: Optional[str] = None,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None,
                 init_value: Any = 0,
                 default_option: Optional[AddOption] = None) -> None:
        self.name = name
        self.mesh = core.resolve_mesh(mesh, device)
        self.devices = self.mesh.shard_devices
        self.device = self.devices[0]
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
        # the lead pads to a multiple of the model-axis size (subclasses
        # reserve scratch rows); dense checkpoints repad across paddings
        lead = self.logical_shape[0] if self.logical_shape else 1
        n_shards = len(self.devices)
        self.padded_shape = (self._pad_lead(lead, n_shards),) \
            + self.logical_shape[1:]
        self._rows_per_shard = self.padded_shape[0] // n_shards
        self.storage_shape = self.padded_shape
        init = np.full(self.padded_shape, init_value, dtype=self.np_dtype) \
            if np.isscalar(init_value) else self._pad(np.asarray(init_value))
        self.shards = self._split(init)
        self.shard_states = [self.updater.init_state(p) for p in self.shards]
        self._events: list = []
        self.table_id = _register(self)
        log.debug("table %r id=%d shape=%s padded=%s updater=%s on %s",
                  name, self.table_id, self.logical_shape,
                  self.padded_shape, self.updater.name,
                  [str(d) for d in self.devices])

    # -- helpers -----------------------------------------------------------

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

    def _split(self, whole) -> List[torch.Tensor]:
        """A padded (or storage-shaped) value, numpy (copied) or a tensor,
        cut into the shards' row blocks, each on its device."""
        rps = self._rows_per_shard
        blocks = [whole[s * rps:(s + 1) * rps]
                  for s in range(len(self.devices))]
        if isinstance(whole, np.ndarray):
            return [torch.tensor(b, device=d)
                    for b, d in zip(blocks, self.devices)]
        return [b.to(d).contiguous() for b, d in zip(blocks, self.devices)]

    def _whole(self, shards: Optional[List[torch.Tensor]] = None
               ) -> torch.Tensor:
        """The shards as one tensor on the first device: the live shard
        on a one-shard mesh, their concatenation otherwise."""
        shards = self.shards if shards is None else shards
        if len(shards) == 1:
            return shards[0]
        return torch.cat([t.to(self.device) for t in shards])

    def _one_shard(self, what: str) -> None:
        if len(self.shards) != 1:
            raise NotImplementedError(
                f"table {self.name!r} is split into {len(self.shards)} "
                f"shards; {what} is one tensor only on a one-shard mesh "
                "(use .shards / .shard_states)")

    @property
    def param(self) -> torch.Tensor:
        """The storage tensor of a one-shard table."""
        self._one_shard("param")
        return self.shards[0]

    @param.setter
    def param(self, value: torch.Tensor) -> None:
        self._one_shard("param")
        self.shards[0] = value

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The updater state of a one-shard table."""
        self._one_shard("state")
        return self.shard_states[0]

    @state.setter
    def state(self, value: Dict[str, torch.Tensor]) -> None:
        self._one_shard("state")
        self.shard_states[0] = value

    def superstep_view(self) -> Tuple[Any, Dict[str, Any]]:
        """``(param, state)`` as a superstep body takes them: the shard's
        tensors on a one-shard table; on a split one a
        :class:`~multiverso_tpu_torch.ops.table_kernels.ShardedParam` of
        the shards, and the state as one ShardedParam per leaf (the
        reference's body sees the global arrays)."""
        if len(self.shards) == 1:
            return self.shards[0], self.shard_states[0]
        return ShardedParam(self.shards), {
            k: ShardedParam([st[k] for st in self.shard_states])
            for k in self.shard_states[0]}

    def _take_shards(self, value) -> List[torch.Tensor]:
        """A body's returned param (or state leaf) of a split table as its
        shards: a ShardedParam's own shards, or a whole tensor of the
        storage shape cut into row blocks."""
        if isinstance(value, ShardedParam):
            if len(value.shards) != len(self.shards):
                raise ValueError(
                    f"table {self.name!r}: a superstep returned "
                    f"{len(value.shards)} shards for {len(self.shards)}")
            return list(value.shards)
        return self._split(value)

    def superstep_update(self, param: Any,
                         state: Dict[str, Any]) -> None:
        """Take a superstep body's returned ``(param, state)`` back as the
        table's storage (the inverse of :meth:`superstep_view`)."""
        if len(self.shards) == 1:
            self.shards[0], self.shard_states[0] = param, state
            return
        self.shards = self._take_shards(param)
        leaves = {k: self._take_shards(v) for k, v in state.items()}
        self.shard_states = [{k: v[s] for k, v in leaves.items()}
                             for s in range(len(self.shards))]

    def _resolve_option(self, option: Optional[AddOption]) -> AddOption:
        opt = option if option is not None else self.default_option
        return opt.snapshot()

    def _bump_step(self) -> int:
        """Advance step + generation; returns the new generation (mint
        handles from it, not from a later read of ``self.generation``)."""
        self._events = _record_events(self.devices)
        with self._option_lock:
            self.default_option.step += 1
            self.generation += 1
            return self.generation

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
        self.shards = self._split(padded)
        with self._option_lock:
            self.generation += 1

    def get_tensor(self) -> torch.Tensor:
        """The logical value (padding sliced off) as a fresh tensor on the
        first device."""
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
        the logical or padded shape) through the updater, shard by
        shard."""
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
            deltas = self._split(delta)
        else:
            deltas = self._split(self._pad(np.asarray(delta)))
        opt = self._resolve_option(option)
        shard_padded = (self._rows_per_shard,) + self.padded_shape[1:]
        shard_storage = (self._rows_per_shard,) + self.storage_shape[1:]
        for s, d in enumerate(deltas):
            param, self.shard_states[s] = self.updater.apply(
                self.shards[s].view(shard_padded), self.shard_states[s], d,
                opt)
            self.shards[s] = param.reshape(shard_storage)
        handle = Handle(table=self, generation=self._bump_step())
        if sync:
            handle.wait()
        return handle

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

    def store(self, uri: str) -> None:
        """Serialize param + updater state: the global padded arrays, the
        shards concatenated."""
        manifest = self._manifest()
        payload = {"param": self._whole().view(self.padded_shape).cpu()
                   .numpy()}
        keys = state_keys(self.shard_states[0])
        for i, key in enumerate(keys):
            payload[f"state_{i}"] = self._whole(
                [st[key] for st in self.shard_states]).cpu().numpy()
        manifest["n_state_leaves"] = len(keys)
        savez_stream(uri, manifest, payload)

    def load(self, uri: str) -> None:
        """Restore a checkpoint of any padding and shard count."""
        manifest, data = loadz_stream(uri, CHECKPOINT_MAGIC)
        if tuple(manifest["logical_shape"]) != self.logical_shape:
            raise ValueError(
                f"checkpoint shape {manifest['logical_shape']} != table "
                f"shape {list(self.logical_shape)}")
        if manifest["updater"] != self.updater.name:
            raise ValueError(
                f"checkpoint updater {manifest['updater']!r} != table "
                f"updater {self.updater.name!r}")
        keys = state_keys(self.shard_states[0])
        if int(manifest["n_state_leaves"]) != len(keys):
            raise ValueError(
                f"checkpoint has {manifest['n_state_leaves']} state "
                f"leaves, updater {self.updater.name!r} has {len(keys)}")

        def repad(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
            # slice to the logical region, then pad to this table's padded
            # shape: the checkpoint may come from another padding
            if arr.shape != self.padded_shape:
                arr = arr[tuple(slice(0, l) for l in self.logical_shape)]
                pad = [(0, p - l) for p, l in zip(self.padded_shape,
                                                   arr.shape)]
                arr = np.pad(arr, pad)
            return arr.astype(dtype)

        self.shards = self._split(repad(data["param"], self.np_dtype)
                                  .reshape(self.storage_shape))
        leaves = [self._split(repad(data[f"state_{i}"], np.dtype(np.float32)))
                  for i in range(len(keys))]
        self.shard_states = [{key: leaves[i][s] for i, key in enumerate(keys)}
                             for s in range(len(self.devices))]
        self.default_option.step = int(manifest.get("step", 0))
        with self._option_lock:
            self.generation += 1

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
