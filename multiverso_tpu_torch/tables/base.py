"""Table base: the Worker/Server table contract on one device tensor.

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

The leading dimension is padded as the reference pads it on a one-device
mesh (subclasses reserve scratch rows); the logical shape is what the API
shows. ``storage_shape`` is the physical layout of the param tensor: the
padded shape, or a re-tiled view of it (``[R, C/128, 128]`` for a tiled
SparseMatrixTable); checkpoints always hold the padded shape.
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


def _record_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """A CUDA event marking the work queued so far (None on the CPU,
    where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class Handle:
    """Async completion handle (the reference's Waiter).

    - A **get-handle** wraps a snapshot tensor (or a tuple of them);
      ``wait()`` blocks until it is computed and returns it.
    - An **add-handle** records the table and the *generation* its update
      produced. Updates apply in stream order, so once the table's queued
      work is done every generation up to the current one has landed;
      ``wait()`` returns the CURRENT param tensor, which is this handle's
      result only while it is the latest update (see :meth:`superseded`).
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
        self._event = _record_event(first.device) \
            if isinstance(first, torch.Tensor) else None

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
        event = self._event if self._table is None else self._table._event
        return event is None or event.query()

    def wait(self) -> Any:
        if self._table is None:
            if self._event is not None:
                self._event.synchronize()
            return self._values
        self._table.wait()
        return self._table._live_value()

    def result(self) -> Any:
        return self.wait()


# -- the table -------------------------------------------------------------------


class Table:
    """Base class owning one param tensor (+ updater state) on a device."""

    def __init__(self, name: str, shape: Tuple[int, ...], dtype: Any,
                 *, updater: Optional[str] = None,
                 device: core.DeviceLike = None,
                 init_value: Any = 0,
                 default_option: Optional[AddOption] = None) -> None:
        self.name = name
        self.device = core.resolve(device)
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
        lead = self.logical_shape[0] if self.logical_shape else 1
        self.padded_shape = (self._pad_lead(lead),) + self.logical_shape[1:]
        self.storage_shape = self.padded_shape
        init = np.full(self.padded_shape, init_value, dtype=self.np_dtype) \
            if np.isscalar(init_value) else self._pad(np.asarray(init_value))
        self.param = torch.tensor(init, device=self.device)
        self.state = self.updater.init_state(self.param)
        self._event = None
        self.table_id = _register(self)
        log.debug("table %r id=%d shape=%s padded=%s updater=%s on %s",
                  name, self.table_id, self.logical_shape,
                  self.padded_shape, self.updater.name, self.device)

    # -- helpers -----------------------------------------------------------

    def _pad_lead(self, lead: int) -> int:
        return lead

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        if arr.shape == self.padded_shape:
            return arr.astype(self.np_dtype, copy=False)
        if arr.shape != self.logical_shape:
            raise ValueError(f"table {self.name!r}: value shape {arr.shape} "
                             f"!= table shape {self.logical_shape}")
        pad = [(0, p - l) for p, l in zip(self.padded_shape, arr.shape)]
        return np.pad(arr.astype(self.np_dtype, copy=False), pad)

    def _resolve_option(self, option: Optional[AddOption]) -> AddOption:
        opt = option if option is not None else self.default_option
        return opt.snapshot()

    def _bump_step(self) -> int:
        """Advance step + generation; returns the new generation (mint
        handles from it, not from a later read of ``self.generation``)."""
        self._event = _record_event(self.device)
        with self._option_lock:
            self.default_option.step += 1
            self.generation += 1
            return self.generation

    # -- the Get/Add contract ---------------------------------------------

    def raw(self) -> torch.Tensor:
        """The padded param tensor — LIVE table storage, updated in place
        by row adds and supersteps. Use :meth:`get_tensor` for a snapshot."""
        return self.param

    def put_raw(self, padded: torch.Tensor) -> None:
        """Replace table storage with a tensor of the storage shape and the
        table's dtype (moved to the table's device); advances the
        generation. Updater state is untouched."""
        if tuple(padded.shape) != self.storage_shape:
            raise ValueError(
                f"table {self.name!r}: put_raw shape {tuple(padded.shape)} "
                f"!= storage shape {self.storage_shape}")
        if padded.dtype != self.dtype:
            raise ValueError(f"table {self.name!r}: put_raw dtype "
                             f"{padded.dtype} != table dtype {self.dtype}")
        self.param = padded.to(self.device).contiguous()
        with self._option_lock:
            self.generation += 1

    def get_tensor(self) -> torch.Tensor:
        """The logical value (padding sliced off) as a fresh device tensor."""
        return self.param.view(self.padded_shape)[
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
        the logical or padded shape) through the updater."""
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
            delta = torch.tensor(self._pad(np.asarray(delta)),
                                 device=self.device)
        opt = self._resolve_option(option)
        param, self.state = self.updater.apply(
            self.param.view(self.padded_shape), self.state, delta, opt)
        self.param = param.reshape(self.storage_shape)
        handle = Handle(table=self, generation=self._bump_step())
        if sync:
            handle.wait()
        return handle

    add_async = add

    def wait(self) -> None:
        """Block until all queued updates on this table are applied."""
        if self._event is not None:
            self._event.synchronize()

    def _live_value(self) -> torch.Tensor:
        """What an add-handle's ``wait()`` returns: the current param."""
        return self.param

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
        """Serialize param + updater state (the padded arrays)."""
        manifest = self._manifest()
        payload = {"param": self.param.view(self.padded_shape).cpu().numpy()}
        keys = state_keys(self.state)
        for i, key in enumerate(keys):
            payload[f"state_{i}"] = self.state[key].cpu().numpy()
        manifest["n_state_leaves"] = len(keys)
        savez_stream(uri, manifest, payload)

    def load(self, uri: str) -> None:
        manifest, data = loadz_stream(uri, CHECKPOINT_MAGIC)
        if tuple(manifest["logical_shape"]) != self.logical_shape:
            raise ValueError(
                f"checkpoint shape {manifest['logical_shape']} != table "
                f"shape {list(self.logical_shape)}")
        if manifest["updater"] != self.updater.name:
            raise ValueError(
                f"checkpoint updater {manifest['updater']!r} != table "
                f"updater {self.updater.name!r}")
        keys = state_keys(self.state)
        if int(manifest["n_state_leaves"]) != len(keys):
            raise ValueError(
                f"checkpoint has {manifest['n_state_leaves']} state "
                f"leaves, updater {self.updater.name!r} has {len(keys)}")

        def repad(arr: np.ndarray, dtype: np.dtype) -> torch.Tensor:
            # slice to the logical region, then pad to this table's padded
            # shape: the checkpoint may come from another padding
            if arr.shape != self.padded_shape:
                arr = arr[tuple(slice(0, l) for l in self.logical_shape)]
                pad = [(0, p - l) for p, l in zip(self.padded_shape,
                                                   arr.shape)]
                arr = np.pad(arr, pad)
            return torch.tensor(arr.astype(dtype), device=self.device)

        self.param = repad(data["param"], self.np_dtype).reshape(
            self.storage_shape)
        self.state = {key: repad(data[f"state_{i}"], np.dtype(np.float32))
                      for i, key in enumerate(keys)}
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
