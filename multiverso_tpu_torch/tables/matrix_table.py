"""MatrixTable: 2-D dense row-major table with row-subset Get/Add.

Counterpart of ``multiverso_tpu/tables/matrix_table.py`` (the reference's
``MatrixWorkerTable<T>::Get(row_ids, ...)`` / ``Add(row_ids, deltas)``,
word2vec's embedding store):

- ``get_rows(ids)`` is the row gather kernel, once per card over its
  shards
  (:func:`~multiverso_tpu_torch.ops.table_kernels.gather_rows_sharded`).
- ``add_rows(ids, deltas)`` under the ``default`` and ``sgd`` updaters is
  the masked sorted row scatter-add kernel, once per card over its
  shards' real lanes (``row_scatter_add_sharded``; duplicate ids
  accumulate), on every replica; stateful
  updaters gather the rows, apply the updater and write the rows back in
  plain torch, shard by shard, as the reference leaves that path to XLA
  (under ``shard_update`` the replica that holds a row's state applies
  it and the updated row goes to every replica).
- Row batches are stable-sorted on the host (scatters by row, gathers by
  shard) and sliced into per-shard lane rows of local ids
  (``hashing.shard_lane_slices``), each row padded to a power of two on
  its shard's last local row; the last shard's is the scratch row that
  lives beyond the logical rows, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.ft.chaos import chaos_corrupt
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables.base import Handle, Table, lanes_on
from multiverso_tpu_torch.tables.hashing import _bucket, shard_lane_slices
from multiverso_tpu_torch.telemetry import health as _health
from multiverso_tpu_torch.telemetry.profiling import profiled
from multiverso_tpu_torch.updaters import AddOption


@dataclasses.dataclass
class MatrixTableOption:
    """``MatrixTableOption<T>`` analog for the create_table factory."""
    num_rows: int
    num_cols: int
    dtype: Any = "float32"
    init_value: Any = 0
    updater: Optional[str] = None
    name: str = "matrix_table"
    shard_update: bool = False   # data-axis weight-update sharding


class MatrixTable(Table):
    def __init__(self, num_rows: int, num_cols: int, dtype: Any = "float32",
                 *, init_value: Any = 0, updater: Optional[str] = None,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None,
                 name: str = "matrix_table",
                 default_option: Optional[AddOption] = None,
                 shard_update: bool = False) -> None:
        if num_rows <= 0 or num_cols <= 0:
            raise ValueError(f"MatrixTable dims must be positive, got "
                             f"{num_rows}x{num_cols}")
        super().__init__(name, (num_rows, num_cols), dtype, updater=updater,
                         device=device, mesh=mesh, init_value=init_value,
                         default_option=default_option,
                         shard_update=shard_update)
        # scratch row: the last shard's padding lanes point here, beyond
        # the logical rows
        self._scratch_row = self.padded_shape[0] - 1
        # profiled: profile.calls{fn=table.{gather,scatter_add,
        # apply_rows}.<name>} count the row-path dispatches, one per call
        # (the reference splits them by engine; the port has one a device)
        self._gather_rows = profiled(self._gather, f"table.gather.{name}")
        self._scatter_add = profiled(self._scatter_rows,
                                     f"table.scatter_add.{name}")
        self._apply_rows_all = profiled(self._apply_stateful,
                                        f"table.apply_rows.{name}")

    def _pad_lead(self, lead: int, shards: int) -> int:
        return -(-(lead + 1) // shards) * shards

    @property
    def num_rows(self) -> int:
        return self.logical_shape[0]

    @property
    def num_cols(self) -> int:
        return self.logical_shape[1]

    def _pad_ids(self, ids: np.ndarray,
                 deltas: Optional[np.ndarray] = None, *,
                 sort: bool = False):
        """Lane-slice prep for the sharded forms, the reference's
        ``_pad_ids_sharded`` (on one shard, its ``_pad_ids``): group lanes
        by owning shard (scatters sort by GLOBAL row id, which implies it
        and keeps each shard's lanes row-sorted; gathers sort by shard
        only) and slice them into per-shard rows of LOCAL ids, padding on
        each shard's last local row. Returns ``(local_ids, valid, inv, n,
        deltas or None)`` in the ``(shards, L, ...)`` layout; ``inv`` is
        the pow2-padded flat ``shard * L + pos`` map a gather unpermutes
        through."""
        rps = self._rows_per_shard
        if len(ids) > 1:
            # gathers sort by shard only: a 16-bit key, numpy's radix sort
            key = ids if sort else (ids // rps).astype(np.int16)
            order = np.argsort(key, kind="stable")
            ids = ids[order]
            if deltas is not None:
                deltas = deltas[order]
        else:
            order = np.arange(len(ids))
        shard_ids = ids // rps
        local = (ids - shard_ids * rps).astype(np.int32)
        arrays, pads = [local], [np.int32(rps - 1)]
        if deltas is not None:
            arrays.append(deltas.astype(self.np_dtype, copy=False))
            pads.append(0)
        sliced, valid, pos = shard_lane_slices(shard_ids, len(self.shards),
                                               arrays, pads)
        n = len(ids)
        lanes = sliced[0].shape[1]
        inv = np.zeros(_bucket(n), np.int32)
        inv[order] = (shard_ids * lanes + pos).astype(np.int32)
        return (sliced[0], valid, inv, n,
                sliced[1] if deltas is not None else None)

    # -- row API -----------------------------------------------------------

    def _gather(self, ids: np.ndarray) -> torch.Tensor:
        local, valid, inv, n, _ = self._pad_ids(ids)
        # each shard from a local replica that holds it; when the model
        # axis crosses processes the others' rows come as zero bits and
        # the merge ORs their holders' in
        shards = self._read_shards()
        return tk.gather_rows_sharded(
            shards, lanes_on(local, [None if t is None else t.device
                                     for t in shards]),
            torch.as_tensor(inv[:n], device=self.device),
            counts=valid.sum(1), merge=self._merger)

    def get_rows(self, row_ids) -> np.ndarray:
        """Fetch a list of rows (``MatrixWorkerTable::Get(row_ids, ...)``)."""
        return self._get_rows(row_ids).cpu().numpy()

    def get_rows_async(self, row_ids) -> Handle:
        return Handle(self._get_rows(row_ids))

    def _get_rows(self, row_ids) -> torch.Tensor:
        ids = np.asarray(row_ids, dtype=np.int32)
        self._check_ids(ids)
        n = len(ids) * self.num_cols
        self._record_op("get", n, n * self.np_dtype.itemsize)
        return self._gather_rows(ids)

    def add_rows(self, row_ids, deltas, option: Optional[AddOption] = None,
                 sync: bool = False) -> Handle:
        """Apply deltas to a row subset (``MatrixWorkerTable::Add(rows)``).

        With the ``default`` (and ``sgd``) updater duplicate row ids
        accumulate. Stateful updaters require unique row ids per call —
        pre-aggregate duplicates first (the reference's client-side
        Aggregator role)."""
        ids = np.asarray(row_ids, dtype=np.int32)
        self._check_ids(ids)
        deltas = np.asarray(deltas)
        if deltas.shape != (len(ids), self.num_cols):
            raise ValueError(f"deltas shape {deltas.shape} != "
                             f"({len(ids)}, {self.num_cols})")
        deltas = chaos_corrupt("table.add", deltas)
        self._record_op("add", deltas.size,
                        deltas.size * self.np_dtype.itemsize)
        _health.observe_update(self, deltas)
        if self.updater.name in ("default", "sgd"):
            if self.updater.name == "sgd":
                # stateless: scatter-add of -lr*delta, duplicate-safe
                opt = option if option is not None else self.default_option
                deltas = (np.float32(-opt.learning_rate)
                          * deltas.astype(np.float32))
            self._scatter_add(ids, deltas)
        else:
            if len(np.unique(ids)) != len(ids):
                raise ValueError(
                    f"add_rows with stateful updater "
                    f"{self.updater.name!r} requires unique row ids; "
                    "pre-aggregate duplicates (Aggregator role)")
            self._apply_rows_all(ids, deltas, self._resolve_option(option))
        handle = Handle(table=self, generation=self._bump_step())
        if sync:
            handle.wait()
        return handle

    def _scatter_rows(self, ids: np.ndarray, deltas: np.ndarray) -> None:
        """The duplicate-safe row scatter-add of ``deltas`` into rows
        ``ids`` on every replica, once per card over its shards."""
        local, valid, _, _, sl_d = self._pad_ids(ids, deltas, sort=True)
        for shards, devs in zip(self.replicas, self.replica_devices):
            tk.row_scatter_add_sharded(
                shards, *(lanes_on(x, devs) for x in (local, sl_d, valid)),
                counts=valid.sum(1))

    def _apply_stateful(self, ids: np.ndarray, deltas: np.ndarray,
                        option: AddOption) -> None:
        """A stateful updater over rows ``ids`` (unique): each shard
        applies it to the rows it owns."""
        rps = self._rows_per_shard
        owner = ids // rps
        for s in np.unique(owner):
            sel = owner == s
            self._apply_rows(s, ids[sel] - s * rps,
                             deltas[sel].astype(self.np_dtype), option)

    def _apply_rows(self, shard: int, ids: np.ndarray, deltas: np.ndarray,
                    option: AddOption) -> None:
        """Stateful row update of one shard (unique local ids) on every
        replica. Under shard_update the replica whose state block holds a
        row applies the updater to it, and the updated row goes to every
        replica (from another process's replica over the group)."""
        held = [d for d in range(self.n_replicas)
                if self.replicas[d][shard] is not None]
        if not self.shard_update:
            for d in held:
                self._write_rows(d, shard, ids, self._update_rows(
                    d, shard, ids, ids, deltas, option))
            return
        q = self._rows_per_shard // self.n_data
        owner = ids // q
        owners = np.unique(owner).tolist()
        # blocks[0][g]: the rows replica g updated (the base's layout)
        blocks = [[None] * self.n_data]
        for d in held:
            g = self.replica_ids[d]
            if g in owners:
                sel = owner == g
                blocks[0][g] = self._update_rows(
                    d, shard, ids[sel], ids[sel] - g * q, deltas[sel],
                    option)
        self._fill_remote(blocks, owners, [shard])
        for g in owners:
            for e in held:
                self._write_rows(e, shard, ids[owner == g], blocks[0][g])

    def _update_rows(self, replica: int, shard: int, ids: np.ndarray,
                     state_ids: np.ndarray, deltas: np.ndarray,
                     option: AddOption) -> torch.Tensor:
        """Gather rows ``ids`` of one replica's shard and rows
        ``state_ids`` of its updater state, apply the updater, write the
        state back; returns the updated rows."""
        dev = self.replica_devices[replica][shard]
        param = self.replicas[replica][shard]
        state = self.replica_states[replica][shard]
        st_ids = torch.as_tensor(state_ids, device=dev).long()
        rows = param.index_select(0, torch.as_tensor(ids, device=dev).long())
        st_rows = {k: s.index_select(0, st_ids) for k, s in state.items()}
        new_rows, new_st = self.updater.apply(
            rows, st_rows, torch.as_tensor(deltas, device=dev), option)
        for k, s in state.items():
            s.index_copy_(0, st_ids, new_st[k])
        return new_rows.to(self.dtype)

    def _write_rows(self, replica: int, shard: int, ids: np.ndarray,
                    rows: torch.Tensor) -> None:
        dev = self.replica_devices[replica][shard]
        self.replicas[replica][shard].index_copy_(
            0, torch.as_tensor(ids, device=dev).long(), rows.to(dev))

    def _check_ids(self, ids: np.ndarray) -> None:
        if len(ids) == 0:
            raise ValueError("empty row id list")
        if ids.min() < 0 or ids.max() >= self.num_rows:
            raise ValueError(f"row ids out of range [0, {self.num_rows}): "
                             f"min={ids.min()} max={ids.max()}")
