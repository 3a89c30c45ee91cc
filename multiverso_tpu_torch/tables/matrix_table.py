"""MatrixTable: 2-D dense row-major table with row-subset Get/Add.

Counterpart of ``multiverso_tpu/tables/matrix_table.py`` (the reference's
``MatrixWorkerTable<T>::Get(row_ids, ...)`` / ``Add(row_ids, deltas)``,
word2vec's embedding store):

- ``get_rows(ids)`` is the row gather kernel
  (:func:`~multiverso_tpu_torch.ops.table_kernels.gather_rows`).
- ``add_rows(ids, deltas)`` under the ``default`` and ``sgd`` updaters is
  the masked sorted row scatter-add kernel (duplicate ids accumulate);
  stateful updaters gather the rows, apply the updater and write the rows
  back in plain torch, as the reference leaves that path to XLA.
- Row batches are stable-sorted on the host (scatters) and padded to a
  power of two with a scratch row that lives beyond the logical rows, as
  in the reference.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables.base import Handle, Table
from multiverso_tpu_torch.tables.hashing import _bucket
from multiverso_tpu_torch.updaters import AddOption


class MatrixTable(Table):
    def __init__(self, num_rows: int, num_cols: int, dtype: Any = "float32",
                 *, init_value: Any = 0, updater: Optional[str] = None,
                 device: core.DeviceLike = None, name: str = "matrix_table",
                 default_option: Optional[AddOption] = None) -> None:
        if num_rows <= 0 or num_cols <= 0:
            raise ValueError(f"MatrixTable dims must be positive, got "
                             f"{num_rows}x{num_cols}")
        super().__init__(name, (num_rows, num_cols), dtype, updater=updater,
                         device=device, init_value=init_value,
                         default_option=default_option)
        # scratch row: padding lanes point here, beyond the logical rows
        self._scratch_row = self.padded_shape[0] - 1

    def _pad_lead(self, lead: int) -> int:
        return lead + 1

    @property
    def num_rows(self) -> int:
        return self.logical_shape[0]

    @property
    def num_cols(self) -> int:
        return self.logical_shape[1]

    def _pad_ids(self, ids: np.ndarray,
                 deltas: Optional[np.ndarray] = None, *,
                 sort: bool = False):
        """Pad a row batch to a power of two with scratch-row lanes.
        Scatters stable-sort by row id (the scatter kernel's contract; the
        scratch row, the largest id, keeps the padded batch sorted).
        Gathers keep request order. Returns ``(ids, mask, n[, deltas])``."""
        if sort and len(ids) > 1:
            order = np.argsort(ids, kind="stable")
            ids = ids[order]
            if deltas is not None:
                deltas = deltas[order]
        n = len(ids)
        b = _bucket(n)
        out_ids = np.full(b, self._scratch_row, dtype=np.int32)
        out_ids[:n] = ids
        mask = np.zeros(b, dtype=bool)
        mask[:n] = True
        if deltas is None:
            return out_ids, mask, n
        out_d = np.zeros((b, self.num_cols), dtype=self.np_dtype)
        out_d[:n] = deltas
        return out_ids, mask, n, out_d

    # -- row API -----------------------------------------------------------

    def _gather(self, ids: np.ndarray) -> torch.Tensor:
        padded, _, n = self._pad_ids(ids)
        ids_t = torch.as_tensor(padded, device=self.device)
        return tk.gather_rows(self.param, ids_t)[:n]

    def get_rows(self, row_ids) -> np.ndarray:
        """Fetch a list of rows (``MatrixWorkerTable::Get(row_ids, ...)``)."""
        ids = np.asarray(row_ids, dtype=np.int32)
        self._check_ids(ids)
        return self._gather(ids).cpu().numpy()

    def get_rows_async(self, row_ids) -> Handle:
        ids = np.asarray(row_ids, dtype=np.int32)
        self._check_ids(ids)
        return Handle(self._gather(ids))

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
        dev = self.device
        if self.updater.name in ("default", "sgd"):
            if self.updater.name == "sgd":
                # stateless: scatter-add of -lr*delta, duplicate-safe
                opt = option if option is not None else self.default_option
                deltas = (np.float32(-opt.learning_rate)
                          * deltas.astype(np.float32))
            padded, mask, _, pd = self._pad_ids(ids, deltas, sort=True)
            tk.row_scatter_add_masked(
                self.param, torch.as_tensor(padded, device=dev),
                torch.as_tensor(pd, device=dev),
                torch.as_tensor(mask, device=dev))
        else:
            if len(np.unique(ids)) != len(ids):
                raise ValueError(
                    f"add_rows with stateful updater "
                    f"{self.updater.name!r} requires unique row ids; "
                    "pre-aggregate duplicates (Aggregator role)")
            opt = self._resolve_option(option)
            padded, mask, _, pd = self._pad_ids(ids, deltas)
            self._apply_rows(torch.as_tensor(padded, device=dev).long(),
                             torch.as_tensor(pd, device=dev),
                             torch.as_tensor(mask, device=dev), opt)
        handle = Handle(table=self, generation=self._bump_step())
        if sync:
            handle.wait()
        return handle

    def _apply_rows(self, ids: torch.Tensor, deltas: torch.Tensor,
                    mask: torch.Tensor, option: AddOption) -> None:
        """Stateful row update: gather rows and state rows, apply the
        updater, write back the masked lanes (padding lanes rewrite the
        scratch row's old value)."""
        rows = self.param.index_select(0, ids)
        st_rows = {k: s.index_select(0, ids) for k, s in self.state.items()}
        new_rows, new_st = self.updater.apply(rows, st_rows, deltas, option)
        m = mask[:, None]
        self.param.index_copy_(0, ids,
                               torch.where(m, new_rows, rows).to(self.dtype))
        for k, s in self.state.items():
            s.index_copy_(0, ids, torch.where(m, new_st[k], st_rows[k]))

    def _check_ids(self, ids: np.ndarray) -> None:
        if len(ids) == 0:
            raise ValueError("empty row id list")
        if ids.min() < 0 or ids.max() >= self.num_rows:
            raise ValueError(f"row ids out of range [0, {self.num_rows}): "
                             f"min={ids.min()} max={ids.max()}")
