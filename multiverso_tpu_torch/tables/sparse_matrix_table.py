"""SparseMatrixTable: matrix table with COO sparse Add and sparse-row Get.

Counterpart of ``multiverso_tpu/tables/sparse_matrix_table.py`` (the
reference's ``SparseMatrixTable``, LightLDA's word-topic count store),
split over the mesh's model axis like every table:

- storage stays dense; ``tiled=True`` (``num_cols % 128 == 0``) stores it
  as ``[rows, C, 128]``, ``C = num_cols / 128``, the layout LightLDA's
  samplers gather from. The public API and checkpoints stay 2-D.
- :meth:`add_sparse` (``param[rows[i], cols[i]] += values[i]``) sorts the
  lanes by row on the host (stable), slices them per shard, each row
  padded to a power of two on its shard's last local row (the last
  shard's is the scratch row), and runs the masked COO kernel per shard
  (:func:`~multiverso_tpu_torch.ops.table_kernels.coo_scatter_add_sharded`)
  on every replica.
- :meth:`get_rows_sparse` counts each requested row's nonzeros on the
  device, extracts the top-k entries by magnitude there (k the largest
  count, rounded up to a power of two) and builds the CSR on the host, so
  only O(max_nnz * n) values leave the device.
- ``get_rows`` / ``add_rows`` go through the row kernels (MatrixTable).

Only the stateless updaters (``default``, the LDA count case, and
``sgd``) are supported, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.ft.chaos import chaos_corrupt
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables.base import Handle, lanes_on
from multiverso_tpu_torch.tables.hashing import _bucket, shard_lane_slices
from multiverso_tpu_torch.tables.matrix_table import MatrixTable
from multiverso_tpu_torch.telemetry import health as _health
from multiverso_tpu_torch.telemetry.profiling import profiled
from multiverso_tpu_torch.updaters import AddOption

LANES = 128


@dataclasses.dataclass
class SparseMatrixTableOption:
    """``SparseMatrixTableOption<T>`` analog for the create_table
    factory."""
    num_rows: int
    num_cols: int
    dtype: Any = "float32"
    init_value: Any = 0
    updater: Optional[str] = None
    name: str = "sparse_matrix_table"
    tiled: bool = False


class SparseMatrixTable(MatrixTable):
    """On a data axis D above 1 it holds D bit-identical replicas, as
    every Table does (the reference replicates it over ``data``): each
    write applies to all of them, a Get reads replica 0."""

    def __init__(self, num_rows: int, num_cols: int,
                 dtype: Any = "float32", *, init_value: Any = 0,
                 updater: Optional[str] = None,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None,
                 name: str = "sparse_matrix_table",
                 default_option: Optional[AddOption] = None,
                 tiled: bool = False) -> None:
        if tiled and num_cols % LANES:
            raise ValueError(f"tiled storage needs num_cols % {LANES} == 0,"
                             f" got {num_cols}")
        self.tiled = tiled
        self.tiles = num_cols // LANES if tiled else 0
        super().__init__(num_rows, num_cols, dtype, init_value=init_value,
                         updater=updater, device=device, mesh=mesh,
                         name=name, default_option=default_option)
        if self.updater.name not in ("default", "sgd"):
            raise ValueError(
                f"SparseMatrixTable supports stateless updaters "
                f"(default, sgd), got {self.updater.name!r}")
        if tiled:
            # each shard's rows re-tiled in place (split along rows), on
            # every replica
            self.storage_shape = (self.padded_shape[0], self.tiles, LANES)
            self.replicas = [[None if p is None
                              else p.view(-1, self.tiles, LANES)
                              for p in shards]
                             for shards in self.replicas]
        # profiled: profile.calls{fn=table.coo_scatter_add.<name>} is the
        # COO Add dispatch count, one per add_sparse
        self._coo_scatter_add = profiled(self._coo_rows,
                                         f"table.coo_scatter_add.{name}")

    # -- COO sparse Add ----------------------------------------------------

    def add_sparse(self, rows, cols, values,
                   option: Optional[AddOption] = None,
                   sync: bool = False) -> Handle:
        """COO sparse Add: ``param[rows[i], cols[i]] += values[i]``.

        Duplicate (row, col) pairs accumulate, in input order for each
        element. With the ``sgd`` updater the values are treated as
        gradients: ``param -= lr * values``."""
        rows = np.asarray(rows, dtype=np.int32)
        cols = np.asarray(cols, dtype=np.int32)
        values = np.asarray(values)
        if not (rows.shape == cols.shape == values.shape) or rows.ndim != 1:
            raise ValueError(
                f"COO arrays must be same-length 1-D, got rows={rows.shape} "
                f"cols={cols.shape} values={values.shape}")
        if len(rows) == 0:
            raise ValueError("empty COO add")
        self._check_ids(rows)
        if cols.min() < 0 or cols.max() >= self.num_cols:
            raise ValueError(f"col ids out of range [0, {self.num_cols})")
        n = len(rows)
        values = chaos_corrupt("table.add", values)
        self._record_op("add", n, n * self.np_dtype.itemsize)
        _health.observe_update(self, values)
        order = np.argsort(rows, kind="stable")
        rows, cols, values = rows[order], cols[order], values[order]
        if self.updater.name == "sgd":
            lr = float(option.learning_rate if option is not None
                       else self.default_option.learning_rate)
            values = -lr * values
        # row ownership is contiguous equal blocks, so the row sort above
        # IS a shard sort; padding lanes take each shard's last local row
        # and are masked out of the write-back
        rps = self._rows_per_shard
        shard_ids = rows // rps
        local = (rows - shard_ids * rps).astype(np.int32)
        sliced, valid, _ = shard_lane_slices(
            shard_ids, len(self.shards),
            [local, cols, values.astype(self.np_dtype, copy=False)],
            [np.int32(rps - 1), np.int32(0), 0])
        self._coo_scatter_add(sliced, valid)
        handle = Handle(table=self, generation=self._bump_step())
        if sync:
            handle.wait()
        return handle

    def _coo_rows(self, sliced, valid: np.ndarray) -> None:
        """The masked COO add of per-shard lane rows ``sliced`` (local
        rows, columns, values) on every replica."""
        for shards, devs in zip(self.replicas, self.replica_devices):
            tk.coo_scatter_add_sharded(
                shards, *(lanes_on(x, devs) for x in (*sliced, valid)),
                counts=valid.sum(1))

    # -- sparse Get --------------------------------------------------------

    def get_rows_sparse(self, row_ids) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
        """Sparse Get: only the NONZERO entries of the requested rows
        reach the host.

        Returns CSR-style ``(indptr [n+1], cols [nnz], vals [nnz])``: row
        ``i`` of the request holds entries
        ``cols[indptr[i]:indptr[i+1]]`` (ascending col order)."""
        ids = np.asarray(row_ids, dtype=np.int32)
        self._check_ids(ids)
        n = len(ids)
        rows = self._gather(ids)
        nnz = (rows != 0).sum(1).to(torch.int32).cpu().numpy()
        k = min(_bucket(max(int(nnz.max(initial=0)), 1)), self.num_cols)
        _, top = torch.topk(rows.to(torch.float32).abs(), k, dim=1)
        cols = top.to(torch.int32).cpu().numpy()
        vals = torch.gather(rows, 1, top).cpu().numpy()
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(nnz, out=indptr[1:])
        # one vectorized pass: np.nonzero walks row-major, then one
        # lexsort orders each row's entries by column
        ri, ci = np.nonzero(vals != 0)
        ecols = cols[ri, ci]
        order = np.lexsort((ecols, ri))
        self._record_op("get", len(ecols),
                        len(ecols) * self.np_dtype.itemsize)
        return indptr, ecols[order], vals[ri, ci][order]


__all__ = ["SparseMatrixTable"]
