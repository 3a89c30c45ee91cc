"""The table layer: ArrayTable, MatrixTable, SparseMatrixTable, KVTable,
the fused superstep, and ``create_table(option)``, the TableFactory /
``MV_CreateTable<Option>`` analog: the option dataclass's type selects
the table kind (counterpart of ``multiverso_tpu/tables/__init__.py``)."""

from typing import Optional, Union

from multiverso_tpu_torch import core
from multiverso_tpu_torch.tables.array_table import (ArrayTable,
                                                     ArrayTableOption)
from multiverso_tpu_torch.tables.base import (Handle, Table, get_table,
                                              num_tables, reset_tables)
from multiverso_tpu_torch.tables.kv_table import KVTable, KVTableOption
from multiverso_tpu_torch.tables.matrix_table import (MatrixTable,
                                                      MatrixTableOption)
from multiverso_tpu_torch.tables.sparse_matrix_table import (
    SparseMatrixTable, SparseMatrixTableOption)
from multiverso_tpu_torch.tables.superstep import (DataSplit, FusedSuperstep,
                                                   Replicated,
                                                   coo_scatter_add,
                                                   gather_rows,
                                                   make_superstep,
                                                   replica_sum,
                                                   row_scatter_add)

TableOption = Union[ArrayTableOption, MatrixTableOption,
                    SparseMatrixTableOption, KVTableOption]


def create_table(option: TableOption, *, device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None):
    """``MV_CreateTable(option)``: construct the table kind selected by the
    option dataclass, on ``mesh`` (default: the runtime's) or the (1, 1)
    mesh of ``device``, as the tables' own constructors take them."""
    where = dict(device=device, mesh=mesh)
    if isinstance(option, ArrayTableOption):
        return ArrayTable(option.size, option.dtype,
                          init_value=option.init_value,
                          updater=option.updater, name=option.name,
                          shard_update=option.shard_update, **where)
    if isinstance(option, SparseMatrixTableOption):
        return SparseMatrixTable(option.num_rows, option.num_cols,
                                 option.dtype, init_value=option.init_value,
                                 updater=option.updater, name=option.name,
                                 tiled=option.tiled, **where)
    if isinstance(option, MatrixTableOption):
        return MatrixTable(option.num_rows, option.num_cols, option.dtype,
                           init_value=option.init_value,
                           updater=option.updater, name=option.name,
                           shard_update=option.shard_update, **where)
    if isinstance(option, KVTableOption):
        return KVTable(option.capacity, option.value_dim, option.dtype,
                       slots_per_bucket=option.slots_per_bucket,
                       updater=option.updater, name=option.name,
                       shard_update=option.shard_update, **where)
    raise TypeError(f"unknown table option type {type(option).__name__}")


__all__ = ["ArrayTable", "ArrayTableOption", "DataSplit", "FusedSuperstep",
           "Handle", "KVTable", "KVTableOption", "MatrixTable",
           "MatrixTableOption", "Replicated", "SparseMatrixTable",
           "SparseMatrixTableOption", "Table", "TableOption",
           "coo_scatter_add", "create_table", "gather_rows", "get_table",
           "make_superstep", "num_tables", "replica_sum", "reset_tables",
           "row_scatter_add"]
