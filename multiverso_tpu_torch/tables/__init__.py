"""The table layer: ArrayTable, MatrixTable, SparseMatrixTable, KVTable,
the fused superstep."""

from multiverso_tpu_torch.tables.array_table import ArrayTable
from multiverso_tpu_torch.tables.base import (Handle, Table, get_table,
                                              num_tables, reset_tables)
from multiverso_tpu_torch.tables.kv_table import KVTable, KVTableOption
from multiverso_tpu_torch.tables.matrix_table import MatrixTable
from multiverso_tpu_torch.tables.sparse_matrix_table import SparseMatrixTable
from multiverso_tpu_torch.tables.superstep import (DataSplit, FusedSuperstep,
                                                   Replicated,
                                                   coo_scatter_add,
                                                   gather_rows,
                                                   make_superstep,
                                                   replica_sum,
                                                   row_scatter_add)

__all__ = ["ArrayTable", "DataSplit", "FusedSuperstep", "Handle", "KVTable",
           "KVTableOption", "MatrixTable", "Replicated",
           "SparseMatrixTable", "Table", "coo_scatter_add", "gather_rows",
           "get_table", "make_superstep", "num_tables", "replica_sum",
           "reset_tables", "row_scatter_add"]
