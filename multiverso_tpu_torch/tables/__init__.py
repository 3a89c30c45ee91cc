"""The table layer: ArrayTable, MatrixTable, the fused superstep."""

from multiverso_tpu_torch.tables.array_table import ArrayTable
from multiverso_tpu_torch.tables.base import (Handle, Table, get_table,
                                              num_tables, reset_tables)
from multiverso_tpu_torch.tables.matrix_table import MatrixTable
from multiverso_tpu_torch.tables.superstep import (FusedSuperstep,
                                                   make_superstep)

__all__ = ["ArrayTable", "FusedSuperstep", "Handle", "MatrixTable", "Table",
           "get_table", "make_superstep", "num_tables", "reset_tables"]
