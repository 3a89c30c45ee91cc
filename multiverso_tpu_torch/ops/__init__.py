"""Kernels of the port: hand-written CUDA for Hopper, each beside its
plain PyTorch version (see ``table_kernels.py``)."""

from multiverso_tpu_torch.ops import table_kernels
from multiverso_tpu_torch.ops.table_kernels import (gather_rows,
                                                    row_scatter_add,
                                                    row_scatter_add_masked)

__all__ = ["gather_rows", "row_scatter_add", "row_scatter_add_masked",
           "table_kernels"]
