"""Table handlers of the reference's ``multiverso/tables.py``:
``ArrayTableHandler(size, init_value)`` and ``MatrixTableHandler(num_rows,
num_cols, init_value)`` with numpy in and out, ``get()`` / ``add(data,
sync=)``, and the matrix handler's row subsets (``get(row_ids)``, ``add(data,
row_ids)``). Counterpart of ``multiverso_tpu/bindings/table_handlers.py``.

Each handler sits on a table of the runtime mesh (``_table``). The matrix
handler's row subsets are :meth:`MatrixTable.get_rows` /
:meth:`MatrixTable.add_rows`, and so the row gather and the row
scatter-add kernels, once per card over the table's shards
(``gather_rows_sharded``, ``row_scatter_add_sharded``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from multiverso_tpu_torch import core
from multiverso_tpu_torch.tables import ArrayTable, MatrixTable
from multiverso_tpu_torch.updaters import AddOption


class TableHandler:
    """The reference's abstract TableHandler."""

    def get(self):
        raise NotImplementedError

    def add(self, data, sync: bool = False):
        raise NotImplementedError


class ArrayTableHandler(TableHandler):
    def __init__(self, size: int, init_value: Any = None,
                 dtype: Any = "float32", updater: str = "default",
                 name: str = "array_handler") -> None:
        core.refuse_model_split(core.mesh(), "the binding table handlers")
        self._table = ArrayTable(
            size, dtype, init_value=0 if init_value is None else init_value,
            updater=updater, name=name)

    @property
    def size(self) -> int:
        return self._table.size

    def get(self) -> np.ndarray:
        return self._table.get()

    def add(self, data, sync: bool = False,
            option: Optional[AddOption] = None) -> None:
        self._table.add(np.asarray(data, dtype=self._table.np_dtype),
                        option=option, sync=sync)


class MatrixTableHandler(TableHandler):
    def __init__(self, num_rows: int, num_cols: int, init_value: Any = None,
                 dtype: Any = "float32", updater: str = "default",
                 name: str = "matrix_handler") -> None:
        core.refuse_model_split(core.mesh(), "the binding table handlers")
        self._table = MatrixTable(
            num_rows, num_cols, dtype,
            init_value=0 if init_value is None else init_value,
            updater=updater, name=name)

    @property
    def num_rows(self) -> int:
        return self._table.num_rows

    @property
    def num_cols(self) -> int:
        return self._table.num_cols

    def get(self, row_ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """The whole matrix, or the rows ``row_ids`` (the reference's
        ``GetMatrixTableAll`` / ``GetMatrixTableByRows``)."""
        if row_ids is None:
            return self._table.get()
        return self._table.get_rows(row_ids)

    def add(self, data, row_ids: Optional[Sequence[int]] = None,
            sync: bool = False, option: Optional[AddOption] = None) -> None:
        data = np.asarray(data, dtype=self._table.np_dtype)
        if row_ids is None:
            self._table.add(data, option=option, sync=sync)
        else:
            self._table.add_rows(row_ids, data, option=option, sync=sync)
