"""ArrayTable: 1-D dense table with whole-array Get/Add (the reference's
``ArrayWorker<T>::Get/Add``); counterpart of
``multiverso_tpu/tables/array_table.py``."""

from __future__ import annotations

from typing import Any, Optional

from multiverso_tpu_torch import core
from multiverso_tpu_torch.tables.base import Table
from multiverso_tpu_torch.updaters import AddOption


class ArrayTable(Table):
    def __init__(self, size: int, dtype: Any = "float32", *,
                 init_value: Any = 0, updater: Optional[str] = None,
                 device: core.DeviceLike = None, name: str = "array_table",
                 default_option: Optional[AddOption] = None) -> None:
        if size <= 0:
            raise ValueError(f"ArrayTable size must be positive, got {size}")
        super().__init__(name, (size,), dtype, updater=updater,
                         device=device, init_value=init_value,
                         default_option=default_option)

    @property
    def size(self) -> int:
        return self.logical_shape[0]
