"""ArrayTable: 1-D dense table with whole-array Get/Add (the reference's
``ArrayWorker<T>::Get/Add``); counterpart of
``multiverso_tpu/tables/array_table.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from multiverso_tpu_torch import core
from multiverso_tpu_torch.tables.base import Table
from multiverso_tpu_torch.updaters import AddOption


@dataclasses.dataclass
class ArrayTableOption:
    """``ArrayTableOption<T>`` analog for the create_table factory."""
    size: int
    dtype: Any = "float32"
    init_value: Any = 0
    updater: Optional[str] = None
    name: str = "array_table"
    shard_update: bool = False   # data-axis weight-update sharding


class ArrayTable(Table):
    def __init__(self, size: int, dtype: Any = "float32", *,
                 init_value: Any = 0, updater: Optional[str] = None,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None, name: str = "array_table",
                 default_option: Optional[AddOption] = None,
                 shard_update: bool = False) -> None:
        if size <= 0:
            raise ValueError(f"ArrayTable size must be positive, got {size}")
        super().__init__(name, (size,), dtype, updater=updater,
                         device=device, mesh=mesh, init_value=init_value,
                         default_option=default_option,
                         shard_update=shard_update)

    @property
    def size(self) -> int:
        return self.logical_shape[0]
