"""The binding-compat Python API (counterpart of
``multiverso_tpu/bindings``): the reference's Python binding surface
(upstream ``binding/python/multiverso/{api.py,tables.py}``), so a training
script written against it ports with an import swap::

    import multiverso_tpu_torch.bindings as multiverso
    multiverso.init(sync=True)
    tbl = multiverso.ArrayTableHandler(1000, init_value=0.0)
    tbl.add(delta); vals = tbl.get()
    multiverso.barrier()
    multiverso.shutdown()

The handlers sit directly on the port's tables. The delta-sync wrapper of
the reference's framework extensions (``mv_shared``, ``ParamManager``) is
:mod:`multiverso_tpu_torch.bindings.torch_ext`.
"""

from multiverso_tpu_torch.bindings.api import (barrier, init,
                                               is_master_worker, server_id,
                                               shutdown, workers_num,
                                               worker_id)
from multiverso_tpu_torch.bindings.table_handlers import (ArrayTableHandler,
                                                          MatrixTableHandler)
from multiverso_tpu_torch.bindings import torch_ext

__all__ = ["ArrayTableHandler", "MatrixTableHandler", "barrier", "init",
           "is_master_worker", "server_id", "shutdown", "torch_ext",
           "worker_id", "workers_num"]
