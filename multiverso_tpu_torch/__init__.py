"""multiverso_tpu_torch — the parameter server of ``multiverso_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The same Table API and Get/Add contract, the six updaters, the fused
superstep and word2vec, on one ``torch.device``. Entry points run on
``cuda:0`` unless the caller names another device (the tests pass
``"cpu"``, where every kernel runs its plain PyTorch version).
"""

from multiverso_tpu_torch.version import __version__
from multiverso_tpu_torch.core import (barrier, device, generator, init,
                                       is_initialized, num_servers,
                                       num_workers, place, rank, shutdown,
                                       size)

__all__ = ["__version__", "barrier", "device", "generator", "init",
           "is_initialized", "num_servers", "num_workers", "place", "rank",
           "shutdown", "size"]
