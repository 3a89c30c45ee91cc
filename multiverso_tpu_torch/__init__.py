"""multiverso_tpu_torch — the parameter server of ``multiverso_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The same Table API and Get/Add contract, the six updaters, the fused
superstep and the apps, on a (data, model) mesh of ``torch.device``s
whose model axis splits tables into shards. Entry points run on the CUDA
devices unless the caller names others (the tests pass ``"cpu"``, where
every kernel runs its plain PyTorch version). ``client`` (the coalescing
buffer, the cached view, the KV staging writer, and the wire transport
loaded on demand) and ``control`` (the knob table and the autotuning
controller) come with the package; ``server`` (the wire server) is
imported on demand.
"""

from multiverso_tpu_torch.version import __version__
from multiverso_tpu_torch import client, control
from multiverso_tpu_torch.core import (Mesh, barrier, data_axis_size, device,
                                       generator, init, is_initialized, mesh,
                                       model_axis_size, num_servers,
                                       num_workers, place, rank, server_id,
                                       set_mesh, shutdown, size, worker_id)

__all__ = ["Mesh", "__version__", "barrier", "client", "control",
           "data_axis_size", "device", "generator", "init", "is_initialized",
           "mesh", "model_axis_size", "num_servers", "num_workers", "place",
           "rank", "server_id", "set_mesh", "shutdown", "size", "worker_id"]
