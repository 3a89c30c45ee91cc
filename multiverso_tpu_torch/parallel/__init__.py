"""Parallel layers of the port (counterpart of ``multiverso_tpu/parallel``).

- :mod:`~multiverso_tpu_torch.parallel.multihost`: the host-side
  collectives over ``torch.distributed`` that the multi-process runtime
  (``core.init`` over several processes, the superstep's data-axis
  exchange, ``shard_update`` across processes), the per-process data-shard
  modes (word2vec ``local_data``, LightLDA ``local_corpus``) and
  :func:`~multiverso_tpu_torch.telemetry.aggregate.gather_metrics` use.
- :func:`ring_attention` / :func:`ulysses_attention`: sequence-parallel
  attention over the devices of a mesh axis.
- :mod:`~multiverso_tpu_torch.parallel.pipeline`: the GPipe microbatch
  schedule (``pipeline_apply``).
"""

from multiverso_tpu_torch.parallel.multihost import (allgather_bytes,
                                                     allgather_i64,
                                                     allgather_tensors,
                                                     owned_axis_slices,
                                                     process_count,
                                                     process_index,
                                                     validate_single_owner)
from multiverso_tpu_torch.parallel.ring_attention import (ring_attention,
                                                          ulysses_attention)

__all__ = ["allgather_bytes", "allgather_i64", "allgather_tensors",
           "owned_axis_slices", "process_count", "process_index",
           "ring_attention", "ulysses_attention", "validate_single_owner"]
