"""Multi-process helpers of the port (counterpart of
``multiverso_tpu/parallel``).

Ported: :mod:`~multiverso_tpu_torch.parallel.multihost`, the host-side
collectives over ``torch.distributed`` that the multi-process runtime
(``core.init`` over several processes, the superstep's data-axis
exchange, ``shard_update`` across processes), the per-process data-shard
modes (word2vec ``local_data``, LightLDA ``local_corpus``) and
:func:`~multiverso_tpu_torch.telemetry.aggregate.gather_metrics` use.
``pipeline`` and ``ring_attention`` / ``ulysses_attention`` (the
reference's pipeline and sequence-parallel layers) are not ported yet
(ROADMAP.md queue A item 12).
"""

from multiverso_tpu_torch.parallel.multihost import (allgather_bytes,
                                                     allgather_i64,
                                                     allgather_tensors,
                                                     owned_axis_slices,
                                                     process_count,
                                                     process_index,
                                                     validate_single_owner)

__all__ = ["allgather_bytes", "allgather_i64", "allgather_tensors",
           "owned_axis_slices", "process_count", "process_index",
           "validate_single_owner"]
