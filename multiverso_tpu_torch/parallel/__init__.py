"""Multi-process helpers of the port (counterpart of
``multiverso_tpu/parallel``).

Ported: :mod:`~multiverso_tpu_torch.parallel.multihost`, the host-side
collectives over ``torch.distributed`` that the per-process data-shard
modes and :func:`~multiverso_tpu_torch.telemetry.aggregate.gather_metrics`
use. ``ring_attention`` / ``ulysses_attention`` (the reference's
sequence-parallel layer) are not ported yet (ROADMAP.md queue A item 12).
"""

from multiverso_tpu_torch.parallel.multihost import (allgather_bytes,
                                                     allgather_i64,
                                                     validate_single_owner)

__all__ = ["allgather_bytes", "allgather_i64", "validate_single_owner"]
