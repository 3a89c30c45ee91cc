"""The reference's ``multiverso/api.py`` surface: init / shutdown /
barrier and the topology queries, names kept (counterpart of
``multiverso_tpu/bindings/api.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

from multiverso_tpu_torch import core
from multiverso_tpu_torch.utils import configure


def init(sync: bool = True, argv: Optional[Sequence[str]] = None) -> None:
    """``multiverso.init(sync=...)``: record ``sync`` in the ``sync`` flag
    (synchronous data parallelism is the native mode; ``sync=False`` is
    accepted for script compatibility), then :func:`core.init` with
    ``argv``. A mesh the caller already built stays; with none, init
    takes the CUDA devices (``-device`` flags of the examples, or
    ``core.init(device="cpu")`` first, name the CPU)."""
    configure.set_flag("sync", bool(sync))
    core.init(argv)


def shutdown() -> None:
    core.shutdown()


def barrier() -> None:
    core.barrier()


def workers_num() -> int:
    return core.num_workers()


def worker_id() -> int:
    return core.worker_id()


def server_id() -> int:
    return core.server_id()


def is_master_worker() -> bool:
    """Exactly one worker is the master (it splits data and logs):
    process 0 of the job."""
    return core.rank() == 0
