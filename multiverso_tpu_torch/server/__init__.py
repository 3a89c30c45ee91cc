"""Parameter-server processes: the wire server (counterpart of
``multiverso_tpu/server``).

A :class:`~multiverso_tpu_torch.server.table_server.TableServer` owns
tables on one device (``cuda:0`` unless the caller names another) and
answers the MVW1 frame protocol of
:mod:`multiverso_tpu_torch.server.wire` over unix-domain sockets, TCP or
shared-memory rings. Worker processes talk to it through
:mod:`multiverso_tpu_torch.client.transport` (or the reference's, the
frames being the same bytes). Standalone::

    python -m multiverso_tpu_torch.server --address unix:/tmp/mvtpu.sock \\
        --device cuda:0

``--fleet N`` launches a sharded fleet of such servers (replication,
failover and live resharding in :mod:`.replication` and
:mod:`.table_server`), each member serving statusz.

``TableServer`` is imported lazily (PEP 562): :mod:`.wire` must stay
importable by torch-free worker processes, and pulling the table layer
in at package import would drag torch along.
"""

from multiverso_tpu_torch.server import wire  # noqa: F401  (torch-free codec)

__all__ = ["TableServer", "wire"]


def __getattr__(name):
    if name == "TableServer":
        from multiverso_tpu_torch.server.table_server import TableServer
        return TableServer
    raise AttributeError(name)
