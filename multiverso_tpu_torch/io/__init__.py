"""URI-dispatched IO streams (counterpart of ``multiverso_tpu/io``; the
shared-memory ring and wire sockets come with the server, ROADMAP.md
queue A item 11)."""

from multiverso_tpu_torch.io.stream import (Stream, StreamFactory,
                                            mem_store_clear, open_stream,
                                            pread, register_scheme)

__all__ = ["Stream", "StreamFactory", "mem_store_clear", "open_stream",
           "pread", "register_scheme"]
