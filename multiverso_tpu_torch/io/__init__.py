"""URI-dispatched IO streams (counterpart of ``multiverso_tpu/io``). The
wire server's socket plumbing (``wiresock``) and shared-memory rings
(``shmring``) live here too; like the reference's, they import nothing
of the package, so worker processes load them by file path."""

from multiverso_tpu_torch.io.stream import (Stream, StreamFactory,
                                            mem_store_clear, open_stream,
                                            pread, register_scheme)

__all__ = ["Stream", "StreamFactory", "mem_store_clear", "open_stream",
           "pread", "register_scheme"]
