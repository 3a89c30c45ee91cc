"""Wire sockets: address scheme + raw socket plumbing for the
parameter-server transport.

Counterpart of ``multiverso_tpu/io/wiresock.py``, copied unchanged.

The reference framework's processes talk MPI or ZeroMQ; this port's
wire (`server/table_server.py` serving, `client/transport.py` dialing)
speaks length-prefixed frames (`server/wire.py`) over plain sockets.
This module is the socket half: one address grammar, listeners,
dialers, and exact-length reads. Pure stdlib with ZERO package imports
on purpose — worker processes file-path-load the client transport
without importing the package (and so without importing torch), and this
module rides along.

Address grammar (one string, both ends agree):

- ``unix:/path/to.sock`` — unix-domain socket (the default transport
  for same-host worker fleets: no port allocation, filesystem perms),
- ``tcp:host:port``      — TCP (cross-host),
- ``shm:///path/to.sock`` (or ``shm:/path``) — shared-memory ring
  transport (`io/shmring.py`): a unix socket at the path carries the
  handshake + doorbell, the frames travel through mmap'd rings. At the
  socket layer shm IS a unix listener — a plain-socket client may dial
  the same path and both sides fall back to socket frames gracefully,
- a bare path containing ``/`` is taken as unix, a bare ``host:port``
  as tcp.
"""

from __future__ import annotations

import os
import socket
from typing import Tuple, Union

Address = Union[Tuple[str, str], Tuple[str, str, int]]

#: maximum sane frame size (1 GiB): a corrupted / non-protocol peer
#: must not make the receiver allocate arbitrary memory
MAX_FRAME_BYTES = 1 << 30


def parse_address(addr: str) -> Address:
    """``unix:/path`` / ``tcp:host:port`` / bare forms → typed tuple."""
    if not addr:
        raise ValueError("empty wire address")
    if addr.startswith("unix:"):
        path = addr[5:]
        if not path:
            raise ValueError(f"wire address {addr!r}: empty unix path")
        return ("unix", path)
    if addr.startswith("shm:"):
        path = addr[4:]
        if path.startswith("//"):       # URI form shm:///abs/path
            path = path[2:]
        if not path:
            raise ValueError(f"wire address {addr!r}: empty shm path")
        return ("shm", path)
    if addr.startswith("tcp:"):
        rest = addr[4:]
        host, sep, port = rest.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"wire address {addr!r}: expected tcp:host:port")
        return ("tcp", host, int(port))
    if "/" in addr or os.sep in addr:
        return ("unix", addr)
    host, sep, port = addr.rpartition(":")
    if sep and host:
        return ("tcp", host, int(port))
    raise ValueError(f"wire address {addr!r}: expected unix:/path, "
                     "tcp:host:port, a path, or host:port")


def format_address(parsed: Address) -> str:
    if parsed[0] == "unix":
        return f"unix:{parsed[1]}"
    if parsed[0] == "shm":
        return f"shm://{parsed[1]}"
    return f"tcp:{parsed[1]}:{parsed[2]}"


def listen_socket(addr: str, backlog: int = 64) -> socket.socket:
    """Bind + listen on ``addr``. For unix addresses a stale socket
    file from a dead server is unlinked first (the pidfile-less
    convention: the bind is the lock)."""
    parsed = parse_address(addr)
    if parsed[0] in ("unix", "shm"):
        path = parsed[1]
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            if os.path.exists(path):
                # probe: a live server holds the socket open
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    probe.settimeout(0.25)
                    probe.connect(path)
                except OSError:
                    os.unlink(path)     # stale — previous server died
                else:
                    probe.close()
                    raise OSError(
                        f"wire address {path!r}: a server is already "
                        "listening")
                finally:
                    probe.close()
            sock.bind(path)
        except BaseException:
            sock.close()
            raise
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((parsed[1], parsed[2]))
        except BaseException:
            sock.close()
            raise
    sock.listen(backlog)
    return sock


def bound_address(sock: socket.socket, addr: str) -> str:
    """The address clients should dial — resolves ``tcp:host:0``'s
    ephemeral port from the bound socket."""
    parsed = parse_address(addr)
    if parsed[0] in ("unix", "shm"):
        return format_address(parsed)
    host, port = sock.getsockname()[:2]
    return format_address(("tcp", parsed[1], port))


TIMEOUT_ENV = "MVTPU_WIRE_TIMEOUT_S"


def io_timeout_s() -> float:
    """Client-side socket IO timeout (``MVTPU_WIRE_TIMEOUT_S``,
    default 60): a reply that never comes surfaces as a retryable
    ``socket.timeout`` instead of a silent hang."""
    try:
        return float(os.environ.get(TIMEOUT_ENV, "") or 60.0)
    except ValueError:
        return 60.0


def connect_socket(addr: str, timeout: float = 10.0) -> socket.socket:
    """Dial ``addr``; returns a connected socket with TCP_NODELAY set
    (small Get/Add frames must not wait on Nagle) and the env IO
    timeout armed (``socket.timeout`` is an OSError — retry policies
    treat a stuck reply like any transport fault)."""
    parsed = parse_address(addr)
    if parsed[0] in ("unix", "shm"):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        target = parsed[1]
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        target = (parsed[1], parsed[2])
    try:
        sock.settimeout(timeout)
        sock.connect(target)
        sock.settimeout(io_timeout_s())
        if parsed[0] == "tcp":
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except BaseException:
        sock.close()
        raise
    return sock


def recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` completely from the socket; raises
    ``ConnectionError`` on EOF mid-read (a torn frame / dead peer)."""
    got = 0
    total = len(view)
    while got < total:
        n = sock.recv_into(view[got:], total - got)
        if n == 0:
            raise ConnectionError(
                f"wire: peer closed mid-frame ({got}/{total} bytes)")
        got += n


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    recv_exact_into(sock, memoryview(buf))
    return buf


def send_buffers(sock: socket.socket, buffers) -> int:
    """Gather-write a buffer list (``sendmsg``: the frame's header and
    each numpy payload go to the kernel WITHOUT being joined into one
    intermediate copy). Handles partial sends. Returns bytes sent."""
    bufs = [memoryview(b).cast("B") for b in buffers if len(b)]
    total = sum(len(b) for b in bufs)
    sent_total = 0
    while bufs:
        sent = sock.sendmsg(bufs)
        sent_total += sent
        if sent_total >= total:
            break
        # drop fully-sent buffers, slice the partially-sent one
        while sent > 0 and bufs:
            if sent >= len(bufs[0]):
                sent -= len(bufs[0])
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][sent:]
                sent = 0
    return sent_total
