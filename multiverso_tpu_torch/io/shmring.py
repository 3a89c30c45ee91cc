"""Shared-memory ring transport: same-host MVW1 frames without the
socket data path.

Counterpart of ``multiverso_tpu/io/shmring.py``, copied unchanged.

The parameter-server wire normally moves frames through a stream
socket — every frame pays two kernel copies (send + recv) plus the
protocol stack. On the SAME host that is pure overhead: this module
carries the identical encoded frames through a pair of mmap'd
single-producer/single-consumer byte rings (one per direction), with
a stream socket kept only as the **doorbell + liveness** channel:

- the sender copies the frame's buffers straight into the ring (no
  join copy — the gather-write analog), publishes it by advancing the
  ``head`` counter, then pokes one doorbell byte at the socket
  (``MSG_DONTWAIT`` — a full doorbell buffer already guarantees a
  pending wakeup, so the sender never blocks on it);
- the receiver spins briefly on the ring (latency fast path), then
  parks in a blocking ``recv`` on the doorbell socket. Publish happens
  strictly BEFORE the doorbell, so the ring-then-recv order can never
  miss a wakeup. Socket EOF is peer death — a SIGKILLed worker is
  detected exactly like on the socket transport;
- frames are length-prefixed records inside the ring; a record never
  wraps (a ``wrap`` marker parks the remainder of the ring), and a
  record is only visible once ``head`` covers all of it — a torn
  (partially published) record therefore reads as "not ready" until
  the socket EOF converts it into a dead peer.

Ring file layout (little-endian, created by the CLIENT next to the
server's listen socket, unlinked once both sides have it mapped)::

    | magic "MVSHMR1\\0" | u64 capacity |   ← offset 0
    | u64 head  (producer-owned)        |   ← offset 64  (own cache line)
    | u64 tail  (consumer-owned)        |   ← offset 128 (own cache line)
    | data area (capacity bytes)        |   ← offset 192
    record := u32 kind (1=frame, 2=wrap) | u32 len | body | pad to 8

``head``/``tail`` are monotonic byte counters (position = counter mod
capacity). Per-direction ring size comes from ``MVTPU_SHM_RING_MB``
(default 8 MiB); a frame that cannot ever fit raises with that knob's
name.

Pure stdlib with ZERO package imports on purpose (the ``wiresock.py``
convention): torch-free worker processes file-path-load the client
transport and this module rides along. Chaos injection for the ring
lives one layer up, in :mod:`multiverso_tpu_torch.server.wire`'s channel
objects (``wire.shm.ring`` fault point).
"""

from __future__ import annotations

import mmap
import os
import socket
import struct
import tempfile
import time
from typing import List, Optional, Tuple

MAGIC = b"MVSHMR1\0"
HDR_BYTES = 192
_CAP_OFF = 8
_HEAD_OFF = 64
_TAIL_OFF = 128
_U64 = struct.Struct("<Q")
_REC = struct.Struct("<II")
REC_FRAME = 1
REC_WRAP = 2
_ALIGN = 8

RING_ENV = "MVTPU_SHM_RING_MB"
#: prefix of the (short-lived) ring files a client creates next to the
#: server's listen socket; the server refuses to map anything else
FILE_PREFIX = ".mvshmring-"


def ring_bytes() -> int:
    """Per-direction ring data size (``MVTPU_SHM_RING_MB``, default
    8 MiB, floor 64 KiB)."""
    try:
        mb = float(os.environ.get(RING_ENV, "") or 8)
    except ValueError:
        mb = 8.0
    return max(int(mb * (1 << 20)), 1 << 16)


def _init_ring_file(path: str, cap: int) -> None:
    with open(path, "r+b") as f:
        f.truncate(HDR_BYTES + cap)
        f.write(MAGIC)
        f.write(_U64.pack(cap))


def create_ring_pair(listen_path: str,
                     cap: Optional[int] = None) -> Tuple[str, str, int]:
    """Client half of the handshake: create + zero-init the two ring
    files (c2s, s2c) in the listen socket's directory. Returns
    ``(c2s_path, s2c_path, cap)``; the caller unlinks both once the
    server has mapped them (the mmaps keep the memory alive)."""
    cap = int(cap) if cap else ring_bytes()
    d = os.path.dirname(os.path.abspath(listen_path)) or "."
    paths = []
    try:
        for tag in ("c2s", "s2c"):
            fd, path = tempfile.mkstemp(
                prefix=f"{FILE_PREFIX}{tag}-", dir=d)
            os.close(fd)
            paths.append(path)
            _init_ring_file(path, cap)
    except BaseException:
        unlink_quiet(*paths)
        raise
    return paths[0], paths[1], cap


def unlink_quiet(*paths: str) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def _map_ring(path: str) -> Tuple[mmap.mmap, int]:
    with open(path, "r+b") as f:
        head = f.read(16)
        if len(head) < 16 or head[:8] != MAGIC:
            raise ValueError(f"shm ring {path!r}: bad magic")
        cap = _U64.unpack_from(head, _CAP_OFF)[0]
        size = os.fstat(f.fileno()).st_size
        if cap <= 0 or HDR_BYTES + cap != size:
            raise ValueError(f"shm ring {path!r}: implausible capacity "
                             f"{cap} for file size {size}")
        mm = mmap.mmap(f.fileno(), HDR_BYTES + cap)
    return mm, int(cap)


class _Ring:
    """One direction of the transport mapped into this process."""

    def __init__(self, path: str) -> None:
        self.mm, self.cap = _map_ring(path)

    def _load(self, off: int) -> int:
        return _U64.unpack_from(self.mm, off)[0]

    def _store(self, off: int, value: int) -> None:
        _U64.pack_into(self.mm, off, value)

    def close(self) -> None:
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass


class RingWriter(_Ring):
    """Producer side. Single producer by construction (one writer
    thread per connection per direction)."""

    def write(self, bufs: List, nbytes: int, timeout_s: float,
              publish_fraction: float = 1.0) -> None:
        """Copy ``bufs`` (an :func:`encode_frame` buffer list totalling
        ``nbytes`` bytes) into the ring as ONE record and publish it.
        Blocks (polling ``tail``) while the ring is full; raises
        ``TimeoutError`` past ``timeout_s`` — a consumer that stopped
        draining is indistinguishable from a dead one.

        ``publish_fraction < 1`` is the chaos ``torn`` hook: the record
        header and a prefix of the body land, but ``head`` only
        advances part-way — the consumer sees a forever-incomplete
        record, exactly like a producer that died mid-copy."""
        rec = _REC.size + nbytes
        need = rec + ((-rec) % _ALIGN)
        if need + _REC.size + _ALIGN > self.cap:
            raise ValueError(
                f"shm ring: frame of {nbytes} bytes cannot fit a "
                f"{self.cap}-byte ring; raise {RING_ENV}")
        deadline = time.monotonic() + max(timeout_s, 0.001)
        sleep = 20e-6
        while True:
            head = self._load(_HEAD_OFF)
            pos = head % self.cap
            room = self.cap - pos
            wrap = room if room < need else 0
            free = self.cap - (head - self._load(_TAIL_OFF))
            if free >= need + wrap:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shm ring full for {timeout_s:.1f}s "
                    "(consumer stopped draining)")
            time.sleep(sleep)
            sleep = min(sleep * 2, 1e-3)
        if wrap:
            _REC.pack_into(self.mm, HDR_BYTES + pos, REC_WRAP, 0)
            head += room
            pos = 0
        off = HDR_BYTES + pos + _REC.size
        for b in bufs:
            mv = memoryview(b).cast("B")
            self.mm[off:off + len(mv)] = mv
            off += len(mv)
        _REC.pack_into(self.mm, HDR_BYTES + pos, REC_FRAME, nbytes)
        if publish_fraction >= 1.0:
            self._store(_HEAD_OFF, head + need)
        else:
            part = max(int(need * publish_fraction) // _ALIGN, 1) \
                * _ALIGN
            self._store(_HEAD_OFF, head + min(part, need - _ALIGN))


class RingReader(_Ring):
    """Consumer side (single consumer per direction)."""

    def try_read(self) -> Optional[bytearray]:
        """One published record's body (copied out — the ring slot is
        recycled the moment ``tail`` advances, so callers get memory
        they own), or ``None`` when nothing is fully published."""
        while True:
            head = self._load(_HEAD_OFF)
            tail = self._load(_TAIL_OFF)
            avail = head - tail
            if avail < _REC.size:
                return None
            pos = tail % self.cap
            kind, ln = _REC.unpack_from(self.mm, HDR_BYTES + pos)
            if kind == REC_WRAP:
                self._store(_TAIL_OFF, tail + (self.cap - pos))
                continue
            if kind != REC_FRAME or ln > self.cap:
                raise ConnectionError(
                    f"shm ring corrupt (kind={kind} len={ln})")
            rec = _REC.size + ln
            rec += (-rec) % _ALIGN
            if avail < rec:
                return None     # mid-publish (or torn) — not ready
            start = HDR_BYTES + pos + _REC.size
            out = bytearray(self.mm[start:start + ln])
            self._store(_TAIL_OFF, tail + rec)
            return out


class ShmEndpoint:
    """One connection's view of the transport: tx ring + rx ring +
    the doorbell/liveness socket."""

    #: how long recv polls the ring before parking in the doorbell
    #: recv — covers the common reply-already-in-flight case without a
    #: blocking syscall. Zero on a single-CPU host: every microsecond
    #: spent polling there is stolen from the peer that would publish
    #: the record (and ``sched_yield`` is not a reliable handoff under
    #: CFS), so parking immediately is strictly faster.
    SPIN_S = 50e-6 if (os.cpu_count() or 1) > 1 else 0.0

    def __init__(self, sock: socket.socket, tx: RingWriter,
                 rx: RingReader) -> None:
        self.sock = sock
        self.tx = tx
        self.rx = rx
        self._closed = False

    def send_bytes(self, bufs: List, nbytes: int,
                   timeout_s: float) -> None:
        self.tx.write(bufs, nbytes, timeout_s)
        self._doorbell()

    def send_torn(self, bufs: List, nbytes: int) -> None:
        """Chaos ``torn`` half-write: publish a partial record then
        stop — the peer sees a never-completing record and, once the
        socket closes, a dead producer."""
        self.tx.write(bufs, nbytes, timeout_s=0.05,
                      publish_fraction=0.5)
        self._doorbell()

    def _doorbell(self) -> None:
        try:
            self.sock.send(b"\x01", socket.MSG_DONTWAIT)
        except (BlockingIOError, InterruptedError):
            pass        # doorbell buffer full == wakeup already pending
        except OSError as exc:
            raise ConnectionError(
                f"shm: doorbell socket failed: {exc}") from exc

    def recv_bytes(self) -> bytearray:
        """Block until one record arrives. Raises ``ConnectionError``
        on peer death (socket EOF / reset), ``socket.timeout`` if the
        doorbell socket carries an IO timeout (client side)."""
        spin_until = time.monotonic() + self.SPIN_S
        while True:
            out = self.rx.try_read()
            if out is not None:
                return out
            if time.monotonic() < spin_until:
                continue
            try:
                data = self.sock.recv(4096)
            except socket.timeout:
                raise
            except OSError as exc:
                raise ConnectionError(
                    f"shm: doorbell socket died: {exc}") from exc
            if not data:
                raise ConnectionError("shm: peer closed")
            spin_until = time.monotonic() + self.SPIN_S

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.tx.close()
        self.rx.close()


def open_endpoint(sock: socket.socket, *, tx_path: str, rx_path: str,
                  expect_dir: Optional[str] = None) -> ShmEndpoint:
    """Map the two ring files into an endpoint. ``expect_dir`` (server
    side) pins where offered paths may live — the listen socket's
    directory, with the :data:`FILE_PREFIX` naming — so a client
    cannot make the server map arbitrary files."""
    if expect_dir is not None:
        want = os.path.realpath(expect_dir)
        for p in (tx_path, rx_path):
            if os.path.realpath(os.path.dirname(p)) != want \
                    or not os.path.basename(p).startswith(FILE_PREFIX):
                raise ValueError(f"shm ring path {p!r} not under the "
                                 f"listen directory {want!r}")
    tx = RingWriter(tx_path)
    try:
        rx = RingReader(rx_path)
    except BaseException:
        tx.close()
        raise
    return ShmEndpoint(sock, tx, rx)
